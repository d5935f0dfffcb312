"""The system under test, built for a cell: the port's sampler with the
keywords the traffic names, over data and particles the benchmark draws
from the seed. A model kind (kinds/<kind>.py) draws its data and model;
this module wires them to ``stein_tpu_torch.SVGDSampler``."""

import dataclasses
import importlib

import torch


@dataclasses.dataclass
class Problem:
    sampler: object       # stein_tpu_torch.SVGDSampler
    batch: dict           # what run() is fed
    data: dict            # the raw data the reference works from
    theta0: torch.Tensor  # [n, p], every particle
    keywords: dict        # the sampler's keywords, as the cell set them
    kind: object          # the kinds/ module


def kind_module(config):
    return importlib.import_module(f"svgd_bench.kinds.{config['kind']}")


def generator(seed, device):
    """The run's one random stream: every input is drawn from it, in one
    fixed order, on the card."""
    return torch.Generator(device).manual_seed(int(seed) % 2 ** 63)


def build(cell, seed, device, mesh=None):
    """The cell's sampler over data drawn from ``seed`` on ``device``
    (on a mesh every rank draws the same numbers and keeps its block)."""
    from stein_tpu_torch import Adam, SVGDSampler, throughput_config

    kind = kind_module(cell.config)
    cfg, traffic = cell.config, cell.traffic
    n = int(traffic["n"])
    gen = generator(seed, device)
    model, batch, data, p = kind.make(cfg, gen, device)
    theta0 = float(cfg["init_scale"]) * torch.randn(
        n, p, generator=gen, device=device)
    if traffic["pick"] == "throughput_config":
        kw = throughput_config(
            n, p, mesh=mesh,
            model=model if cfg.get("pick_with_model") else None)
    elif traffic["pick"] == "keywords":
        kw = {} if mesh is None else {"mesh": mesh}
    else:
        raise ValueError(f"unknown pick {traffic['pick']!r}")
    kw.update(traffic.get("keywords", {}))
    for hook in cfg.get("hooks", []):
        kw[hook] = getattr(model, hook)
    opt = cfg["optimizer"]
    if opt["rule"] != "adam":
        raise ValueError(f"no step rule {opt['rule']!r}")
    sampler = SVGDSampler(
        n_particles=n, log_p=model.log_p, param_template=model.template(),
        gd=Adam(learning_rate=opt["learning_rate"],
                decay=opt.get("decay", 1.0)),
        theta=theta0, device=device, **kw)
    return Problem(sampler, batch, data, theta0, kw, kind)
