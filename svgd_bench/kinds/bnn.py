"""Bayesian neural-network regression: data, model and gradient
operations.

The reference example's data, drawn from the run's stream: X [B, f] ~
U(0, 1), y ~ N(5 x cos(10 x), noise^2) (B = n_obs, f = 1). The model is
``stein_tpu_torch.models.BayesianNNModel`` with n_train = n_batch = B."""

from svgd_bench.reference import bnn as ref

import torch


def _model_kw(cfg):
    m = cfg["model"]
    return dict(n_feats=int(m["n_feats"]), n_hidden=int(m["n_hidden"]),
                n_train=int(cfg["data"]["n_obs"]),
                n_batch=int(cfg["data"]["n_obs"]),
                prior_alpha=float(m["prior_alpha"]),
                prior_beta=float(m["prior_beta"]))


def make(cfg, gen, device):
    """(model, batch fed to run, raw data, p)."""
    from stein_tpu_torch.models import BayesianNNModel

    kw = _model_kw(cfg)
    f, H, B = kw["n_feats"], kw["n_hidden"], kw["n_train"]
    X = torch.rand(B, f, generator=gen, device=device)
    y = (5.0 * X[:, :1] * torch.cos(10.0 * X[:, :1])
         + float(cfg["data"]["noise"]) * torch.randn(
             B, 1, generator=gen, device=device))
    model = BayesianNNModel(**kw)
    batch = {"X": X, "y": y}
    return model, batch, dict(batch), f * H + 2 * H + 3


def reference(cfg, data):
    """The plain gradient on ``data`` (already in the reference's dtype)."""
    return ref.grad_fn(data, **_model_kw(cfg))


def grad_ops(cfg, rows):
    """Operations of ``rows`` particles' log p and gradients: a forward
    (2 f H + 4 H an observation) and a backward of twice that."""
    kw = _model_kw(cfg)
    f, H, B = kw["n_feats"], kw["n_hidden"], kw["n_train"]
    return rows * B * 3 * (2 * f * H + 4 * H)
