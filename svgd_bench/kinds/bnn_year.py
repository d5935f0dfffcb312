"""The SVGD paper's Bayesian neural network on UCI Year (Liu & Wang,
NeurIPS 2016, section 5.3, after PBP's protocol): data, model and gradient
operations.

The model is ``stein_tpu_torch.models.BayesianNNModel`` at the paper's
widths: 90 features, 100 hidden ReLU units, one output (p = 9,203),
Gamma(1, 0.1) priors on both precisions, and the likelihood of a 100-row
minibatch rescaled by n_train / n_batch = 463,715 / 100. The Year data
are not in the repository and the cell needs only their shape, so the
minibatch is drawn from the run's stream: X [100, 90] ~ N(0, 1)
(standardised inputs), y from a 90-100-1 ReLU teacher drawn from the same
stream plus noise, standardised."""

import math

import torch

from svgd_bench.reference import bnn as ref


def _model_kw(cfg):
    m, d = cfg["model"], cfg["data"]
    return dict(n_feats=int(m["n_feats"]), n_hidden=int(m["n_hidden"]),
                n_train=int(d["n_train"]), n_batch=int(d["n_batch"]),
                prior_alpha=float(m["prior_alpha"]),
                prior_beta=float(m["prior_beta"]))


def draw(cfg, gen, device):
    """The minibatch {"X" [B, f], "y" [B, 1]} from the run's stream."""
    kw = _model_kw(cfg)
    f, H, B = kw["n_feats"], kw["n_hidden"], kw["n_batch"]
    X = torch.randn(B, f, generator=gen, device=device)
    w1 = torch.randn(f, H, generator=gen, device=device) / math.sqrt(f)
    b1 = torch.randn(H, generator=gen, device=device)
    w2 = torch.randn(H, 1, generator=gen, device=device) / math.sqrt(H)
    noise = torch.randn(B, 1, generator=gen, device=device)
    y = (torch.relu(X @ w1 + b1) @ w2
         + float(cfg["data"]["noise"]) * noise)
    y = (y - y.mean()) / y.std()
    return {"X": X, "y": y}


def make(cfg, gen, device):
    """(model, batch fed to run, raw data, p)."""
    from stein_tpu_torch.models import BayesianNNModel

    kw = _model_kw(cfg)
    batch = draw(cfg, gen, device)
    f, H = kw["n_feats"], kw["n_hidden"]
    return BayesianNNModel(**kw), batch, dict(batch), f * H + 2 * H + 3


def reference(cfg, data):
    """The plain gradient on ``data`` (already in the reference's dtype)."""
    return ref.grad_fn(data, **_model_kw(cfg))


def grad_ops(cfg, rows):
    """Operations of ``rows`` particles' log p and gradients on the
    minibatch: a forward (2 f H + 4 H an observation) and a backward of
    twice that."""
    kw = _model_kw(cfg)
    f, H, B = kw["n_feats"], kw["n_hidden"], kw["n_batch"]
    return rows * B * 3 * (2 * f * H + 4 * H)
