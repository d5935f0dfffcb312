"""Bayesian linear regression: data, model and gradient operations.

X [N, p] ~ N(0, 1), w [p] ~ N(0, 1), y = X w + noise N(0, noise^2), drawn
in that order from the run's stream. ``data.form`` "sufficient" feeds the
sampler A = X^T X, b = X^T y, y^T y (the model's ``sufficient_batch``);
the reference works them out again from X and y."""

from svgd_bench.reference import linreg as ref

import torch


def make(cfg, gen, device):
    """(model, batch fed to run, raw data, p)."""
    from stein_tpu_torch.models import LinearRegressionModel

    p, d = int(cfg["model"]["n_feats"]), cfg["data"]
    N = int(d["n_obs"])
    X = torch.randn(N, p, generator=gen, device=device)
    w = torch.randn(p, 1, generator=gen, device=device)
    y = X @ w + float(d["noise"]) * torch.randn(N, 1, generator=gen,
                                                device=device)
    model = LinearRegressionModel(p)
    batch = {"X": X, "y": y}
    if d["form"] == "sufficient":
        batch = model.sufficient_batch(batch)
    return model, batch, {"X": X, "y": y}, p


def reference(cfg, data):
    """The plain gradient on ``data`` (already in the reference's dtype)."""
    return ref.grad_fn(data, cfg["data"]["form"])


def grad_ops(cfg, rows):
    """Operations of ``rows`` particles' log p and gradients: X w and
    X^T r (2 N p each) and the residuals, or w A (2 p^2) on the
    sufficient statistics."""
    p, N = int(cfg["model"]["n_feats"]), int(cfg["data"]["n_obs"])
    if cfg["data"]["form"] == "sufficient":
        return rows * (2 * p * p + 6 * p)
    return rows * (4 * N * p + 3 * N + 3 * p)
