"""Bayesian linear regression model.

PyTorch counterpart of ``stein_tpu/models/linear_regression.py``: the
reference example's model (examples/linear_regression/main.py:18-31), an
N(0,1) prior on the weights and a unit-variance Gaussian likelihood,
  log_p = -0.5 * sum((Xw - y)^2) + sum log N(w; 0, 1).
Data matmuls are f32 ``torch.matmul``s (full f32 unless the caller turns
TF32 on), the precision the JAX model's default "high" tier stands for; its
``precision=`` field is kept and checked, and changes nothing.
"""

import dataclasses
import math

import torch

from .distributions import check_precision, normal_log_prob


@dataclasses.dataclass(frozen=True)
class LinearRegressionModel:
    n_feats: int
    precision: str = "high"

    def __post_init__(self):
        check_precision(self.precision)

    def template(self, dtype=torch.float32):
        return {"w": torch.zeros(self.n_feats, 1, dtype=dtype)}

    def predict(self, params, batch):
        return torch.matmul(batch["X"], params["w"])

    def sufficient_batch(self, batch, dtype=torch.float32):
        """The Gaussian model's sufficient statistics A = X^T X,
        b = X^T y, yty = y^T y, so each step's per-particle likelihood
        costs O(p^2) instead of O(n_obs * p):
        -0.5 ||Xw - y||^2 = -0.5 (w^T A w - 2 b^T w + yty) exactly. Feed
        the returned dict to train_on_batch / run in place of {"X", "y"};
        log_p dispatches on the keys."""
        X = batch["X"].to(dtype)
        y = batch["y"].to(dtype)
        return {"A": X.T @ X, "b": X.T @ y, "yty": torch.sum(y * y)}

    def quadratic_form(self, batch):
        """The log-posterior as an explicit quadratic
        log_p(w) = -0.5 w^T A_eff w + b_eff^T w + const, gradient
        b_eff - A_eff w: the contract of step_impl='fused_glm', whose step
        computes every particle's gradient in one [n, p] x [p, p] product.
        A_eff = X^T X + I (likelihood + N(0,1) prior), b_eff = X^T y [p].
        Accepts either batch form; feed it the sufficient_batch dict so the
        statistics are not recomputed every step."""
        s = batch if "A" in batch else self.sufficient_batch(
            batch, batch["X"].dtype)
        A, b, yty = s["A"], s["b"], s["yty"]
        p = A.shape[0]
        A_eff = A + torch.eye(p, dtype=A.dtype, device=A.device)
        const = -0.5 * yty - 0.5 * p * math.log(2.0 * math.pi)
        return A_eff, b.reshape(p), const

    def log_p(self, params, batch):
        w = params["w"]
        if "A" in batch:
            Aw = torch.matmul(batch["A"], w)
            log_l = -0.5 * (
                torch.sum(w * Aw) - 2.0 * torch.sum(batch["b"] * w)
                + batch["yty"]
            )
        else:
            y_hat = torch.matmul(batch["X"], w)
            log_l = -0.5 * torch.sum(torch.square(y_hat - batch["y"]))
        log_prior = torch.sum(normal_log_prob(w, 0.0, 1.0))
        return log_l + log_prior
