"""Hierarchical Bayesian logistic regression.

PyTorch counterpart of ``stein_tpu/models/logistic_regression.py``: the
reference example's model (examples/logistic_regression/main.py:23-49), a
Gamma(1, 0.01) prior on the precision alpha = exp(log_alpha), evaluated at
alpha with no Jacobian correction as the reference does, an N(0, alpha^-1/2)
prior on the weights and the sigmoid cross-entropy likelihood rescaled by
n_train/n_batch. The JAX model's ``precision=`` field is kept and checked
and changes nothing: ``log_p``'s logits ``X @ w`` go through
``ops/data_product.matvec`` (one folded launch for every particle under
``vmap(grad_and_value)``, a fixed reduction order, IEEE f32).

``inkernel_model(batch)`` packages the model for step_impl='fused_model':
its gradients and log_p values come from the fused step's logistic stage
(``ops/model_grad.py``, kernel ``csrc/model_grad.cu`` on a card).
"""

import dataclasses
import functools
import math

import torch

from ..ops.data_product import matvec
from ..ops.fused_step import InKernelModel
from ..ops.model_grad import LogisticGrad
from ..utils.ravel import template_unraveler
from .distributions import (
    check_precision,
    gamma_log_prob,
    normal_log_prob,
    sigmoid_cross_entropy_with_logits,
)


@dataclasses.dataclass(frozen=True)
class LogisticRegressionModel:
    n_feats: int
    n_train: int
    n_batch: int
    precision: str = "high"

    def __post_init__(self):
        check_precision(self.precision)

    def template(self, dtype=torch.float32):
        return {
            "w": torch.zeros(self.n_feats, 1, dtype=dtype),
            "log_alpha": torch.zeros((), dtype=dtype),
        }

    def logits(self, params, batch):
        return torch.matmul(batch["X"], params["w"])

    def _ravel_layout(self):
        """(log_alpha's column, the weights' columns, p) of the raveled
        [n, p] particle matrix, read off the sampler's own unraveler: the
        column indices 0..p-1 unraveled land on the leaves they fill (sorted
        keys put log_alpha in column 0, w in columns 1..d)."""
        p, unravel = template_unraveler(self.template(torch.float64))
        cols = unravel(torch.arange(p, dtype=torch.float64))
        return (int(cols["log_alpha"]), cols["w"].reshape(-1).long(), p)

    def inkernel_model(self, batch):
        """The model for step_impl='fused_model' (ops/fused_step.
        InKernelModel): X placed into the weights' columns of X_pad (the
        log_alpha column zero, so theta @ X_pad^T is X w per particle), y as
        a row, the two column masks, and the parameter-independent log_p
        terms as ``const``:

            sampler = SVGDSampler(..., step_impl='fused_model',
                                  inkernel_model=model.inkernel_model)
        """
        f32 = torch.float32
        X = batch["X"].to(f32)
        y_row = batch["y"].to(f32).reshape(1, -1)
        n_obs, d = X.shape[0], self.n_feats
        la_col, w_cols, p = self._ravel_layout()
        w_cols = _index_on(tuple(w_cols.tolist()), X.device)
        X_pad = torch.zeros(n_obs, p, dtype=f32, device=X.device)
        X_pad.index_copy_(1, w_cols, X)
        w_mask = torch.zeros(1, p, dtype=f32, device=X.device)
        w_mask.index_fill_(1, w_cols, 1.0)
        la_onehot = torch.zeros(1, p, dtype=f32, device=X.device)
        la_onehot[:, la_col].fill_(1.0)
        # The weight prior's -d/2 log(2 pi) and the Gamma(1, 0.01) prior's
        # 1 * log(0.01).
        const = -0.5 * d * math.log(2.0 * math.pi) + math.log(0.01)
        ops_bytes = 4 * (X_pad.numel() + y_row.numel() + 2 * p)
        return InKernelModel(
            operands=(X_pad, y_row, w_mask, la_onehot),
            grad_fn=LogisticGrad(self.n_train / self.n_batch, d),
            const=const,
            # The JAX model's live-set estimate for its budget gate, kept so
            # both packages refuse the same batches.
            vmem_bytes=lambda n: (ops_bytes + 6 * 4 * n * n_obs
                                  + 2 * 4 * n * p),
        )

    def log_p(self, params, batch):
        w = params["w"]
        alpha = torch.exp(params["log_alpha"])
        logits = matvec(batch["X"], w)
        log_l = -torch.sum(
            sigmoid_cross_entropy_with_logits(batch["y"], logits))
        w_prior = torch.sum(normal_log_prob(w, 0.0, 1.0 / torch.sqrt(alpha)))
        alpha_prior = gamma_log_prob(alpha, 1.0, 0.01)
        scale = self.n_train / self.n_batch
        return log_l * scale + w_prior + alpha_prior


@functools.lru_cache(maxsize=None)
def _index_on(cols, device):
    """Column indices as an int64 tensor on ``device``, copied there once
    (a host-to-device copy, which a CUDA graph capture refuses)."""
    return torch.tensor(cols, dtype=torch.int64, device=device)
