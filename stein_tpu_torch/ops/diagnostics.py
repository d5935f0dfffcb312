"""Convergence diagnostics: kernel Stein discrepancy (KSD).

PyTorch counterpart of ``stein_tpu/ops/diagnostics.py``. For the RBF kernel
k = exp(-||x-y||^2 / (2 h^2)):

    u(x_i, x_j) = k_ij [ s_i . s_j
                         + (s_i - s_j) . (x_i - x_j) / h^2
                         + p / h^2 - D_ij / h^4 ]

with s_i = grad log p(x_i), and KSD^2 = mean_ij u_ij (V-statistic) or the
off-diagonal mean (U-statistic). Plain PyTorch, as the JAX package computes
it outside any Pallas kernel: f32 ``torch.matmul``s with TF32 off, the
port's mapping of the JAX package's HIGHEST precision (the cross term
cancels like D does).
"""

import torch

from . import rbf
from .median import bisect_median

# Above this particle count ksd_rbf streams row blocks instead of
# materialising the [n, n] matrices (six of them in the dense form), as in
# the JAX package.
KSD_DENSE_MAX_N = 4096


def _ksd_row_block_sum(theta_rows, grads_rows, d_rows, theta, grads, d,
                       rsq_rows, rsq, h2, p):
    """Sum of U over one [b, n] row block of the KSD kernel matrix: the
    dense form's arithmetic restricted to a row block."""
    D = (rsq_rows[:, None] + rsq[None, :]
         - 2.0 * torch.matmul(theta_rows, theta.T))
    K = torch.exp(-D / h2 / 2.0)
    SS = torch.matmul(grads_rows, grads.T)
    ST = torch.matmul(grads_rows, theta.T)   # s_i . x_j
    TS = torch.matmul(theta_rows, grads.T)   # s_j . x_i
    cross = d_rows[:, None] + d[None, :] - ST - TS
    U = K * (SS + cross / h2 + p / h2 - D / (h2 * h2))
    return torch.sum(U)


def ksd_rbf(theta, grads, h2=None, u_statistic=False, block_rows=512):
    """KSD^2 of the particle set w.r.t. the target whose scores are
    ``grads`` ([n, p] = grad log p per particle), under the RBF kernel with
    bandwidth^2 ``h2`` (the sort-free bisect median heuristic,
    ``ops.median.bisect_median``, if None). Counterpart of
    ``stein_tpu/ops/diagnostics.py:49``.

    Up to KSD_DENSE_MAX_N particles the [n, n] terms are materialised;
    beyond it the sum runs over ``block_rows``-row blocks, so peak memory
    is O(block_rows x n), with the U-statistic's diagonal in closed form.
    Returns a 0-d tensor on the particles' device."""
    n, p = theta.shape
    if h2 is None:
        h2 = rbf.bandwidth_sq_from_median(bisect_median(theta), n)

    if n <= KSD_DENSE_MAX_N:
        D = rbf.pairwise_sq_dists(theta)
        K = torch.exp(-D / h2 / 2.0)
        SS = torch.matmul(grads, grads.T)   # s_i . s_j
        ST = torch.matmul(grads, theta.T)   # s_i . x_j
        d = torch.sum(grads * theta, dim=1)   # s_i . x_i
        # (s_i - s_j).(x_i - x_j) = d_i + d_j - ST_ij - ST_ji
        cross = d[:, None] + d[None, :] - ST - ST.T
        U = K * (SS + cross / h2 + p / h2 - D / (h2 * h2))
        if u_statistic:
            total = torch.sum(U) - torch.sum(torch.diagonal(U))
            return total / (n * (n - 1))
        return torch.mean(U)

    # Streaming form. The diagonal is closed-form (D_ii = 0, K_ii = 1):
    # U_ii = |s_i|^2 + p / h2.
    d = torch.sum(grads * theta, dim=1)
    rsq = torch.sum(theta * theta, dim=1)
    b = min(block_rows, n)
    n_blocks = n // b
    total = torch.zeros((), dtype=theta.dtype, device=theta.device)
    for start in range(0, n_blocks * b, b):
        rows = slice(start, start + b)
        total = total + _ksd_row_block_sum(
            theta[rows], grads[rows], d[rows], theta, grads, d, rsq[rows],
            rsq, h2, p)
    rem = n - n_blocks * b
    if rem > 0:
        total = total + _ksd_row_block_sum(
            theta[-rem:], grads[-rem:], d[-rem:], theta, grads, d,
            rsq[-rem:], rsq, h2, p)
    if u_statistic:
        diag = torch.sum(grads * grads) + n * p / h2
        return (total - diag) / (n * (n - 1))
    return total / (n * n)
