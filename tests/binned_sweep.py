"""The binned median as a per-window sweep, the plain reference of the
port's shared sweeps (stein_tpu_torch/ops/median.py: binned_median,
ring_binned_median): each middle rank refined on its own, one histogram a
rank and level, each row block's D formed and counted by the plain count
(``_bin_counts``), the blocks summed in f32 in block order and psum'd a
histogram, as the JAX package orders them (stein_tpu/ops/median.py:
325-343). The port's medians must equal it bitwise. Imports torch and
stein_tpu_torch only; chip_smoke.py and the tests import it.
"""

import torch

from stein_tpu_torch.ops import median as M
from stein_tpu_torch.parallel import collectives as coll


def _refine_each_rank(hist, lo0, hi0, total, n_bins, n_levels):
    """The binned search's refinement with each middle rank on its own:
    one histogram ``hist(lo, hi)`` a rank and level (the JAX package's
    order, stein_tpu/ops/median.py:325-343)."""
    def refine(lo, hi, k):
        cum = torch.cumsum(hist(lo, hi), dim=0)
        kf = torch.full((1,), float(k), dtype=torch.float32,
                        device=cum.device)
        b = torch.searchsorted(cum, kf, side="left")[0].to(lo.dtype)
        width = (hi - lo) / n_bins
        return lo + b * width, lo + (b + 1.0) * width

    lo_a, hi_a = lo0, hi0
    lo_b, hi_b = lo0, hi0
    for _ in range(n_levels):
        lo_a, hi_a = refine(lo_a, hi_a, (total + 1) // 2)
        lo_b, hi_b = refine(lo_b, hi_b, total // 2 + 1)
    return 0.5 * ((lo_a + hi_a) * 0.5 + (lo_b + hi_b) * 0.5)


def _d_block_counts(rows, rsq, cols, csq, lo, width, n_bins, counts):
    """counts + the plain count (_bin_counts) of the row block's D, formed
    by _row_block_sq_dists."""
    c = M._bin_counts(M._row_block_sq_dists(rows, cols, rsq, csq), lo,
                      width, n_bins)
    return c if counts is None else counts + c


def reference_binned_median(theta, n_bins=4096, n_levels=2, block_rows=256,
                            mesh=None, theta_cols=None):
    """binned_median as a per-window sweep: a sweep of the row blocks and
    a psum a rank and level."""
    rowsq = torch.sum(theta * theta, dim=1)
    if theta_cols is None:
        theta_cols, colsq = theta, rowsq
    else:
        colsq = torch.sum(theta_cols * theta_cols, dim=1)
    max_rsq = torch.max(colsq)
    if mesh is not None:
        max_rsq = coll.pmax(max_rsq, mesh)
    lo0, hi0 = M._binned_range(max_rsq, theta.dtype)

    def hist(lo, hi):
        width = (hi - lo) / n_bins
        counts = None
        for start in range(0, theta.shape[0], block_rows):
            counts = _d_block_counts(
                theta[start:start + block_rows],
                rowsq[start:start + block_rows], theta_cols, colsq, lo,
                width, n_bins, counts)
        return counts if mesh is None else coll.psum(counts, mesh)

    return _refine_each_rank(hist, lo0, hi0, theta_cols.shape[0] ** 2,
                             n_bins, n_levels)


def reference_ring_binned_median(theta_loc, mesh, n_bins=2048, n_levels=2):
    """ring_binned_median as a per-window sweep: a circulation and a psum
    a rank and level."""
    rsq_loc = torch.sum(theta_loc * theta_loc, dim=1)
    lo0, hi0 = M._binned_range(coll.pmax(torch.max(rsq_loc), mesh),
                               theta_loc.dtype)

    def hist(lo, hi):
        width = (hi - lo) / n_bins
        counts = None
        blk, blk_rsq = theta_loc, rsq_loc
        for r in range(mesh.size):
            counts = _d_block_counts(theta_loc, rsq_loc, blk, blk_rsq, lo,
                                     width, n_bins, counts)
            if r + 1 < mesh.size:
                blk = coll.ppermute_ring(blk, mesh)
                blk_rsq = coll.ppermute_ring(blk_rsq, mesh)
        return coll.psum(counts, mesh)

    n_total = theta_loc.shape[0] * mesh.size
    return _refine_each_rank(hist, lo0, hi0, n_total * n_total, n_bins,
                             n_levels)
