"""Medians for the RBF bandwidth heuristic (single-device part).

PyTorch counterpart of ``stein_tpu/ops/median.py:35-240, 347-460``. The
reference computes the exact median of all n^2 entries of the pairwise
squared-distance matrix D (stein/utilities/compute_median.py:4-16); the
sort-free searches here count ``|{D <= t}|`` on a strided row subsample.

Every search is the JAX search's scalar expression tree in f32 0-d tensors
(integer counts, order-free min/max), so on the same D block it returns
bitwise the JAX value, and the scalars never leave the device.
"""

import torch


# Tightest-first candidate brackets for the warm search, as multiples of
# the previous step's median (see the JAX module for how they were chosen).
DEFAULT_BRACKETS = ((0.92, 1.09), (0.7, 1.4), (0.25, 4.0))

# Above this many entries the searches take the quad-ary path; below it
# the dual-rank binary path (median.py:197).
QUAD_MIN_TOTAL = 100_000


def _count_dtype(total):
    """Counts are int32, or f32 once int32 would overflow (median.py:189)."""
    return torch.float32 if total >= 2 ** 31 else torch.int32


def _count_le(D, t, cdt):
    return (D <= t).sum(dtype=cdt)


def select_bracket(med_prev, ends, cnts, k_c, lo_full, hi_full):
    """Branchless tightest-valid-bracket select: widest-first applies,
    tightest-last overrides; a bracket is valid iff its endpoint counts
    straddle the median's rank k."""
    have_hint = med_prev > 0
    lo0, hi0 = lo_full, hi_full
    for (a, b), (c_a, c_b) in reversed(list(zip(ends, cnts))):
        valid = have_hint & (c_a < k_c) & (c_b >= k_c)
        lo0 = torch.where(valid, a, lo0)
        hi0 = torch.where(valid, b, hi0)
    return lo0, hi0


def exact_median(D):
    """Exact median over all entries of D, with np.median semantics.
    ``torch.median`` returns the lower middle value and ``torch.quantile``
    refuses more than 2^24 elements, so the two middle order statistics
    come from ``kthvalue`` and meet as jnp.median's midpoint does."""
    flat = D.reshape(-1)
    total = flat.numel()
    lo = torch.kthvalue(flat, (total + 1) // 2).values
    hi = torch.kthvalue(flat, total // 2 + 1).values
    return (lo + hi) * 0.5


def _row_block_sq_dists(theta_rows, theta, rowsq_rows, rowsq):
    """Squared distances between a row block and all particles, the
    reference's D = r + r^T - 2 T T^T (abstract_kernel.py:33-35), with an
    f32 Gram (the JAX HIGHEST precision; TF32 stays off)."""
    return (rowsq_rows[:, None] + rowsq[None, :]
            - 2.0 * torch.matmul(theta_rows, theta.T))


def _subsample_idx(n, max_rows, device=None):
    """THE single-device strided-row subsample policy:
    idx = arange(max_rows) * (n // max_rows), or None when every row is
    kept (n <= max_rows). Every single-device entry point derives its rows
    from here."""
    if n <= max_rows:
        return None
    return torch.arange(max_rows, device=device) * (n // max_rows)


def row_subsample_block(theta, max_rows=512):
    """The strided-row distance block D[idx, :] (all rows when
    n <= max_rows)."""
    rowsq = torch.sum(theta * theta, dim=1)
    idx = _subsample_idx(theta.shape[0], max_rows, theta.device)
    if idx is None:
        return _row_block_sq_dists(theta, theta, rowsq, rowsq)
    return _row_block_sq_dists(theta[idx], theta, rowsq[idx], rowsq)


def subsample_rows(theta, max_rows=512):
    """The rows _subsample_idx selects, without the distance block; None
    when every row is kept."""
    idx = _subsample_idx(theta.shape[0], max_rows, theta.device)
    return None if idx is None else theta[idx]


def _strided_rows(D, max_rows):
    """The same strided rows of a materialised D."""
    idx = _subsample_idx(D.shape[0], max_rows, D.device)
    return D if idx is None else D[idx]


def _range(D):
    return torch.clamp(D.min(), max=0.0), D.max()


def bisect_median_on_D(D, max_rows=512, passes=30):
    """bisect_median for callers that already hold the full [n, n] D."""
    Ds = _strided_rows(D, max_rows)
    lo0, hi0 = _range(Ds)
    return _bisect_search(Ds, lo0, hi0, passes)


def bisect_median(theta, max_rows=512, passes=30):
    """Sort-free median of the (row-subsampled) squared-distance matrix by
    bisection on the value axis (see the JAX module for the method)."""
    D = row_subsample_block(theta, max_rows)
    lo0, hi0 = _range(D)
    return _bisect_search(D, lo0, hi0, passes)


def _bisect_search(D, lo0, hi0, passes):
    """Shared bisection core over the block D: the quad-ary single-rank
    search above QUAD_MIN_TOTAL entries, else both middle ranks by binary
    halving (so the even-count median matches np.median)."""
    total = D.numel()
    cdt = _count_dtype(total)
    k_lo = (total + 1) // 2
    k_hi = total // 2 + 1

    if total > QUAD_MIN_TOTAL:
        return _quad_rounds(D, lo0, hi0, k_lo, (passes + 1) // 2, cdt)

    lo_a, hi_a, lo_b, hi_b = lo0, hi0, lo0, hi0
    for _ in range(passes):
        mid_a = 0.5 * (lo_a + hi_a)
        mid_b = 0.5 * (lo_b + hi_b)
        go_lo_a = _count_le(D, mid_a, cdt) >= k_lo
        go_lo_b = _count_le(D, mid_b, cdt) >= k_hi
        lo_a, hi_a = (torch.where(go_lo_a, lo_a, mid_a),
                      torch.where(go_lo_a, mid_a, hi_a))
        lo_b, hi_b = (torch.where(go_lo_b, lo_b, mid_b),
                      torch.where(go_lo_b, mid_b, hi_b))
    return 0.5 * (0.5 * (lo_a + hi_a) + 0.5 * (lo_b + hi_b))


def warm_bisect_median(theta, med_prev, max_rows=512, warm_passes=8,
                       brackets=DEFAULT_BRACKETS):
    """Branchless bisect median warm-started from the previous step's
    value (see the JAX module for the bracket chain and its error bound)."""
    D = row_subsample_block(theta, max_rows)
    return _warm_search(D, med_prev, warm_passes, brackets)


def warm_bisect_median_on_D(D, med_prev, max_rows=512, warm_passes=8,
                            brackets=DEFAULT_BRACKETS):
    """warm_bisect_median for callers that already hold the full D."""
    return _warm_search(_strided_rows(D, max_rows), med_prev, warm_passes,
                        brackets)


def _warm_search(D, med_prev, warm_passes, brackets=None):
    """The warm-bracket search on the block D: one pass for the range and
    every candidate endpoint count, the tightest verified bracket (else the
    full range), then ceil(warm_passes/2) quad-ary rounds. ``med_prev`` is
    a 0-d f32 tensor (or a float); med_prev <= 0 is the cold search."""
    if brackets is None:
        brackets = DEFAULT_BRACKETS
    total = D.numel()
    cdt = _count_dtype(total)
    k = (total + 1) // 2
    med_prev = torch.as_tensor(med_prev, dtype=D.dtype, device=D.device)

    ends = [(lo * med_prev, hi * med_prev) for lo, hi in brackets]
    lo_full, hi_full = _range(D)
    cnts = [(_count_le(D, a, cdt), _count_le(D, b, cdt)) for a, b in ends]
    lo0, hi0 = select_bracket(med_prev, ends, cnts, k, lo_full, hi_full)
    return _quad_rounds(D, lo0, hi0, k, (warm_passes + 1) // 2, cdt)


def _quad_rounds(D, lo0, hi0, k, rounds, cdt):
    """Quad-ary refinement: three thresholds per round, 2 bits per pass;
    ``b`` is the number of interior thresholds below rank k."""
    lo, hi = lo0, hi0
    for _ in range(rounds):
        w = 0.25 * (hi - lo)
        b = ((_count_le(D, lo + w, cdt) < k).to(lo.dtype)
             + (_count_le(D, lo + 2.0 * w, cdt) < k).to(lo.dtype)
             + (_count_le(D, lo + 3.0 * w, cdt) < k).to(lo.dtype))
        lo = lo + b * w
        hi = lo + w
    return 0.5 * (lo + hi)
