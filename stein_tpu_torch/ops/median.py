"""Medians for the RBF bandwidth heuristic.

PyTorch counterpart of ``stein_tpu/ops/median.py`` but for
``subsampled_sq_dist_median``, the binned medians and the 2-D mesh's
searches on given D rows. The reference computes
the exact median of all n^2 entries of the pairwise squared-distance matrix
D (stein/utilities/compute_median.py:4-16); the sort-free searches here
count ``|{D <= t}|`` on a strided row subsample.

Every search is the JAX search's scalar expression tree in f32 0-d tensors
(integer counts, order-free min/max), so on the same D block it returns
bitwise the JAX value, and the scalars never leave the device.

The sharded searches (from ``sharded_warm_from_bracket`` on) take a
``ParticleMesh`` where the JAX functions take an axis name: each rank holds
a row block of the global sample, its counts are psum'd (one batched psum
per pass) and its range pmax'd, so every rank refines the same interval and
agrees bitwise on the result.
"""

import torch

from ..parallel import collectives as coll


# Tightest-first candidate brackets for the warm search, as multiples of
# the previous step's median (see the JAX module for how they were chosen).
DEFAULT_BRACKETS = ((0.92, 1.09), (0.7, 1.4), (0.25, 4.0))

# Above this many entries the searches take the quad-ary path; below it
# the dual-rank binary path (median.py:197).
QUAD_MIN_TOTAL = 100_000


def _count_dtype(total):
    """Counts are int32, or f32 once int32 would overflow (median.py:189)."""
    return torch.float32 if total >= 2 ** 31 else torch.int32


def count_le(D, thresholds, cdt=torch.int32):
    """|{D <= t}| for each threshold t, as a [len(thresholds)] tensor (one
    broadcast compare)."""
    return (D.reshape(1, -1) <= thresholds.reshape(-1, 1)).sum(dim=1,
                                                               dtype=cdt)


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


def _counts(D, thresholds, cdt, mesh):
    """count_le at a list of 0-d thresholds, psum'd over the mesh if any."""
    c = count_le(D, torch.stack(list(thresholds)), cdt)
    return c if mesh is None else coll.psum(c, mesh)


def _bisect_search(D, lo0, hi0, passes, mesh=None, total=None):
    """Shared bisection core over the block D: the quad-ary single-rank
    search above QUAD_MIN_TOTAL entries, else both middle ranks by binary
    halving (so the even-count median matches np.median). With ``mesh``, D
    is this rank's rows of a ``total``-entry global sample and each pass's
    counts are psum'd in one collective."""
    if total is None:
        total = D.numel()
    cdt = _count_dtype(total)
    k_lo = (total + 1) // 2
    k_hi = total // 2 + 1

    if total > QUAD_MIN_TOTAL:
        return _quad_rounds(D, lo0, hi0, k_lo, (passes + 1) // 2, cdt, mesh)

    lo_a, hi_a, lo_b, hi_b = lo0, hi0, lo0, hi0
    for _ in range(passes):
        mid_a = 0.5 * (lo_a + hi_a)
        mid_b = 0.5 * (lo_b + hi_b)
        c = _counts(D, (mid_a, mid_b), cdt, mesh)
        go_lo_a = c[0] >= k_lo
        go_lo_b = c[1] >= k_hi
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


def _warm_search(D, med_prev, warm_passes, brackets=None, mesh=None,
                 total=None):
    """The warm-bracket search on the block D: one pass for the range and
    every candidate endpoint count, the tightest verified bracket (else the
    full range), then ceil(warm_passes/2) quad-ary rounds. ``med_prev`` is
    a 0-d f32 tensor (or a float); med_prev <= 0 is the cold search. With
    ``mesh``, D is this rank's rows of a ``total``-entry global sample: the
    range is one pmax of [-lo, hi] and the counts one psum per pass."""
    if brackets is None:
        brackets = DEFAULT_BRACKETS
    if total is None:
        total = D.numel()
    cdt = _count_dtype(total)
    k = (total + 1) // 2
    med_prev = torch.as_tensor(med_prev, dtype=D.dtype, device=D.device)

    ends = [(lo * med_prev, hi * med_prev) for lo, hi in brackets]
    lo_full, hi_full = _range(D)
    if mesh is not None:
        mm = coll.pmax(torch.stack([-lo_full, hi_full]), mesh)
        lo_full, hi_full = -mm[0], mm[1]
    flat = _counts(D, [t for pair in ends for t in pair], cdt, mesh)
    cnts = [(flat[2 * i], flat[2 * i + 1]) for i in range(len(brackets))]
    lo0, hi0 = select_bracket(med_prev, ends, cnts, k, lo_full, hi_full)
    return _quad_rounds(D, lo0, hi0, k, (warm_passes + 1) // 2, cdt, mesh)


def _quad_rounds(D, lo0, hi0, k, rounds, cdt, mesh=None):
    """Quad-ary refinement: three thresholds per round, 2 bits per pass
    (one psum per round with ``mesh``); ``b`` is the number of interior
    thresholds below rank k."""
    lo, hi = lo0, hi0
    for _ in range(rounds):
        w = 0.25 * (hi - lo)
        c = _counts(D, (lo + w, lo + 2.0 * w, lo + 3.0 * w), cdt, mesh)
        b = (c < k).to(lo.dtype).sum()
        lo = lo + b * w
        hi = lo + w
    return 0.5 * (lo + hi)


# ------------------------------------------------------------ sharded
# Counterparts of stein_tpu/ops/median.py:462-775 (the 2-D mesh's
# sharded_warm_grid_on_D and the binned medians are not ported yet).

def sharded_warm_from_bracket(D, med_prev, mm, cnts_local, mesh, total,
                              warm_passes=8, brackets=DEFAULT_BRACKETS):
    """Finish the sharded warm search whose first pass (this rank's block
    range ``mm`` = [-min(D, 0), max D] and its [2 * n_brackets] endpoint
    counts) came from the bracket kernel (ops.fused_median.
    fused_bracket_pass): one pmax, one batched psum, then the quad-ary
    rounds over this rank's block D, one psum each."""
    k = (total + 1) // 2
    cdt = _count_dtype(total)
    mm_g = coll.pmax(mm, mesh)
    cnts_g = coll.psum(cnts_local.to(cdt), mesh)
    ends = [(lo * med_prev, hi * med_prev) for lo, hi in brackets]
    cnt_pairs = [(cnts_g[2 * i], cnts_g[2 * i + 1])
                 for i in range(len(brackets))]
    lo0, hi0 = select_bracket(med_prev, ends, cnt_pairs, k, -mm_g[0],
                              mm_g[1])
    return _quad_rounds(D, lo0, hi0, k, (warm_passes + 1) // 2, cdt, mesh)


def sharded_warm_from_grid(D, med_prev, cnts_local, hi_bound, mesh, total,
                           warm_passes=8, brackets=DEFAULT_BRACKETS, g1=16):
    """Finish the two-collective sharded warm search whose first pass, the
    counts at every candidate's (g1 + 1)-point grid (ops.fused_median.
    grid_edges), came from the grid bracket kernel (fused_bracket_grid_pass).
    psum 1 selects the tightest candidate whose grid ends straddle the
    median's rank (the full-range fallback [~0, hi_bound] always does) and
    locates the rank's g1-ary sub-bin; psum 2 counts one g2-ary round over
    this rank's block D, g2 = 2**warm_passes / g1, so the final width is
    the candidate's / 2**warm_passes as in the quad-round search.
    ``hi_bound`` bounds every D entry and is the same on every rank; ``g1``
    is a power of two and the kernel's."""
    from .fused_median import grid_edges, grid_steps

    k = (total + 1) // 2
    cdt = _count_dtype(total)
    lg1 = g1.bit_length() - 1
    if g1 != 2 ** lg1:
        raise ValueError(f"grid g1 must be a power of two (got {g1})")
    g2 = 2 ** max(warm_passes - lg1, 1)
    if g2 > 1024:
        raise ValueError(
            f"median_collectives='grid' counts 2**(warm_passes - log2(g1)) "
            f"= {g2} thresholds per step; cap warm_passes at {lg1 + 10} for "
            f"g1={g1}, or use median_collectives='rounds' (looped search) "
            "for deeper refinement"
        )
    nb = len(brackets)
    c = coll.psum(cnts_local.to(cdt), mesh).reshape(nb + 1, g1 + 1)
    edges = grid_edges(med_prev, hi_bound, brackets, g1).reshape(nb + 1,
                                                                 g1 + 1)
    lo_e = edges[:, 0]
    w = edges[:, 1] - edges[:, 0]
    lo = lo_e + (c[:, 1:g1] < k).to(lo_e.dtype).sum(dim=1) * w
    # The tightest valid candidate wins (select_bracket's order); the
    # fallback grid (last) is valid by construction.
    valid = (c[:, 0] < k) & (c[:, g1] >= k)
    valid = torch.cat([valid[:nb] & (med_prev > 0),
                       torch.ones(1, dtype=torch.bool, device=D.device)])
    pick = torch.argmax(valid.to(torch.int32))
    lo0 = lo[pick]
    hi0 = lo0 + w[pick]
    w2 = (hi0 - lo0) / g2
    steps = grid_steps(g2, D.device)[1:g2]
    cnts2 = coll.psum(count_le(D, lo0 + steps * w2, cdt), mesh)
    b2 = (cnts2 < k).to(lo0.dtype).sum()
    return lo0 + (b2 + 0.5) * w2


def _local_row_idx(n_loc, mesh, max_rows, device=None):
    """THE local-row subsample policy of every sharded median: ~max_rows
    rows used globally, split evenly over the mesh, strided locally.
    Returns (row indices, global row count)."""
    m = max(min(max_rows // mesh.size, n_loc), 1)
    stride = max(n_loc // m, 1)
    return torch.arange(m, device=device) * stride, m * mesh.size


def _sharded_row_block(theta_loc, theta_all, mesh, max_rows):
    """This rank's strided local rows against the gathered global columns.
    Returns (D block, global entry count)."""
    n = theta_all.shape[0]
    idx, m_global = _local_row_idx(theta_loc.shape[0], mesh, max_rows,
                                   theta_loc.device)
    rows = theta_loc[idx]
    D = _row_block_sq_dists(rows, theta_all, torch.sum(rows * rows, dim=1),
                            torch.sum(theta_all * theta_all, dim=1))
    return D, m_global * n


def _sharded_bisect_on_rows(Ds, mesh, total, passes):
    """The sharded bisect search on this rank's row block ``Ds`` of a
    ``total``-entry global sample: the range from one pmax of [-lo, hi],
    each pass's counts psum'd in one collective."""
    lo, hi = _range(Ds)
    mm = coll.pmax(torch.stack([-lo, hi]), mesh)
    return _bisect_search(Ds, -mm[0], mm[1], passes, mesh=mesh, total=total)


def sharded_bisect_median(theta_loc, theta_all, mesh, max_rows=512,
                          passes=30):
    """The all-gather mesh step's cold median: each rank counts its strided
    local rows against the gathered columns, psum'd."""
    D, total = _sharded_row_block(theta_loc, theta_all, mesh, max_rows)
    return _sharded_bisect_on_rows(D, mesh, total, passes)


def sharded_warm_bisect_median(theta_loc, theta_all, med_prev, mesh,
                               max_rows=512, warm_passes=8,
                               brackets=DEFAULT_BRACKETS):
    """The warm search of the all-gather mesh step (see warm_bisect_median),
    counts psum'd and range pmax'd."""
    D, total = _sharded_row_block(theta_loc, theta_all, mesh, max_rows)
    return _warm_search(D, med_prev, warm_passes, brackets, mesh=mesh,
                        total=total)


def sharded_warm_bisect_median_on_D(D_rows, med_prev, mesh, max_rows=512,
                                    warm_passes=8,
                                    brackets=DEFAULT_BRACKETS):
    """sharded_warm_bisect_median on this rank's materialised [n_loc, n]
    distance rows (the same strided rows, no second Gram)."""
    n_loc, n = D_rows.shape
    idx, m_global = _local_row_idx(n_loc, mesh, max_rows, D_rows.device)
    return _warm_search(D_rows[idx], med_prev, warm_passes, brackets,
                        mesh=mesh, total=m_global * n)


def ring_median_block(theta_loc, mesh, max_rows=512):
    """This rank's strided local rows against all columns, assembled by
    circulating the column blocks around the ring instead of gathering
    them; each block lands at its source rank's column offset, so the block
    holds the all-gather block's entries. Returns (D [m_loc, n], global
    entry count)."""
    n_loc = theta_loc.shape[0]
    n = n_loc * mesh.size
    idx, m_global = _local_row_idx(n_loc, mesh, max_rows, theta_loc.device)
    rows = theta_loc[idx]
    rsq_rows = torch.sum(rows * rows, dim=1)
    blk = theta_loc
    blk_rsq = torch.sum(theta_loc * theta_loc, dim=1)
    D = torch.empty(rows.shape[0], n, dtype=theta_loc.dtype,
                    device=theta_loc.device)
    for r in range(mesh.size):
        src = (mesh.rank - r) % mesh.size   # whose block we hold
        D[:, src * n_loc:(src + 1) * n_loc] = _row_block_sq_dists(
            rows, blk, rsq_rows, blk_rsq)
        if r + 1 < mesh.size:
            blk = coll.ppermute_ring(blk, mesh)
            blk_rsq = coll.ppermute_ring(blk_rsq, mesh)
    return D, m_global * n


def ring_bisect_median(theta_loc, mesh, max_rows=512, passes=30):
    """sharded_bisect_median of the ring step (ring_median_block)."""
    D, total = ring_median_block(theta_loc, mesh, max_rows)
    return _sharded_bisect_on_rows(D, mesh, total, passes)


def ring_warm_bisect_median(theta_loc, med_prev, mesh, max_rows=512,
                            warm_passes=8, brackets=DEFAULT_BRACKETS):
    """sharded_warm_bisect_median of the ring step."""
    D, total = ring_median_block(theta_loc, mesh, max_rows)
    return _warm_search(D, med_prev, warm_passes, brackets, mesh=mesh,
                        total=total)
