"""Medians for the RBF bandwidth heuristic.

PyTorch counterpart of ``stein_tpu/ops/median.py``. The reference computes
the exact median of all n^2 entries of the pairwise squared-distance matrix
D (stein/utilities/compute_median.py:4-16). ``subsampled_sq_dist_median``
is the exact median of a strided row block; the sort-free searches count
``|{D <= t}|`` on such a block; ``binned_median`` refines a histogram of
all n^2 entries, streamed in row blocks of D, level by level, both
middle ranks' intervals in one sweep; its count is ``bin_count``, fed by
each block's Gram: a kernel on a card (``csrc/bin_count.cu``, D formed in
registers) and ``_gram_bin_counts`` on the CPU.

Every search is the JAX search's scalar expression tree in f32 0-d tensors
(integer counts, order-free min/max), so on the same D block it returns
bitwise the JAX value, and the scalars never leave the device.

The sharded searches (from ``sharded_warm_from_bracket`` on) take a
``ParticleMesh`` where the JAX functions take an axis name: each rank holds
a row block of the global sample, its counts are psum'd (one batched psum
per pass) and its range pmax'd, so every rank refines the same interval and
agrees bitwise on the result.
"""

import functools

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


def _sq_dists_from_gram(G, rowsq_rows, colsq):
    """D = (r + c^T) - 2 G of a Gram block G: the add, the product and the
    subtraction, each rounded in G's dtype."""
    return rowsq_rows[:, None] + colsq[None, :] - 2.0 * G


def _row_block_sq_dists(theta_rows, theta, rowsq_rows, rowsq):
    """Squared distances between a row block and all particles, the
    reference's D = r + r^T - 2 T T^T (abstract_kernel.py:33-35), with an
    f32 Gram (the JAX HIGHEST precision; TF32 stays off)."""
    return _sq_dists_from_gram(torch.matmul(theta_rows, theta.T), rowsq_rows,
                               rowsq)


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


def subsampled_sq_dist_median(theta, max_rows=512):
    """Exact median of the strided row block D[idx, :] (all of D when
    n <= max_rows); D itself is never formed."""
    return exact_median(row_subsample_block(theta, max_rows))


def _bin_counts(D, lo, width, n_bins):
    """The f32 histogram of the entries of D over n_bins bins of ``width``
    from ``lo``, out-of-range entries in the end bins: JAX's
    clip(((D - lo) / width).astype(int32), 0, n_bins - 1), whose end bins
    are q < 1 and q >= n_bins - 1 for q = (D - lo) / width (compared
    exactly: a bf16 q in f32, where torch would round n_bins - 1 to bf16;
    NaN in bin 0, as XLA converts it). XLA saturates an out-of-range float
    on conversion, where torch's is undefined, so only the interior
    quotients are converted. The counts are exact integers, converted to
    f32 as JAX's int32 block counts are. ``bin_count``'s plain version."""
    q = ((D - lo) / width).reshape(-1)
    if q.dtype != torch.float64:
        q = q.float()
    inner = torch.clamp(q, 1.0, max(n_bins - 1.0, 1.0)).to(torch.int32)
    idx = torch.where(q >= n_bins - 1, n_bins - 1,
                      torch.where(q >= min(1.0, n_bins - 1.0), inner, 0))
    return torch.bincount(idx, minlength=n_bins).to(torch.float32)


def _gram_bin_counts(G, rowsq_rows, colsq, windows, n_bins):
    """``bin_count``'s plain version: the f32 [len(windows), n_bins]
    histograms (``_bin_counts``) of the plain D of the Gram block ``G``
    (``_sq_dists_from_gram``), one a window (lo, width)."""
    D = _sq_dists_from_gram(G, rowsq_rows, colsq)
    return torch.stack([_bin_counts(D, lo, width, n_bins)
                        for lo, width in windows])


# bin_count's dtypes, by the kernel's code.
_BIN_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
# The largest Gram block the kernel takes (its indices are 32-bit).
_BIN_MAX_ENTRIES = 2 ** 31 - 2 ** 24


@functools.lru_cache(maxsize=None)
def _bin_scratch(n_bins, device):
    """bin_count's int32 scratch on ``device``, two windows' n_bins counts,
    zero between launches (each launch leaves it so)."""
    return torch.zeros(2 * n_bins, dtype=torch.int32, device=device)


def bin_count(G, rowsq_rows, colsq, windows, n_bins, out=None):
    """The histograms of D = (rowsq_rows[:, None] + colsq[None, :]) - 2 G
    over each window (lo, width) of ``windows`` (one or two), n_bins bins
    each: ``_gram_bin_counts``, added in place to the f32 [len(windows),
    n_bins] ``out`` when one is given (the sum of the blocks, in their
    order), and returned. A CUDA tensor launches the bin-count kernel
    (``csrc/bin_count.cu``: one read of G, D formed in registers and never
    written, every window counted in the same pass, ``lo`` and ``width``
    read on the card, the counts bitwise the plain version's); a CPU tensor
    runs the plain version. G [rows, cols], the norms [rows] and [cols],
    and the 0-d ``lo`` and ``width`` share one dtype: f32, bf16 or f64.
    Launches on one stream run in order, as they share a scratch."""
    if G.device.type == "cpu":
        counts = _gram_bin_counts(G, rowsq_rows, colsq, windows, n_bins)
        return counts if out is None else out.add_(counts)
    if G.device.type != "cuda":
        raise ValueError(f"bin_count: no kernel for {G.device}")
    scalars = [t for window in windows for t in window]
    tensors = [G, rowsq_rows, colsq] + scalars
    if G.dtype not in _BIN_DTYPES or any(t.dtype != G.dtype
                                         for t in tensors):
        raise TypeError(f"bin_count takes G, its norms, lo and width of one "
                        f"dtype of {list(_BIN_DTYPES)} (got "
                        f"{[t.dtype for t in tensors]})")
    n_win = len(windows)
    if G.dim() != 2 or tuple(rowsq_rows.shape) != G.shape[:1] \
            or tuple(colsq.shape) != G.shape[1:] \
            or any(t.device != G.device for t in tensors) \
            or any(t.dim() for t in scalars) or n_win not in (1, 2) \
            or any(len(window) != 2 for window in windows) or n_bins < 1 \
            or G.numel() > _BIN_MAX_ENTRIES:
        raise ValueError(
            "bin_count: G is a [rows, cols] block on a card (at most "
            f"{_BIN_MAX_ENTRIES} entries), its norms [rows] and [cols], "
            "one or two windows of 0-d (lo, width) on G's device, "
            f"n_bins >= 1 (got G {tuple(G.shape)}, norms "
            f"{tuple(rowsq_rows.shape)} and {tuple(colsq.shape)}, "
            f"{n_win} windows, n_bins={n_bins})")
    if out is not None and (out.dtype != torch.float32
                            or tuple(out.shape) != (n_win, n_bins)
                            or out.device != G.device
                            or not out.is_contiguous()):
        raise ValueError(f"bin_count: out must be a contiguous f32 "
                         f"[{n_win}, {n_bins}] tensor on {G.device}")
    from .. import _cuda

    G, rowsq_rows, colsq = (t.contiguous() for t in (G, rowsq_rows, colsq))
    acc = out
    if out is None:
        out = torch.empty(n_win, n_bins, dtype=torch.float32,
                          device=G.device)
    (lo0, w0), (lo1, w1) = windows[0], windows[-1]
    err = _cuda.library().lib.stein_bin_count(
        G.data_ptr(), G.shape[0], G.shape[1], _BIN_DTYPES[G.dtype],
        rowsq_rows.data_ptr(), colsq.data_ptr(), n_win, lo0.data_ptr(),
        w0.data_ptr(), lo1.data_ptr(), w1.data_ptr(), n_bins,
        None if acc is None else acc.data_ptr(), out.data_ptr(),
        _bin_scratch(n_bins, G.device).data_ptr(),
        torch.cuda.current_stream(G.device).cuda_stream)
    _cuda.check(err, "bin_count launch")
    bin_count.launches += 1
    return out


bin_count.launches = 0


def _bin_windows(windows, n_bins):
    """The (lo, width) of each interval (lo, hi): width = (hi - lo) /
    n_bins."""
    return [(lo, (hi - lo) / n_bins) for lo, hi in windows]


def _block_histogram(theta, rowsq, theta_cols, colsq, windows, n_bins,
                     block_rows):
    """The [len(windows), n_bins] histograms of the squared distances
    between ``theta``'s rows and ``theta_cols``'s rows over each interval
    (lo, hi) of ``windows`` (one or two), streaming row blocks of D (never
    materialised): a block's Gram, then its exact counts in every window
    in one ``bin_count`` (one launch a block on a card), summed across
    blocks in f32 in block order, the remainder rows (n not divisible by
    block_rows) last, as the JAX scan sums them. A direct f32 count would
    saturate once a bin passes 2^24."""
    wins = _bin_windows(windows, n_bins)
    counts = None
    for start in range(0, theta.shape[0], block_rows):
        G = torch.matmul(theta[start:start + block_rows], theta_cols.T)
        counts = bin_count(G, rowsq[start:start + block_rows], colsq, wins,
                           n_bins, counts)
    return counts


def _refine_levels(hist, lo0, hi0, total, n_bins, n_levels):
    """The two middle ranks' bins refined ``n_levels`` times: each level
    locates the bin holding rank k (searchsorted of the f32 cumulative
    counts, side='left') and searches inside it. ``hist(windows)`` is the
    (global) f32 [len(windows), n_bins] histogram of each interval (lo,
    hi) of ``windows``. Both ranks start from [lo0, hi0], so the first
    level's one histogram serves both; each later level counts both ranks'
    intervals in one sweep. The bins are those of refining each rank on
    its own (the JAX package's order). Returns the midpoint of the two
    final bin centres (np.median's midpoint for an even total)."""
    k_lo = (total + 1) // 2
    k_hi = total // 2 + 1

    def locate(counts, lo, hi, k):
        cum = torch.cumsum(counts, dim=0)
        kf = torch.full((1,), float(k), dtype=torch.float32,
                        device=cum.device)
        b = torch.searchsorted(cum, kf, side="left")[0].to(lo.dtype)
        width = (hi - lo) / n_bins
        return lo + b * width, lo + (b + 1.0) * width

    a = b = (lo0, hi0)
    for level in range(n_levels):
        if level == 0:
            c_a = c_b = hist([a])[0]
        else:
            c_a, c_b = hist([a, b])
        a, b = locate(c_a, *a, k_lo), locate(c_b, *b, k_hi)
    return 0.5 * ((a[0] + a[1]) * 0.5 + (b[0] + b[1]) * 0.5)


def _binned_range(max_rsq, dtype):
    """[lo0, hi0] bounding every entry of D: |a - b|^2 <= 4 max |x|^2, and
    lo0 just below 0 for fp-negative distances."""
    hi0 = 4.0 * max_rsq + 1e-12
    # A fill, not a copy from the host: a capture takes it.
    return torch.full((), -1e-6, dtype=dtype,
                      device=max_rsq.device) * (1.0 + hi0), hi0


def binned_median(theta, n_bins=4096, n_levels=2, block_rows=256,
                  mesh=None, theta_cols=None):
    """Near-exact median of all n^2 squared distances by histogram
    refinement, D never materialised: each level shrinks the interval by
    ``n_bins``, so the result is within range(D) / n_bins**n_levels / 2 of
    the exact median. With ``mesh``, ``theta`` is this rank's block and
    ``theta_cols`` the gathered particles; the histograms are psum'd and
    the range pmax'd, so every rank finds the same median."""
    rowsq = torch.sum(theta * theta, dim=1)
    if theta_cols is None:
        theta_cols, colsq = theta, rowsq
    else:
        colsq = torch.sum(theta_cols * theta_cols, dim=1)
    max_rsq = torch.max(colsq)
    if mesh is not None:
        max_rsq = coll.pmax(max_rsq, mesh)
    lo0, hi0 = _binned_range(max_rsq, theta.dtype)

    def hist(windows):
        counts = _block_histogram(theta, rowsq, theta_cols, colsq, windows,
                                  n_bins, block_rows)
        return counts if mesh is None else coll.psum(counts, mesh)

    n_total = theta_cols.shape[0]
    return _refine_levels(hist, lo0, hi0, n_total * n_total, n_bins,
                          n_levels)


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
# Counterparts of stein_tpu/ops/median.py:462-823.

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
    # A one-element index: indexing by a 0-d tensor reads it on the host.
    pick = torch.argmax(valid.to(torch.int32)).reshape(1)
    lo0 = lo.index_select(0, pick).reshape(())
    hi0 = lo0 + w.index_select(0, pick).reshape(())
    w2 = (hi0 - lo0) / g2
    steps = grid_steps(g2, D.device, lo0.dtype)[1:g2]
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


def sharded_bisect_median_on_D(D_rows, mesh, max_rows=512, passes=30):
    """The cold sharded bisect on this rank's exact [n_loc, n] distance
    rows (the 2-D mesh step's, psum'd over the model axis and so the same
    on every rank of it): the strided local rows, counts psum'd over the
    particle mesh ``mesh`` only."""
    n_loc, n = D_rows.shape
    idx, m_global = _local_row_idx(n_loc, mesh, max_rows, D_rows.device)
    return _sharded_bisect_on_rows(D_rows[idx], mesh, m_global * n, passes)


def sharded_warm_grid_on_D(D_rows, med_prev, hi_bound, mesh, max_rows=512,
                           warm_passes=8, brackets=DEFAULT_BRACKETS, g1=8):
    """The two-collective grid warm search on this rank's materialised
    [n_loc, n] distance rows (the 2-D mesh step's): the counts at every
    grid edge (grid_edges) in one broadcast compare of the strided rows,
    then sharded_warm_from_grid's two psums over the particle mesh. The
    counts are in the total's count dtype. ``hi_bound`` bounds every D
    entry and is the same on every rank: the 2-D step takes 4 max |x -
    mean|^2 of its psum'd CENTRED column norms, so the bound is at the
    spread's scale even for a cloud far from the origin."""
    from .fused_median import grid_edges

    n_loc, n = D_rows.shape
    idx, m_global = _local_row_idx(n_loc, mesh, max_rows, D_rows.device)
    D = D_rows[idx]
    total = m_global * n
    cnts = count_le(D, grid_edges(med_prev, hi_bound, brackets, g1),
                    _count_dtype(total))
    return sharded_warm_from_grid(D, med_prev, cnts, hi_bound, mesh, total,
                                  warm_passes=warm_passes, brackets=brackets,
                                  g1=g1)


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


def ring_binned_median(theta_loc, mesh, n_bins=2048, n_levels=2):
    """binned_median for the ring step: each rank histograms its local rows
    against every column block as the blocks circulate around the ring
    (``coll.ppermute_ring``), and the per-rotation counts, summed in f32,
    are psum'd over the mesh for the full n^2 coverage. A level's windows
    share one circulation and one psum."""
    n_loc = theta_loc.shape[0]
    n_total = n_loc * mesh.size
    rsq_loc = torch.sum(theta_loc * theta_loc, dim=1)
    lo0, hi0 = _binned_range(coll.pmax(torch.max(rsq_loc), mesh),
                             theta_loc.dtype)

    def hist(windows):
        wins = _bin_windows(windows, n_bins)
        counts = None
        blk, blk_rsq = theta_loc, rsq_loc
        for r in range(mesh.size):
            counts = bin_count(torch.matmul(theta_loc, blk.T), rsq_loc,
                               blk_rsq, wins, n_bins, counts)
            if r + 1 < mesh.size:
                blk = coll.ppermute_ring(blk, mesh)
                blk_rsq = coll.ppermute_ring(blk_rsq, mesh)
        return coll.psum(counts, mesh)

    return _refine_levels(hist, lo0, hi0, n_total * n_total, n_bins,
                          n_levels)
