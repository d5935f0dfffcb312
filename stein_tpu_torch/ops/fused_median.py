"""Single-kernel warm-median search (kernel B2), the in-kernel-Gram
medians (kernels B4, B5) and the sharded median's bracket passes (B8, B9).

PyTorch counterpart of ``stein_tpu/ops/pallas_median.py``:
``fused_block_ok``, ``warm_search_on_value``, ``fused_warm_median_rows``,
``bracket_pass_fits``, ``pallas_dist_block`` (here ``dist_block``),
``fused_warm_median_from_theta``, ``grid_edges``, ``fused_bracket_pass`` and
``fused_bracket_grid_pass``.

The CUDA kernel (``csrc/warm_search.cuh``, ``warm_median_kernel``) replaces
``stein_tpu/ops/pallas_median.py:_warm_kernel``: the whole search (range,
bracket counts, select, quad-ary rounds, midpoint) in one cooperative launch
over every SM, on the block in device memory, with grid barriers between
the sweeps and the scalars kept on the device. What bounds it
on the H100 and what the design does about it is in the source's header.

Contract: bitwise the value of ``ops.median._warm_search`` on the same block
(integer counts, order-free min/max, the same f32 scalar expression tree).
For a CPU tensor the wrapper runs that plain search; for a CUDA tensor it
launches the kernel or raises.

B4 (``csrc/dist_block.cu``, replacing ``pallas_median.py:_dist_block_kernel``)
writes the centred [m, n] distance block, for B2 to search, by the median
kernel's tensor-core Gram stage (``csrc/gram_stage.cuh``) in one cooperative
launch. B5 (``median_kernel`` with a given centre, replacing
``pallas_median.py:_warm_from_theta_kernel``) computes that block and the
whole warm search in one cooperative launch. Both take p up to the stage's
room (~46000) and refuse a wider p by a CUDA error. Their plain versions
compute the block with a torch matmul; the median then sees D from another
dot order, so B5 against its plain version is bitwise on exact (lattice) D
and within one final bracket interval otherwise.

B8 and B9 (``csrc/bracket_pass.cu``, replacing ``pallas_median.py:
_bracket_gram_kernel`` and ``_bracket_grid_kernel``) build the same centred
block with the median kernel's tensor-core Gram stage in one cooperative
launch, write it out, and count it from registers at the warm search's
bracket endpoints (B8, with the block's range) or at every ``grid_edges``
threshold (B9, the edges formed in the kernel in that function's
expression order): the local half of the sharded search, whose
collectives follow outside the kernel (``ops.median.
sharded_warm_from_bracket`` and ``sharded_warm_from_grid``). Against their
plain versions D agrees to the dot order, and the counts and range equal
the plain counts over the kernel's own D.
"""

import ctypes
import functools

import torch

from .median import (
    DEFAULT_BRACKETS,
    QUAD_MIN_TOTAL,
    _warm_search,
    count_le,
    select_bracket,
)
from .rbf import log_n


def fused_block_ok(m, n):
    """Whether the single-kernel search applies to an [m, n] block: the
    quad-ary regime (> 100k entries; below it the plain search takes the
    dual-rank binary path with other results), int32-safe counts, and the
    JAX package's 12 MiB block gate, kept as it is so both packages route
    the same blocks. Callers fall back to ``bisect_median`` otherwise."""
    total = m * n
    return QUAD_MIN_TOTAL < total < 2 ** 31 and 4 * total <= 12 * 2 ** 20


def bracket_pass_fits(m, n, p):
    """The JAX package's gate for the one-launch Gram + search (B5): the
    [m, n] block and the [m, p], [n, p] operands within its ~12 MiB
    budget, kept as it is so both packages route the same shapes."""
    return 4 * (int(m) * n + (m + n) * p) * 5 // 2 <= 12 * 2 ** 20


def warm_search_on_value(D, med_prev, warm_passes=8,
                         brackets=DEFAULT_BRACKETS):
    """The plain version of the kernel's search (the JAX package's in-kernel
    helper of this name): ops.median._warm_search on the [m, n] block."""
    return _warm_search(D, med_prev, warm_passes, brackets)


def warm_search_folded(D, med_prev, warm_passes=8,
                       brackets=DEFAULT_BRACKETS):
    """The CUDA search's own schedule in plain PyTorch, for the tests (no
    path calls it): the first pass as ``_warm_search``'s, then the
    quad-ary rounds two to a sweep. A sweep counts round r's three
    thresholds and, for each b in 0..3, the three that round r + 1 would
    take after round r moved lo by b w: 15 counts in one pass (an odd last
    round alone). Then it selects b, and b' among the candidates of b. Each
    candidate's thresholds are the sequential expression tree on the same
    f32 inputs, so the result is bitwise ``_warm_search``'s on the same
    block, in 1 + ceil(rounds / 2) passes over it instead of 1 + rounds."""
    total = D.numel()
    k = (total + 1) // 2
    f32 = torch.float32
    med_prev = torch.as_tensor(med_prev, dtype=f32, device=D.device)
    ends = [(lo * med_prev, hi * med_prev) for lo, hi in brackets]
    flat = count_le(D, torch.stack([t for pair in ends for t in pair]))
    lo, hi = select_bracket(
        med_prev, ends,
        [(flat[2 * i], flat[2 * i + 1]) for i in range(len(brackets))], k,
        torch.clamp(D.min(), max=0.0), D.max())

    def quad(lo, w):
        return [lo + w, lo + 2.0 * w, lo + 3.0 * w]

    rounds = (warm_passes + 1) // 2
    for r in range(0, rounds, 2):
        two = r + 1 < rounds
        w = 0.25 * (hi - lo)
        ts = quad(lo, w)
        if two:
            for b in range(4):
                lo_b = lo + float(b) * w
                hi_b = lo_b + w
                ts += quad(lo_b, 0.25 * (hi_b - lo_b))
        c = count_le(D, torch.stack(ts))
        b = (c[:3] < k).to(f32).sum()
        lo = lo + b * w
        hi = lo + w
        if two:
            w = 0.25 * (hi - lo)
            b2 = (c[3:].reshape(4, 3)[b.long()] < k).to(f32).sum()
            lo = lo + b2 * w
            hi = lo + w
    return 0.5 * (lo + hi)


def _bracket_arrays(brackets):
    lo = (ctypes.c_float * len(brackets))(*[b[0] for b in brackets])
    hi = (ctypes.c_float * len(brackets))(*[b[1] for b in brackets])
    return lo, hi


def _addr(arr):
    return ctypes.cast(arr, ctypes.c_void_p)


def _scalar_on(med_prev, D):
    """med_prev as a 0-d f32 tensor on D's device (a Python number becomes
    one without a host-to-device copy)."""
    if isinstance(med_prev, torch.Tensor):
        return med_prev.to(device=D.device, dtype=torch.float32).reshape(())
    return torch.full((), float(med_prev), dtype=torch.float32,
                      device=D.device)


def fused_warm_median_rows(D_sub, med_prev, warm_passes=8,
                           brackets=DEFAULT_BRACKETS):
    """Warm median of the (already row-subsampled) distance block: the
    drop-in, bitwise-equal replacement for
    ``ops.median._warm_search(D_sub, med_prev, warm_passes, brackets)``.
    Returns a 0-d f32 tensor on D_sub's device. f32 only."""
    m, n = D_sub.shape
    total = m * n
    if total >= 2 ** 31:
        raise ValueError(
            f"fused warm median: {m}x{n} block exceeds int32 counts"
        )
    if D_sub.dtype != torch.float32:
        raise TypeError(
            f"fused warm median is f32-only (got {D_sub.dtype}); use the "
            "plain warm search for other dtypes"
        )
    k = (total + 1) // 2
    rounds = (warm_passes + 1) // 2
    med = _scalar_on(med_prev, D_sub)
    if D_sub.device.type == "cpu":
        return warm_search_on_value(D_sub, med, warm_passes, brackets)
    if D_sub.device.type != "cuda":
        raise ValueError(f"fused warm median: no kernel for {D_sub.device}")
    if len(brackets) > 8:
        raise ValueError("fused warm median: the kernel takes <= 8 brackets")
    from .. import _cuda

    lib = _cuda.library().lib
    D = D_sub.contiguous()
    blocks = _cuda.median_blocks(0)
    out = torch.empty(2, dtype=torch.float32, device=D.device)
    part_counts = torch.empty((1 + rounds) * blocks * 16, dtype=torch.int32,
                              device=D.device)
    part_range = torch.empty(2 * blocks, dtype=torch.float32,
                             device=D.device)
    lo, hi = _bracket_arrays(brackets)
    stream = torch.cuda.current_stream(D.device).cuda_stream
    err = lib.stein_warm_median(
        D.data_ptr(), total, med.data_ptr(), k, rounds, _addr(lo), _addr(hi),
        len(brackets), log_n(n), out.data_ptr(), part_counts.data_ptr(),
        part_range.data_ptr(), stream,
    )
    _cuda.check(err, "warm_median_kernel launch")
    fused_warm_median_rows.launches += 1
    return out[0]


fused_warm_median_rows.launches = 0


def _check_gram(rows, cols, center, what):
    m, p = rows.shape
    if rows.dtype != torch.float32 or cols.dtype != torch.float32:
        raise TypeError(f"{what} is f32-only (got rows={rows.dtype}, "
                        f"cols={cols.dtype})")
    center = center.to(torch.float32).reshape(1, p)
    if cols.shape[1] != p or cols.device != rows.device \
            or center.device != rows.device:
        raise ValueError(f"{what}: rows, cols and center must be [*, {p}] "
                         f"on {rows.device}")
    return center


def dist_block_plain(rows, cols, center):
    """Kernel B4's plain version: the centred [m, n] block by a torch
    matmul, the JAX kernel body's expression."""
    rows_c = rows - center
    cols_c = cols - center
    rsq_r = torch.sum(rows_c * rows_c, dim=1, keepdim=True)
    rsq_c = torch.sum(cols_c * cols_c, dim=1, keepdim=True)
    return (rsq_r + rsq_c.reshape(1, -1)
            - 2.0 * torch.matmul(rows_c, cols_c.T))


def dist_block(rows, cols, center):
    """[m, n] centred squared-distance block of rows [m, p] against cols
    [n, p] about ``center`` ([1, p]), f32 only (the JAX function's
    ``block_j`` has no counterpart: the CUDA kernel's tiles are its own).
    On the card the Gram stage's scratch holds the centred rows and
    columns (``stein_gram_prep_floats``)."""
    center = _check_gram(rows, cols, center, "dist_block")
    if rows.device.type == "cpu":
        return dist_block_plain(rows, cols, center)
    if rows.device.type != "cuda":
        raise ValueError(f"dist_block: no kernel for {rows.device}")
    from .. import _cuda

    rows, cols, center = rows.contiguous(), cols.contiguous(), \
        center.contiguous()
    m, p = rows.shape
    n = cols.shape[0]
    lib = _cuda.library().lib
    out = torch.empty(m, n, dtype=torch.float32, device=rows.device)
    prep = torch.empty(lib.stein_gram_prep_floats(n, m, p),
                       dtype=torch.float32, device=rows.device)
    err = lib.stein_dist_block(
        rows.data_ptr(), cols.data_ptr(), center.data_ptr(), m, n, p,
        out.data_ptr(), prep.data_ptr(),
        torch.cuda.current_stream(rows.device).cuda_stream,
    )
    _cuda.check(err, "dist_block_kernel launch")
    dist_block.launches += 1
    return out


dist_block.launches = 0


def fused_warm_median_from_theta(rows, cols, med_prev, center,
                                 warm_passes=8, brackets=DEFAULT_BRACKETS):
    """The whole warm median of the centred [m, n] block of rows against
    cols, Gram and search in one launch (median_impl='fused_gram').
    Returns a 0-d f32 tensor; gate shapes with ``bracket_pass_fits``."""
    center = _check_gram(rows, cols, center, "fused_warm_median_from_theta")
    m, p = rows.shape
    n = cols.shape[0]
    total = m * n
    if total >= 2 ** 31:
        raise ValueError(
            f"fused warm median: {m}x{n} block exceeds int32 counts"
        )
    med = _scalar_on(med_prev, rows)
    if rows.device.type == "cpu":
        return warm_search_on_value(dist_block_plain(rows, cols, center),
                                    med, warm_passes, brackets)
    if rows.device.type != "cuda":
        raise ValueError(f"fused warm median: no kernel for {rows.device}")
    if len(brackets) > 8:
        raise ValueError("fused warm median: the kernel takes <= 8 brackets")
    from .. import _cuda

    rows, cols, center = rows.contiguous(), cols.contiguous(), \
        center.contiguous()
    dev = rows.device
    rounds = (warm_passes + 1) // 2
    blocks = _cuda.median_blocks(p)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    dsub = torch.empty(total, dtype=torch.float32, device=dev)
    part_counts = torch.empty((1 + rounds) * blocks * 16, dtype=torch.int32,
                              device=dev)
    part_range = torch.empty(2 * blocks, dtype=torch.float32, device=dev)
    lib = _cuda.library().lib
    prep = torch.empty(lib.stein_gram_prep_floats(n, m, p),
                       dtype=torch.float32, device=dev)
    lo, hi = _bracket_arrays(brackets)
    err = lib.stein_warm_from_theta(
        rows.data_ptr(), cols.data_ptr(), center.data_ptr(), m, n, p,
        med.data_ptr(), (total + 1) // 2, rounds, _addr(lo), _addr(hi),
        len(brackets), log_n(n), out.data_ptr(), dsub.data_ptr(),
        part_counts.data_ptr(), part_range.data_ptr(), prep.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _cuda.check(err, "median_kernel (from theta) launch")
    fused_warm_median_from_theta.launches += 1
    return out[0]


fused_warm_median_from_theta.launches = 0


def _bracket_checks(rows, cols, center, what):
    m, n = rows.shape[0], cols.shape[0]
    center = _check_gram(rows, cols, center, what)
    if m * n >= 2 ** 31:
        raise ValueError(f"{what}: {m}x{n} block exceeds int32 counts")
    return center


@functools.lru_cache(maxsize=None)
def _multiples(brackets, device):
    """The bracket multiples (lo, hi) as f32 tensors on ``device``, copied
    there once."""
    return tuple(torch.tensor([b[i] for b in brackets], dtype=torch.float32,
                              device=device) for i in (0, 1))


@functools.lru_cache(maxsize=None)
def grid_steps(g, device):
    """0, 1, ..., g as an f32 tensor on ``device``, made there once."""
    return torch.arange(g + 1, dtype=torch.float32, device=device)


def grid_edges(med_prev, hi_bound, brackets, g1):
    """The threshold grids of the grid warm search: for every candidate
    bracket (multiples of ``med_prev``) and the full-range fallback
    [-1e-6 (1 + hi_bound), hi_bound], its g1 + 1 uniform edges, one f32
    tensor of (n_brackets + 1) * (g1 + 1) values, bracket-major, tightest
    first, fallback last. The JAX expression order: w = (hi - lo) / g1, then
    lo + t * w. ``med_prev`` and ``hi_bound`` are 0-d f32 device tensors;
    ``hi_bound`` must bound every entry of D."""
    lo_m, hi_m = _multiples(tuple(brackets), hi_bound.device)
    steps = grid_steps(g1, hi_bound.device)
    lo_f = torch.full((1,), -1e-6, dtype=torch.float32,
                      device=hi_bound.device) * (1.0 + hi_bound)
    lo = torch.cat([lo_m * med_prev, lo_f])
    hi = torch.cat([hi_m * med_prev, hi_bound.reshape(1)])
    # g1 as a tensor: on the card torch multiplies by the reciprocal of a
    # Python divisor, which differs from the division by a rounding where g1
    # is not a power of two (B9's kernel divides).
    w = (hi - lo) / steps[g1]
    return (lo[:, None] + steps[None, :] * w[:, None]).reshape(-1)


def _bracket_ends(med_prev, brackets):
    lo_m, hi_m = _multiples(tuple(brackets), med_prev.device)
    return torch.stack([lo_m * med_prev, hi_m * med_prev], dim=1).reshape(-1)


def fused_bracket_pass_plain(rows, cols, med_prev, center,
                             brackets=DEFAULT_BRACKETS):
    """Kernel B8's plain version: (D [m, n], mm [2] = [-min(min D, 0),
    max D], cnts [2 * n_brackets] int32 at lo * med_prev, hi * med_prev)."""
    D = dist_block_plain(rows, cols, center)
    mm = torch.stack([-torch.clamp(D.min(), max=0.0), D.max()])
    return D, mm, count_le(D, _bracket_ends(med_prev, brackets))


def fused_bracket_grid_pass_plain(rows, cols, med_prev, center, hi_bound,
                                  brackets=DEFAULT_BRACKETS, g1=16):
    """Kernel B9's plain version: (D [m, n], cnts [(n_brackets + 1) *
    (g1 + 1)] int32 at every ``grid_edges`` threshold)."""
    D = dist_block_plain(rows, cols, center)
    return D, count_le(D, grid_edges(med_prev, hi_bound, brackets, g1))


def _launch_bracket(rows, cols, center, med, brackets, hib=None, g1=0):
    """The bracket pass's one launch: B8 where ``hib`` is None, else B9 at
    ``grid_edges(med, hib, brackets, g1)``. Returns (D, mm, cnts, thr),
    thr the thresholds the kernel formed and counted at (mm unset for
    B9)."""
    from .. import _cuda

    rows, cols, center = rows.contiguous(), cols.contiguous(), \
        center.contiguous()
    m, p = rows.shape
    n = cols.shape[0]
    dev = rows.device
    nb = len(brackets)
    nc = 2 * nb if hib is None else (nb + 1) * (g1 + 1)
    lib = _cuda.library().lib
    D = torch.empty(m, n, dtype=torch.float32, device=dev)
    out = torch.empty(2 + 2 * nc, dtype=torch.float32, device=dev)
    mm, cnts, thr = out[:2], out[2:2 + nc].view(torch.int32), out[2 + nc:]
    prep = torch.empty(lib.stein_gram_prep_floats(n, m, p),
                       dtype=torch.float32, device=dev)
    lo, hi = _bracket_arrays(brackets)
    err = lib.stein_bracket_pass(
        rows.data_ptr(), cols.data_ptr(), center.data_ptr(), m, n, p,
        med.data_ptr(), _addr(lo), _addr(hi), nb,
        None if hib is None else hib.data_ptr(), g1, D.data_ptr(),
        cnts.data_ptr(), mm.data_ptr(), thr.data_ptr(), prep.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _cuda.check(err, "bracket_kernel launch")
    return D, mm, cnts, thr


def fused_bracket_pass(rows, cols, med_prev, center,
                       brackets=DEFAULT_BRACKETS):
    """The local half of the sharded warm search's first pass in one kernel
    (B8): the shard's centred [m, n] block of ``rows`` against ``cols``
    about ``center``, its range and its count at every bracket endpoint.
    Returns (D [m, n] f32, mm [2] f32 = [-min(min D, 0), max D], cnts
    [2 * n_brackets] int32), for the caller to pmax and psum before
    ``ops.median.sharded_warm_from_bracket`` refines on D. f32 only; gate
    shapes with ``bracket_pass_fits``."""
    center = _bracket_checks(rows, cols, center, "fused bracket pass")
    med = _scalar_on(med_prev, rows)
    if rows.device.type == "cpu":
        return fused_bracket_pass_plain(rows, cols, med, center, brackets)
    if rows.device.type != "cuda":
        raise ValueError(f"fused bracket pass: no kernel for {rows.device}")
    if len(brackets) > 8:
        raise ValueError("fused bracket pass: the kernel takes <= 8 brackets")
    D, mm, cnts, _ = _launch_bracket(rows, cols, center, med, brackets)
    fused_bracket_pass.launches += 1
    return D, mm, cnts


fused_bracket_pass.launches = 0


def fused_bracket_grid_pass(rows, cols, med_prev, center, hi_bound,
                            brackets=DEFAULT_BRACKETS, g1=16):
    """B8 with the grid search's first round (B9): the same block, counted
    at every ``grid_edges(med_prev, hi_bound, brackets, g1)`` threshold,
    which the kernel forms itself (bitwise those of ``grid_edges``).
    Returns (D [m, n] f32, cnts [(n_brackets + 1) * (g1 + 1)] int32), for
    the caller to psum before ``ops.median.sharded_warm_from_grid``."""
    center = _bracket_checks(rows, cols, center,
                             "fused grid bracket pass")
    med = _scalar_on(med_prev, rows)
    hib = _scalar_on(hi_bound, rows)
    if rows.device.type == "cpu":
        return fused_bracket_grid_pass_plain(rows, cols, med, center, hib,
                                             brackets, g1)
    if rows.device.type != "cuda":
        raise ValueError(f"fused grid bracket pass: no kernel for "
                         f"{rows.device}")
    if (len(brackets) + 1) * (g1 + 1) > 2048 or len(brackets) > 8:
        raise ValueError("fused grid bracket pass: the kernel takes <= 2048 "
                         "thresholds and <= 8 brackets")
    if g1 < 1:
        raise ValueError(f"fused grid bracket pass: g1 must be >= 1 (got "
                         f"{g1})")
    D, _, cnts, _ = _launch_bracket(rows, cols, center, med, brackets, hib,
                                    g1)
    fused_bracket_grid_pass.launches += 1
    return D, cnts


fused_bracket_grid_pass.launches = 0
