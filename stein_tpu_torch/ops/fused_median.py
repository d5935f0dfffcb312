"""Single-kernel warm-median search (kernel B2) and the in-kernel-Gram
medians (kernels B4, B5).

PyTorch counterpart of ``stein_tpu/ops/pallas_median.py`` (the single-device
part: ``fused_block_ok``, ``warm_search_on_value``, ``fused_warm_median_rows``,
``bracket_pass_fits``, ``pallas_dist_block`` (here ``dist_block``) and
``fused_warm_median_from_theta``).

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
writes the centred [m, n] distance block from an f32 dot, tiled over rows,
columns and p, for B2 to search. B5 (``median_kernel`` with a given centre,
replacing ``pallas_median.py:_warm_from_theta_kernel``) computes that block
and the whole warm search in one cooperative launch. Their plain versions
compute the block with a torch matmul; the median then sees D from another
dot order, so B5 against its plain version is bitwise on exact (lattice) D
and within one final bracket interval otherwise.
"""

import ctypes

import torch

from .median import DEFAULT_BRACKETS, QUAD_MIN_TOTAL, _warm_search
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
    ``block_j`` has no counterpart: the CUDA kernel's tiles are its own)."""
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
    out = torch.empty(m, n, dtype=torch.float32, device=rows.device)
    err = _cuda.library().lib.stein_dist_block(
        rows.data_ptr(), cols.data_ptr(), center.data_ptr(), m, n, p,
        out.data_ptr(), torch.cuda.current_stream(rows.device).cuda_stream,
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
    lo, hi = _bracket_arrays(brackets)
    err = _cuda.library().lib.stein_warm_from_theta(
        rows.data_ptr(), cols.data_ptr(), center.data_ptr(), m, n, p,
        med.data_ptr(), (total + 1) // 2, rounds, _addr(lo), _addr(hi),
        len(brackets), log_n(n), out.data_ptr(), dsub.data_ptr(),
        part_counts.data_ptr(), part_range.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _cuda.check(err, "median_kernel (from theta) launch")
    fused_warm_median_from_theta.launches += 1
    return out[0]


fused_warm_median_from_theta.launches = 0
