"""Single-kernel warm-median search (kernel B2).

PyTorch counterpart of ``stein_tpu/ops/pallas_median.py`` (the single-device
part: ``fused_block_ok``, ``warm_search_on_value``, ``fused_warm_median_rows``).

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
