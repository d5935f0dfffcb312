"""The fused small-n SVGD step tail (kernel B1).

PyTorch counterpart of ``stein_tpu/ops/pallas_step.py`` (``fused_step_fits``
and ``fused_warm_step_tail`` with ``gram_in_kernel=True``, the
``step_impl='fused_gram'`` tail): everything after the gradients, namely

  centred Gram -> warm median -> h^2 = med / log n -> K -> K @ (g - tc/h^2)
  and the row sums -> phi -> global-norm clip -> optimizer update.

The CUDA version (``csrc/stein_kernels.cu``) replaces
``stein_tpu/ops/pallas_step.py:_tail_kernel``. The TPU kernel held D and K in
VMEM at once; on the H100 the tail is a chain of four launches on the
current stream (the cooperative median kernel with its Gram stage, the
streaming tile and its reduce that B3 launches too, clip_update) joined by
device-memory scratch, and K never
reaches device memory. What bounds each
stage on the card is in the source's header. The step rule cannot be traced
into a CUDA kernel the way the TPU kernel traced ``gd.update``: the kernel
takes Adam or Adagrad by an integer and refuses every other step rule.
Adam's bias corrections use ``powf``, the ``Adam.update`` form (the JAX
kernel's exp/log form was a Mosaic work-around; the two differ by ~1 ulp).

For a CPU tensor the wrapper runs the plain PyTorch version below; for a
CUDA tensor it launches the kernels or raises.
"""

import ctypes
import functools

import torch

from .fused_median import _addr, _bracket_arrays, _scalar_on
from .median import DEFAULT_BRACKETS, _warm_search
from .optimizers import Adagrad, AdagradState, Adam, AdamState
from .rbf import log_n

_LOG2E_HALF = -1.4426950408889634 / 2.0

# The JAX package's gate for the fused tail (pallas_step.py:53-75), kept as
# it is so throughput_config picks the same configuration in both packages.
# It was calibrated to a 16 MiB/core TPU; the H100 chain holds no [n, n]
# buffer, and retuning the gate for the card is later work.
FUSED_STEP_VMEM_BUDGET = 16_252_928


def fused_step_vmem_bytes(n, p, m):
    """The JAX package's live-buffer estimate behind the gate."""
    m_extra = 0 if m >= n else m
    return 4 * (2 * n * n + m_extra * n + 11 * n * p)


def fused_step_fits(n, p, median_max_rows=512):
    """Whether the fused step tail is selected for this problem size — the
    predicate behind both the SVGDSampler guard and throughput_config."""
    m = min(median_max_rows, n)
    return fused_step_vmem_bytes(n, p, m) <= FUSED_STEP_VMEM_BUDGET


def _plain_tail(theta, grads, theta_sub, med_prev, opt_state, gd,
                max_phi_norm, warm_passes, brackets):
    """The tail in plain PyTorch, the JAX kernel body op for op (torch
    matmuls for the Gram and K @ u)."""
    n = theta.shape[0]
    center = torch.sum(theta, dim=0, keepdim=True) / n
    tc = theta - center
    rsq = torch.sum(tc * tc, dim=1, keepdim=True)
    D = rsq + rsq.reshape(1, n) - 2.0 * torch.matmul(tc, tc.T)
    if theta_sub is None:
        Dsub = D
    else:
        tsub_c = theta_sub - center
        rsq_sub = torch.sum(tsub_c * tsub_c, dim=1, keepdim=True)
        Dsub = (rsq_sub + rsq.reshape(1, n)
                - 2.0 * torch.matmul(tsub_c, tc.T))
    med = _warm_search(Dsub, med_prev, warm_passes, brackets)
    h2 = med / log_n(n)
    K = torch.exp2(D * (_LOG2E_HALF / h2))
    ku = torch.matmul(K, grads - tc / h2)
    ksum = torch.sum(K, dim=1, keepdim=True)
    phi = (ku + ksum * tc / h2) / n
    norm = torch.sqrt(torch.sum(phi * phi))
    phi = phi * (max_phi_norm / torch.clamp(norm, min=max_phi_norm))
    delta, new_state = gd.update(opt_state, phi)
    return theta + delta, new_state, (med, norm, h2)


@functools.lru_cache(maxsize=None)
def _opt_args(gd):
    """(kind, five f32 constants) of the kernel's step rule (gd is a frozen
    dataclass, so the constants are computed once per rule)."""
    def f32(x):
        return torch.tensor(x, dtype=torch.float32).item()

    def one_minus(x):
        return (torch.tensor(1.0) - torch.tensor(x, dtype=torch.float32)).item()

    if type(gd) is Adam:
        consts = (f32(gd.beta_1), one_minus(gd.beta_1), f32(gd.beta_2),
                  one_minus(gd.beta_2), f32(gd.decay))
        return 0, (ctypes.c_float * 5)(*consts)
    return 1, (ctypes.c_float * 5)(f32(gd.alpha), one_minus(gd.alpha))


def _check_state(kind, opt_state, n, p, dev):
    f32 = torch.float32
    mom = (opt_state.mu, opt_state.nu) if kind == 0 else (opt_state.hist,)
    leaves = [(m, f32, (n, p)) for m in mom] + [
        (opt_state.count, torch.int32, ()),
        (opt_state.learning_rate, f32, ())]
    for t, dtype, shape in leaves:
        if (t.dtype != dtype or tuple(t.shape) != shape or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(
                f"fused step: optimizer state leaf {tuple(t.shape)} "
                f"{t.dtype} on {t.device} is not a contiguous {shape} "
                f"{dtype} on {dev}"
            )


def _launch_tail(theta, grads, theta_sub, med, opt_state, gd, max_phi_norm,
                 warm_passes, brackets):
    from .. import _cuda

    lib = _cuda.library().lib
    n, p = theta.shape
    if len(brackets) > 8:
        raise ValueError("fused step: the kernel takes <= 8 brackets")
    rows = theta if theta_sub is None else theta_sub.contiguous()
    m = rows.shape[0]
    dev = theta.device
    kind, consts = _opt_args(gd)
    _check_state(kind, opt_state, n, p, dev)
    blocks = _cuda.median_blocks(p)
    rounds = (warm_passes + 1) // 2

    splits = lib.stein_tile_splits(n, n, p)
    # One f32 scratch buffer, each piece 64-float aligned: dsub, center,
    # per-block column sums, per-block ranges, the column shares' K @ u and
    # row sums, phi, ||phi||^2 partials, [med, h2]; the per-block counts
    # are int32.
    sizes = (m * n, p, blocks * p, 2 * blocks, splits * n * p, splits * n,
             n * p, lib.stein_reduce_blocks(n, p), 2)
    padded = [-(-s // 64) * 64 for s in sizes]
    scratch = torch.empty(sum(padded), dtype=torch.float32, device=dev)
    ptrs, off = [], scratch.data_ptr()
    for s in padded:
        ptrs.append(off)
        off += 4 * s
    (dsub, center, part_center, part_range, part_ku, part_ksum, phi,
     partials, med_h2) = ptrs
    part_counts = torch.empty((1 + rounds) * blocks * 16, dtype=torch.int32,
                              device=dev)

    if kind == 0:
        mom1, mom2 = opt_state.mu, opt_state.nu
    else:
        mom1 = mom2 = opt_state.hist
    new_theta = torch.empty_like(theta)
    new_mom1 = torch.empty_like(mom1)
    new_mom2 = torch.empty_like(mom2) if kind == 0 else new_mom1
    new_count = torch.empty((), dtype=torch.int32, device=dev)
    new_lr = torch.empty((), dtype=torch.float32, device=dev)
    stats = torch.empty(3, dtype=torch.float32, device=dev)
    lo, hi = _bracket_arrays(brackets)
    total = m * n
    err = lib.stein_fused_step_tail(
        theta.data_ptr(), grads.data_ptr(), rows.data_ptr(), n, p, m,
        med.data_ptr(), (total + 1) // 2, rounds,
        _addr(lo), _addr(hi), len(brackets), log_n(n), float(max_phi_norm),
        kind, _addr(consts), mom1.data_ptr(), mom2.data_ptr(),
        opt_state.count.data_ptr(), opt_state.learning_rate.data_ptr(),
        new_theta.data_ptr(), new_mom1.data_ptr(), new_mom2.data_ptr(),
        new_count.data_ptr(), new_lr.data_ptr(), stats.data_ptr(),
        dsub, center, part_center, part_counts.data_ptr(), part_range,
        splits, part_ku, part_ksum, phi, partials, med_h2,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _cuda.check(err, "fused step tail launch")
    if kind == 0:
        new_state = AdamState(new_mom1, new_mom2, new_count, new_lr)
    else:
        new_state = AdagradState(new_mom1, new_count, new_lr)
    return new_theta, new_state, (stats[0], stats[1], stats[2])


def fused_warm_step_tail(theta, grads, D, D_sub, med_prev, opt_state, gd,
                         max_phi_norm=10.0, warm_passes=8,
                         brackets=DEFAULT_BRACKETS, gram_in_kernel=False,
                         theta_sub=None):
    """One step tail. Returns (new_theta, new_opt_state, (med, phi_norm,
    h2)), all on theta's device.

    ``theta``/``grads`` are [n, p] f32; ``theta_sub`` the strided
    subsample rows of theta (ops.median.subsample_rows), or None when every
    row is kept. Only ``gram_in_kernel=True`` is ported (D is computed in
    the kernel, so D and D_sub must be None); ``gd`` is Adam or Adagrad."""
    if not gram_in_kernel:
        raise NotImplementedError(
            "fused_warm_step_tail(gram_in_kernel=False) (step_impl='fused', "
            "D from a separate Gram) is not ported yet; see ROADMAP.md "
            "queue A, item A7"
        )
    if D is not None or D_sub is not None:
        raise ValueError(
            "gram_in_kernel=True computes D inside the kernel; pass "
            "D=None and D_sub=None"
        )
    if type(gd) not in (Adam, Adagrad):
        raise TypeError(
            f"fused step: the kernel implements Adam and Adagrad only, not "
            f"{type(gd).__name__}; use step_impl='xla' for other step rules"
        )
    n, p = theta.shape
    m = n if theta_sub is None else theta_sub.shape[0]
    if m * n >= 2 ** 31:
        raise ValueError("fused step: median block exceeds int32 counts")
    checked = [("theta", theta), ("grads", grads)]
    if theta_sub is not None:
        checked.append(("theta_sub", theta_sub))
    for name, arr in checked:
        if arr.dtype != torch.float32:
            raise TypeError(f"fused step is f32-only (got {name}={arr.dtype})")
        if arr.device != theta.device or arr.shape[-1] != p:
            raise ValueError(f"fused step: {name} must be [*, {p}] on "
                             f"{theta.device}")
    if grads.shape != (n, p):
        raise ValueError(f"fused step: grads shape {tuple(grads.shape)}")
    med = _scalar_on(med_prev, theta)
    if theta.device.type == "cpu":
        return _plain_tail(theta, grads, theta_sub, med, opt_state, gd,
                           max_phi_norm, warm_passes, brackets)
    if theta.device.type != "cuda":
        raise ValueError(f"fused step: no kernel for {theta.device}")
    out = _launch_tail(theta.contiguous(), grads.contiguous(), theta_sub,
                       med, opt_state, gd, max_phi_norm, warm_passes,
                       brackets)
    fused_warm_step_tail.launches += 1
    return out


fused_warm_step_tail.launches = 0
