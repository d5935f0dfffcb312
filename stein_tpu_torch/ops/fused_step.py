"""The fused small-n SVGD step tail (kernel B1), the whole-D tail (B12) and
the large-n epilogue (B6).

PyTorch counterpart of ``stein_tpu/ops/pallas_step.py`` (``fused_step_fits``,
``InKernelModel``, ``fused_warm_step_tail``, ``pblock_step_fits``,
``fused_warm_step_pblock`` and ``fused_epilogue``). The tail
is everything after the gradients:

  [model gradients ->] D -> warm median -> h^2 = med / log n -> K ->
  K @ (g - tc/h^2) and the row sums -> phi -> global-norm clip -> optimizer

with D either the centred Gram computed in the chain (``gram_in_kernel=True``,
step_impl='fused_gram', tc = theta - mean) or given (step_impl='fused', D from
``ops.rbf.pairwise_sq_dists``, tc = theta uncentred, as the JAX kernel has
it), and the gradients either given or computed by an in-kernel model
(step_impl='fused_glm' / 'fused_model').

The CUDA version replaces ``stein_tpu/ops/pallas_step.py:_tail_kernel``. The
TPU kernel held D and K in VMEM at once; on the H100 the tail is a chain of
launches on the current stream joined by device-memory scratch, and K never
reaches device memory: the model stage (``csrc/model_grad.cu``, launched by
its own wrapper in ``ops/model_grad.py``), the cooperative median kernel
(with its Gram stage, or searching the given D's row block), the streaming
tile (B3's, or B10's tile on the given D) and its reduce, clip_update
(``csrc/stein_kernels.cu``). What bounds each stage on the card is in the
sources' headers.

Python cannot be traced into a CUDA kernel the way the TPU kernel traced
``gd.update`` and a model's ``grad_fn``: the kernels take Adam or Adagrad by
an integer and the two model kinds of ``ops/model_grad.py``, and refuse every
other step rule or model with ``TypeError``. Adam's bias corrections use
``powf``, the ``Adam.update`` form (the JAX kernel's exp/log form was a
Mosaic work-around; the two differ by ~1 ulp).

For a CPU tensor a wrapper runs the plain PyTorch version below; for a CUDA
tensor it launches the kernels or raises.
"""

import ctypes
import dataclasses
import functools

import torch

from . import svgd_tile
from .fused_median import _addr, _bracket_arrays, _scalar_on
from .median import DEFAULT_BRACKETS, _warm_search
from .model_grad import KERNEL_MODELS, GlmGrad
from .optimizers import Adagrad, AdagradState, Adam, AdamState
from .rbf import log_n
from .svgd_tile import svgd_both_ksum_on_D

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


@dataclasses.dataclass(frozen=True)
class InKernelModel:
    """A model's gradient stage run inside the fused step
    (step_impl='fused_model'; step_impl='fused_glm' builds one from the
    quadratic form).

    operands : tuple of f32 tensors, each >= 2-D (the JAX protocol's VMEM
        layout rule, kept), on the particles' device; built per batch by
        the model's ``inkernel_model(batch)``.
    grad_fn : one of the model kinds of ``ops/model_grad.py`` (``GlmGrad``,
        ``LogisticGrad``): (theta [n, p], *operands) -> (grads [n, p],
        log_p [n]) with ``const`` left out. Any other callable is refused
        with TypeError: the CUDA chain knows these kinds only.
    const : the parameter-independent part of log_p, added to the mean by
        the caller.
    vmem_bytes : optional callable n -> bytes of the operands and the
        stage's temporaries, for the JAX package's budget gate (default:
        the operands' bytes).
    """
    operands: tuple
    grad_fn: object
    const: float = 0.0
    vmem_bytes: object = None

    def extra_vmem(self, n):
        if self.vmem_bytes is not None:
            return int(self.vmem_bytes(n))
        return int(sum(op.numel() * op.element_size()
                       for op in self.operands))


def _plain_tail(theta, grads, theta_sub, med_prev, opt_state, gd,
                max_phi_norm, warm_passes, brackets, D=None, D_sub=None,
                model=None):
    """The tail in plain PyTorch, the JAX kernel body op for op (torch
    matmuls for the Gram, the model's products and K @ u). With ``model``
    the gradients come from its plain stage and a fourth stat, the mean
    log_p without ``const``, is returned; with ``D`` the median searches
    ``D_sub`` and tc = theta."""
    n = theta.shape[0]
    if model is not None:
        grads, logp = model.grad_fn.plain(theta, *model.operands)
    if D is None:
        center = torch.sum(theta, dim=0, keepdim=True) / n
        tc = theta - center
        rsq = torch.sum(tc * tc, dim=1, keepdim=True)
        D = rsq + rsq.reshape(1, n) - 2.0 * torch.matmul(tc, tc.T)
        if theta_sub is None:
            D_sub = D
        else:
            tsub_c = theta_sub - center
            rsq_sub = torch.sum(tsub_c * tsub_c, dim=1, keepdim=True)
            D_sub = (rsq_sub + rsq.reshape(1, n)
                     - 2.0 * torch.matmul(tsub_c, tc.T))
    else:
        tc = theta
    med = _warm_search(D_sub, med_prev, warm_passes, brackets)
    h2 = med / log_n(n)
    K = torch.exp2(D * (_LOG2E_HALF / h2))
    ku = torch.matmul(K, grads - tc / h2)
    ksum = torch.sum(K, dim=1, keepdim=True)
    phi = (ku + ksum * tc / h2) / n
    norm = torch.sqrt(torch.sum(phi * phi))
    phi = phi * (max_phi_norm / torch.clamp(norm, min=max_phi_norm))
    delta, new_state = gd.update(opt_state, phi)
    stats = (med, norm, h2)
    if model is not None:
        stats += (torch.sum(logp) / n,)
    return theta + delta, new_state, stats


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


def _check_rule(gd, what):
    if type(gd) not in (Adam, Adagrad):
        raise TypeError(
            f"{what}: the kernel implements Adam and Adagrad only, not "
            f"{type(gd).__name__}; use step_impl='xla' for other step rules"
        )


def _check_state(kind, opt_state, n, p, dev, what):
    f32 = torch.float32
    mom = (opt_state.mu, opt_state.nu) if kind == 0 else (opt_state.hist,)
    leaves = [(m, f32, (n, p)) for m in mom] + [
        (opt_state.count, torch.int32, ()),
        (opt_state.learning_rate, f32, ())]
    for t, dtype, shape in leaves:
        if (t.dtype != dtype or tuple(t.shape) != shape or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(
                f"{what}: optimizer state leaf {tuple(t.shape)} "
                f"{t.dtype} on {t.device} is not a contiguous {shape} "
                f"{dtype} on {dev}"
            )


def _opt_buffers(kind, opt_state, like):
    """(inputs mom1, mom2; outputs new_mom1, new_mom2, new_count, new_lr)
    of the update; Adagrad's second moment pointers repeat the first."""
    dev = like.device
    if kind == 0:
        mom1, mom2 = opt_state.mu, opt_state.nu
    else:
        mom1 = mom2 = opt_state.hist
    new_mom1 = torch.empty_like(mom1)
    new_mom2 = torch.empty_like(mom2) if kind == 0 else new_mom1
    new_count = torch.empty((), dtype=torch.int32, device=dev)
    new_lr = torch.empty((), dtype=torch.float32, device=dev)
    return mom1, mom2, new_mom1, new_mom2, new_count, new_lr


def _new_state(kind, new_mom1, new_mom2, new_count, new_lr):
    if kind == 0:
        return AdamState(new_mom1, new_mom2, new_count, new_lr)
    return AdagradState(new_mom1, new_count, new_lr)


def _launch_tail(theta, grads, block, med, opt_state, gd, max_phi_norm,
                 warm_passes, brackets, D=None, logp=None, d_once=False):
    """B1's chain. ``block`` is the median rows of theta (Gram mode) or,
    with ``D``, the row block of D that the median searches. ``d_once``
    (B12, Gram mode with block = theta): the tile is B10's on the median
    kernel's own [n, n] block, so D is computed once."""
    from .. import _cuda

    lib = _cuda.library().lib
    n, p = theta.shape
    if len(brackets) > 8:
        raise ValueError("fused step: the kernel takes <= 8 brackets")
    block = block.contiguous()
    m = block.shape[0]
    dev = theta.device
    kind, consts = _opt_args(gd)
    _check_state(kind, opt_state, n, p, dev, "fused step")
    gram = D is None
    blocks = _cuda.median_blocks(p if gram else 0)
    rounds = (warm_passes + 1) // 2

    # The streaming tile (Gram mode without d_once) on its route; the chain
    # launches the tile itself, so a wide p runs it on mma.sync.
    route = (svgd_tile.tile_route(n, n, p) if gram and not d_once
             else svgd_tile.MMA_SYNC)
    if route == svgd_tile.WIDE:
        route = svgd_tile.MMA_SYNC
    splits = (lib.stein_tile_splits(n, n, p, route) if gram and not d_once
              else lib.stein_on_d_splits(n, n, p))
    # One f32 scratch buffer, each piece 64-float aligned: dsub (the Gram
    # mode's block), center, per-block column sums, per-block ranges, the
    # column shares' K @ u and row sums, phi, ||phi||^2 partials, [med, h2];
    # one buffer for the median kernel's Gram prep (Gram mode), then the
    # tile's prep (Gram mode without d_once) or B10's u; the per-block
    # counts are int32.
    sizes = (m * n if gram else 0, p, blocks * p, 2 * blocks,
             splits * n * p, splits * n, n * p,
             lib.stein_reduce_blocks(n, p), 2,
             max(lib.stein_gram_prep_floats(n, m, p) if gram else 0,
                 lib.stein_tile_prep_floats(n, n, p, route)
                 if gram and not d_once
                 else n * p))
    padded = [-(-s // 64) * 64 for s in sizes]
    scratch = torch.empty(sum(padded), dtype=torch.float32, device=dev)
    ptrs, off = [], scratch.data_ptr()
    for s in padded:
        ptrs.append(off)
        off += 4 * s
    (dsub, center, part_center, part_range, part_ku, part_ksum, phi,
     partials, med_h2, tile_prep) = ptrs
    part_counts = torch.empty((1 + rounds) * blocks * 16, dtype=torch.int32,
                              device=dev)

    mom1, mom2, new_mom1, new_mom2, new_count, new_lr = _opt_buffers(
        kind, opt_state, theta)
    new_theta = torch.empty_like(theta)
    stats = torch.empty(3 if logp is None else 4, dtype=torch.float32,
                        device=dev)
    lo, hi = _bracket_arrays(brackets)
    total = m * n
    err = lib.stein_fused_step_tail(
        theta.data_ptr(), grads.data_ptr(), block.data_ptr(), n, p, m,
        0 if gram else D.data_ptr(), int(d_once),
        med.data_ptr(), (total + 1) // 2, rounds,
        _addr(lo), _addr(hi), len(brackets), log_n(n), float(max_phi_norm),
        kind, _addr(consts), mom1.data_ptr(), mom2.data_ptr(),
        opt_state.count.data_ptr(), opt_state.learning_rate.data_ptr(),
        0 if logp is None else logp.data_ptr(),
        new_theta.data_ptr(), new_mom1.data_ptr(), new_mom2.data_ptr(),
        new_count.data_ptr(), new_lr.data_ptr(), stats.data_ptr(),
        dsub, center, part_center, part_counts.data_ptr(), part_range,
        splits, part_ku, part_ksum, phi, partials, med_h2, tile_prep, route,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _cuda.check(err, "fused step tail launch")
    if route == svgd_tile.WGMMA:
        svgd_tile.svgd_both_ksum.wgmma_launches += 1
    return (new_theta, _new_state(kind, new_mom1, new_mom2, new_count,
                                  new_lr), tuple(stats))


def fused_warm_step_tail(theta, grads, D, D_sub, med_prev, opt_state, gd,
                         max_phi_norm=10.0, warm_passes=8,
                         brackets=DEFAULT_BRACKETS, gram_in_kernel=False,
                         theta_sub=None, glm=None, model=None):
    """One step tail. Returns (new_theta, new_opt_state, (med, phi_norm,
    h2)), all on theta's device; with ``glm``/``model`` a fourth stat, the
    mean log_p without the model's ``const``.

    ``theta``/``grads`` are [n, p] f32; ``gd`` is Adam or Adagrad.
    ``gram_in_kernel=True`` (step_impl='fused_gram'): D=D_sub=None, the
    chain computes the centred D itself; ``theta_sub`` is the strided
    subsample rows of theta (ops.median.subsample_rows), or None when every
    row is kept. ``gram_in_kernel=False`` (step_impl='fused'): ``D`` is the
    full [n, n] squared-distance matrix and ``D_sub`` its strided row block
    (``D_sub is D`` when every row is kept). ``model=InKernelModel(...)``
    (step_impl='fused_model', with gram_in_kernel and grads=None) computes
    the gradients in the chain; ``glm=(A_eff, b_eff)`` (step_impl=
    'fused_glm') is the explicit quadratic's form of it."""
    n, p = theta.shape
    if glm is not None:
        if model is not None:
            raise ValueError("pass glm= or model=, not both")
        A_eff, b_eff = glm
        if tuple(A_eff.shape) != (p, p):
            raise ValueError(f"A_eff shape {tuple(A_eff.shape)} != "
                             f"({p},{p})")
        model = InKernelModel(
            operands=(A_eff.to(torch.float32),
                      b_eff.to(torch.float32).reshape(1, p)),
            grad_fn=GlmGrad(),
        )
    if model is not None and not gram_in_kernel:
        raise ValueError("an in-kernel model requires gram_in_kernel=True")
    if gram_in_kernel:
        if D is not None or D_sub is not None:
            raise ValueError(
                "gram_in_kernel=True computes D inside the kernel; pass "
                "D=None and D_sub=None (got a precomputed D — use "
                "gram_in_kernel=False to keep its numerics)"
            )
        m = n if theta_sub is None else theta_sub.shape[0]
        checked = [("theta", theta)]
        if model is None:
            checked.append(("grads", grads))
        if theta_sub is not None:
            checked.append(("theta_sub", theta_sub))
        if model is not None:
            for i, op in enumerate(model.operands):
                if op.dim() < 2:
                    raise ValueError(
                        f"in-kernel model operand {i} must be >=2-D (got "
                        f"shape {tuple(op.shape)}); reshape rows/scalars "
                        "to [1, k]"
                    )
                checked.append((f"model operand {i}", op))
            extra = model.extra_vmem(n)
            if (fused_step_vmem_bytes(n, p, m) + extra
                    > FUSED_STEP_VMEM_BUDGET):
                raise ValueError(
                    "fused_model: the in-kernel model's operands/"
                    f"temporaries (~{extra / 2**20:.1f} MiB) push the "
                    "fused step past the JAX package's VMEM budget; shrink "
                    "the data batch or use step_impl='fused_gram'"
                )
    else:
        if theta_sub is not None:
            raise ValueError(
                "theta_sub is only consumed when gram_in_kernel=True; "
                "with a precomputed D pass its subsample as D_sub"
            )
        if D is None or D_sub is None:
            raise ValueError("gram_in_kernel=False searches a given D: pass "
                             "D and its row block D_sub")
        m = D_sub.shape[0]
        checked = [("theta", theta), ("grads", grads), ("D", D),
                   ("D_sub", D_sub)]
        if tuple(D.shape) != (n, n) or D_sub.shape[1] != n:
            raise ValueError(f"fused step: D {tuple(D.shape)} / D_sub "
                             f"{tuple(D_sub.shape)} are not [n, n] / [m, n]")
    if m * n >= 2 ** 31:
        raise ValueError("fused step: median block exceeds int32 counts")
    for name, arr in checked:
        if arr.dtype != torch.float32:
            raise TypeError(f"fused step is f32-only (got {name}={arr.dtype})")
        if arr.device != theta.device:
            raise ValueError(f"fused step: {name} must lie on {theta.device}")
    _check_rule(gd, "fused step")
    if model is not None and type(model.grad_fn) not in KERNEL_MODELS:
        raise TypeError(
            "fused step: the kernel chain runs the explicit quadratic "
            "(GlmGrad) and the logistic model (LogisticGrad) only, not "
            f"{type(model.grad_fn).__name__}; use step_impl='fused_gram' "
            "with autodiff gradients for other models"
        )
    if model is None and grads.shape != (n, p):
        raise ValueError(f"fused step: grads shape {tuple(grads.shape)}")
    if theta_sub is not None and theta_sub.shape[1] != p:
        raise ValueError(f"fused step: theta_sub must be [*, {p}]")
    med = _scalar_on(med_prev, theta)
    if theta.device.type == "cpu":
        return _plain_tail(theta, grads, theta_sub, med, opt_state, gd,
                           max_phi_norm, warm_passes, brackets, D=D,
                           D_sub=D_sub, model=model)
    if theta.device.type != "cuda":
        raise ValueError(f"fused step: no kernel for {theta.device}")
    theta = theta.contiguous()
    logp = None
    if model is not None:
        grads, logp = model.grad_fn(theta, *model.operands)
    if gram_in_kernel:
        block = theta if theta_sub is None else theta_sub
    else:
        block = D_sub
    out = _launch_tail(theta, grads.contiguous(), block, med, opt_state, gd,
                       max_phi_norm, warm_passes, brackets,
                       D=None if gram_in_kernel else D.contiguous(),
                       logp=logp)
    fused_warm_step_tail.launches += 1
    if not gram_in_kernel:
        # The D-given chain runs B10's tile on D (csrc/svgd_on_d.cu).
        svgd_both_ksum_on_D.launches += 1
    return out


fused_warm_step_tail.launches = 0


def pblock_step_fits(n, p, p_tile=128):
    """The JAX package's gate for its p-blocked tail (pallas_step.py:
    770-774), kept as it is: the TPU kernel's [n, n] D/K scratch, the
    [n, p] phi scratch and ~6 [n, p_tile] tile buffers within ~12 MiB of
    VMEM. The H100 chain has no such limit; the gate says which shapes the
    JAX package's kernel takes."""
    return 4 * (n * n + n * p + 6 * n * p_tile) <= 12 * 2 ** 20


def fused_warm_step_pblock(theta, grads, med_prev, opt_state, gd,
                           max_phi_norm=10.0, warm_passes=8,
                           brackets=DEFAULT_BRACKETS, p_tile=128):
    """The whole step tail over the full [n, n] D (kernel B12, the
    counterpart of ``stein_tpu/ops/pallas_step.py:fused_warm_step_pblock``).
    Returns (new_theta, new_opt_state, (med, phi_norm, h2)).

    D is the centred Gram of theta about its column mean; the median counts
    run over all n^2 entries (k = (n^2 + 1) // 2, no row subsample; med_prev
    <= 0 is the cold search); h^2 = med / log n; K = exp2(D (-log2e/2 /
    h^2)); phi = (K @ (g - tc/h^2) + ksum tc / h^2) / n, clipped to norm
    ``max_phi_norm``; then Adam's or Adagrad's update. f32 only.

    The TPU kernel streamed [n, p_tile] tiles through VMEM around a resident
    [n, n] D/K scratch; the p-tiling does not carry over (``p_tile`` is
    accepted for parity, a positive int as the JAX function needs, and has
    no counterpart). What does carry over is
    that D is computed once: the CUDA chain is B1's cooperative median
    kernel with its Gram stage writing the whole [n, n] D (4 MB at n=1000,
    L2-resident) and searching it, B10's tile on that D with u = g - (theta
    - c) / h^2 formed in-kernel, B3's fixed-order reduce, and clip_update
    (csrc/stein_kernels.cu). Adam's bias corrections use ``powf`` (the
    JAX kernel's exp/log form, ``update_kernel``, is ~1 ulp away). The
    plain version is ``_plain_tail`` with every row kept."""
    n, p = theta.shape
    if int(p_tile) < 1:
        raise ValueError(f"fused pblock step: p_tile must be positive (got "
                         f"{p_tile}; it is accepted for parity with the JAX "
                         "function and does not change the CUDA chain)")
    for name, arr in (("theta", theta), ("grads", grads)):
        if arr.dtype != torch.float32:
            raise TypeError(f"fused pblock step is f32-only (got "
                            f"{name}={arr.dtype})")
    if n * n >= 2 ** 31:
        raise ValueError("fused pblock step: n^2 exceeds int32 counts")
    for leaf in opt_state:
        if leaf.dim() != 0 and tuple(leaf.shape) != (n, p):
            raise ValueError(
                "fused pblock step supports optimizer states whose array "
                f"leaves are [n, p]; got {tuple(leaf.shape)}"
            )
    _check_rule(gd, "fused pblock step")
    if tuple(grads.shape) != (n, p) or grads.device != theta.device:
        raise ValueError(f"fused pblock step: grads must be {(n, p)} on "
                         f"{theta.device}")
    med = _scalar_on(med_prev, theta)
    if theta.device.type == "cpu":
        return _plain_tail(theta, grads, None, med, opt_state, gd,
                           max_phi_norm, warm_passes, brackets)
    if theta.device.type != "cuda":
        raise ValueError(f"fused pblock step: no kernel for {theta.device}")
    theta = theta.contiguous()
    out = _launch_tail(theta, grads.contiguous(), theta, med, opt_state, gd,
                       max_phi_norm, warm_passes, brackets, d_once=True)
    fused_warm_step_pblock.launches += 1
    return out


fused_warm_step_pblock.launches = 0


def fused_epilogue_plain(ku, ksum, theta, center, h2, norm, opt_state, gd,
                         max_phi_norm=10.0, n_total=None):
    """Kernel B6's plain version: the JAX kernel body on the whole array."""
    if n_total is None:
        n_total = theta.shape[0]
    phi = (ku + ksum * (theta - center) / h2) / n_total
    phi = phi * (max_phi_norm / torch.clamp(norm, min=max_phi_norm))
    delta, new_state = gd.update(opt_state, phi)
    return theta + delta, new_state


def fused_epilogue(ku, ksum, theta, center, h2, norm, opt_state, gd,
                   max_phi_norm=10.0, n_total=None):
    """The large-n step epilogue (step_impl='epilogue') in one launch: the
    phi combine ``(ku + ksum * (theta - center) / h2) / n_total``, the
    global-norm clip by the given pre-clip ``norm`` (a device scalar, the
    caller's one reduction over the same combine) and the Adam or Adagrad
    update. Returns (new_theta, new_opt_state). f32 only.

    The CUDA kernel (``csrc/stein_kernels.cu``, epilogue_kernel) replaces
    ``stein_tpu/ops/pallas_step.py:_epilogue_kernel``: one thread per
    coordinate, the update through the device function clip_update_kernel
    uses, block 0 writing the new count and learning rate to their own
    buffers. The JAX function's ``block_rows`` has no counterpart."""
    n, p = theta.shape
    if n_total is None:
        n_total = n
    center = center.reshape(1, p)
    ksum = ksum.reshape(n, 1)
    for name, arr, shape in (("ku", ku, (n, p)), ("ksum", ksum, (n, 1)),
                             ("theta", theta, (n, p)),
                             ("center", center, (1, p))):
        if arr.dtype != torch.float32:
            raise TypeError(f"fused epilogue is f32-only (got "
                            f"{name}={arr.dtype})")
        if tuple(arr.shape) != shape or arr.device != theta.device:
            raise ValueError(f"fused epilogue: {name} must be {shape} on "
                             f"{theta.device}")
    _check_rule(gd, "fused epilogue")
    h2 = _scalar_on(h2, theta)
    norm = _scalar_on(norm, theta)
    if theta.device.type == "cpu":
        return fused_epilogue_plain(ku, ksum, theta, center, h2, norm,
                                    opt_state, gd, max_phi_norm, n_total)
    if theta.device.type != "cuda":
        raise ValueError(f"fused epilogue: no kernel for {theta.device}")
    from .. import _cuda

    kind, consts = _opt_args(gd)
    _check_state(kind, opt_state, n, p, theta.device, "fused epilogue")
    theta, ku, ksum, center = (t.contiguous() for t in
                               (theta, ku, ksum, center))
    mom1, mom2, new_mom1, new_mom2, new_count, new_lr = _opt_buffers(
        kind, opt_state, theta)
    new_theta = torch.empty_like(theta)
    err = _cuda.library().lib.stein_fused_epilogue(
        ku.data_ptr(), ksum.data_ptr(), theta.data_ptr(), center.data_ptr(),
        h2.data_ptr(), norm.data_ptr(), n, p, float(n_total),
        float(max_phi_norm), kind, _addr(consts), mom1.data_ptr(),
        mom2.data_ptr(), opt_state.count.data_ptr(),
        opt_state.learning_rate.data_ptr(), new_theta.data_ptr(),
        new_mom1.data_ptr(), new_mom2.data_ptr(), new_count.data_ptr(),
        new_lr.data_ptr(), torch.cuda.current_stream(theta.device).cuda_stream,
    )
    _cuda.check(err, "epilogue_kernel launch")
    fused_epilogue.launches += 1
    return new_theta, _new_state(kind, new_mom1, new_mom2, new_count,
                                 new_lr)


fused_epilogue.launches = 0
