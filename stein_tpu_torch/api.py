"""Public SVGD sampler API, in PyTorch.

Counterpart of ``stein_tpu/api.py`` for one device (a CPU, or a CUDA card
through the hand-written kernels of ``csrc/``). The step is the same as the
JAX package's: per-particle gradients by ``torch.func`` (vmap of
grad_and_value) or by a model's own gradient kernel (``custom_grads=``),
the median bandwidth, the RBF kernel and SVGD direction, the global norm
clip and the optimizer update. JAX's ``run`` is one ``lax.scan`` dispatch;
here it is a Python loop that keeps every carried scalar (median, h^2, clip
norm, Adam's count and learning rate) on the device and never reads one on
the host.

Ported: the reference path (``step_impl='xla'``, ``median`` in
{'exact', 'bisect'}, the warm median, ``median_impl`` in {'xla', 'fused',
'fused_gram'}), the streaming tile (``kernel_impl='pallas'``, at either
``pallas_precision``), every
single-device step tail (``step_impl`` 'fused', 'fused_gram', 'fused_glm',
'fused_model' and 'epilogue'), ``custom_grads=``, ``remat=``, ``kernel=``
(``kernels/``), the 1-D particle mesh (``mesh=``, ``parallel/``: the mesh
steps and ``step_impl='fused_shard'``), and every method of the JAX
sampler: ``run``, ``train_on_batch``, ``train_on_batches``,
``train_minibatched``, ``function_posterior``, ``ksd``, ``save`` and
``restore``. Every other option raises ``NotImplementedError`` naming the
ROADMAP.md item that will port it.
"""

import functools
import warnings
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.utils.checkpoint
from torch.func import grad, grad_and_value, vmap

from . import _device
from .kernels import SquaredExponentialKernel, generic_svgd_phi
from .ops import rbf, svgd_tile
from .ops.diagnostics import ksd_rbf
from .ops.fused_median import (
    bracket_pass_fits,
    dist_block,
    fused_block_ok,
    fused_warm_median_from_theta,
    fused_warm_median_rows,
)
from .ops.fused_step import (
    FUSED_STEP_VMEM_BUDGET,
    InKernelModel,
    fused_epilogue,
    fused_step_fits,
    fused_step_vmem_bytes,
    fused_warm_step_tail,
)
from .ops.median import (
    QUAD_MIN_TOTAL,
    _strided_rows,
    _warm_search,
    bisect_median,
    bisect_median_on_D,
    exact_median,
    row_subsample_block,
    subsample_rows,
)
from .parallel import collectives as coll
from .parallel.mesh import ParticleMesh
from .utils.ravel import (
    init_particles,
    ravel_particles,
    template_unraveler,
    unravel_particles,
)

# Single-device median='exact' footprint above which the constructor warns
# (2^27 B = 128 MB -> n > 5792 in f32), as in the JAX package.
EXACT_MEDIAN_WARN_BYTES = 2 ** 27

_FUSED_STEP_IMPLS = ("fused", "fused_gram", "fused_glm", "fused_model")
_STEP_IMPLS = ("xla", "epilogue") + _FUSED_STEP_IMPLS


def _unported(what, item):
    return NotImplementedError(
        f"{what} is not ported to stein_tpu_torch yet; see ROADMAP.md "
        f"queue A, item {item}"
    )


class SVGDState(NamedTuple):
    """Complete mutable state of the sampler."""

    particles: torch.Tensor  # [n_particles, n_params]
    opt_state: Any           # optimizer state (ops/optimizers.py)
    step: torch.Tensor       # 0-d int32


def _make_grad_all(log_p, unravel_fn, custom_grads=None, remat=False):
    """vmap(grad_and_value) over flat particle rows; returns
    grad_all(theta, batch) -> (log_p values [n], grads [n, p]).
    ``custom_grads`` (a callable of that signature, e.g.
    BayesianNNModel.pallas_grads()) replaces the autodiff stage.

    ``remat=True`` recomputes log_p's forward in the backward instead of
    keeping its activations (``stein_tpu/api.py:418``, jax.checkpoint).
    torch.func's transforms refuse saved-tensor hooks, so
    torch.utils.checkpoint cannot sit inside grad_and_value: the vmapped
    forward runs inside the checkpoint on a leaf copy of theta, and
    torch.autograd takes the gradient of the sum of the values. The rows
    are independent, so that gradient is each row's own."""
    if custom_grads is not None:
        if remat:
            raise ValueError(
                "custom_grads= supplies its own gradient computation; "
                "remat=True (checkpointed autodiff) does not apply; drop "
                "one of the two"
            )
        return custom_grads

    def log_p_flat(theta_row, batch):
        return log_p(unravel_fn(theta_row), batch)

    if remat:
        forward = vmap(log_p_flat, in_dims=(0, None))

        def grad_all(theta, batch):
            with torch.enable_grad():
                leaf = theta.detach().requires_grad_()
                values = torch.utils.checkpoint.checkpoint(
                    forward, leaf, batch, use_reentrant=False)
                grads, = torch.autograd.grad(values.sum(), leaf)
            return values.detach(), grads

        return grad_all

    both = vmap(grad_and_value(log_p_flat), in_dims=(0, None))

    def grad_all(theta, batch):
        grads, values = both(theta, batch)
        return values, grads

    return grad_all


def _clip(phi, norm, max_phi_norm):
    """Global norm clip phi *= c / max(c, ||phi||_F)
    (abstract_stein_sampler.py:125)."""
    return phi * (max_phi_norm / torch.clamp(norm, min=max_phi_norm))


def _gram_in_kernel_med(theta, med_prev, passes, median_max_rows, center):
    """median_impl='fused_gram': the median block's Gram in a kernel too.
    Gram and search in one launch (kernel B5) where bracket_pass_fits
    admits the block, else the block by kernel B4 searched by kernel B2;
    None below the quad-ary regime or outside both gates (the caller then
    takes the matmul-Gram path)."""
    n, p = theta.shape
    rows = subsample_rows(theta, median_max_rows)
    if rows is None:
        rows = theta
    m = rows.shape[0]
    if m * n <= QUAD_MIN_TOTAL:
        return None
    if bracket_pass_fits(m, n, p):
        return fused_warm_median_from_theta(rows, theta, med_prev, center,
                                            warm_passes=passes)
    if fused_block_ok(m, n):
        return fused_warm_median_rows(dist_block(rows, theta, center),
                                      med_prev, warm_passes=passes)
    return None


def _pallas_only_bisect(median):
    if median == "exact":
        raise ValueError(
            "kernel_impl='pallas' streams the kernel matrix precisely to "
            "avoid materialising the n^2 distance matrix, but "
            "median='exact' would materialise it anyway; use "
            "median='bisect' or kernel_impl='xla'"
        )


def make_phi_fn(n_particles, median="exact", kernel_impl="xla",
                median_max_rows=512, median_passes=30, median_impl="xla",
                pallas_precision="f32", kernel=None):
    """Build phi_fn(theta, grads) -> (phi, aux), the cold step's phi.
    ``median_impl='fused'`` runs the cold bisect search as kernel B2 where
    the block is in its envelope (ops.fused_median.fused_block_ok);
    ``'fused_gram'`` computes the block's Gram in a kernel too (B5, or
    B4 then B2). ``kernel_impl='pallas'`` is the streaming tile (B3), its
    products at ``pallas_precision`` ('f32' or 'bf16' operands). A
    ``kernel`` (``kernels/``) other than exactly SquaredExponentialKernel
    takes the generic two-matrix path (``kernels.generic_svgd_phi``): a
    subclass may override ``weights()``, so only the exact class takes
    the fused RBF paths (``stein_tpu/api.py:184-207``)."""
    if median_impl not in ("xla", "fused", "fused_gram"):
        raise ValueError(f"unknown median_impl: {median_impl!r}")
    if kernel_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown kernel_impl: {kernel_impl!r}")
    if median in ("subsample", "binned"):
        raise _unported(f"median={median!r}", "A5")
    if median not in ("exact", "bisect"):
        raise ValueError(f"unknown median mode: {median!r}")

    def fused_cold_or_none(D_sub):
        if median_impl != "xla" and fused_block_ok(*D_sub.shape):
            return fused_warm_median_rows(D_sub, 0.0,
                                          warm_passes=median_passes)
        return None

    def bisect_on_D(D):
        med = fused_cold_or_none(_strided_rows(D, median_max_rows))
        if med is not None:
            return med
        return bisect_median_on_D(D, max_rows=median_max_rows,
                                  passes=median_passes)

    if kernel is not None and type(kernel) is not SquaredExponentialKernel:
        if kernel_impl != "xla":
            raise ValueError(
                "kernel_impl='pallas' supports only the RBF kernel; use "
                "kernel_impl='xla' for custom kernels"
            )
        if median == "bisect":
            return lambda theta, grads: generic_svgd_phi(
                kernel, theta, grads, median_fn=bisect_on_D)

        def generic_exact(theta, grads):
            med = exact_median(rbf.pairwise_sq_dists(theta))
            return generic_svgd_phi(kernel, theta, grads,
                                    median_fn=lambda D: med)
        return generic_exact

    if kernel_impl == "xla":
        if median == "exact":
            return lambda theta, grads: rbf.svgd_phi(
                theta, grads, median_fn=exact_median
            )
        return lambda theta, grads: rbf.svgd_phi(theta, grads,
                                                 median_fn=bisect_on_D)

    _pallas_only_bisect(median)

    def median_fn(theta, center):
        if median_impl == "fused_gram":
            med = _gram_in_kernel_med(theta, 0.0, median_passes,
                                      median_max_rows, center)
            if med is not None:
                return med
        med = fused_cold_or_none(row_subsample_block(theta, median_max_rows))
        if med is not None:
            return med
        return bisect_median(theta, max_rows=median_max_rows,
                             passes=median_passes)

    def phi_fn(theta, grads):
        center = svgd_tile.column_center(theta)
        med = median_fn(theta, center)
        h2 = rbf.bandwidth_sq_from_median(med, n_particles)
        phi = svgd_tile.svgd_phi(theta, grads, h2, center=center,
                                 precision=pallas_precision)
        return phi, {"h2": h2, "median": med}

    return phi_fn


def _make_warm_median_fns(median_max_rows=512, median_passes=30,
                          warm_passes=8, median_impl="xla"):
    """The carried warm-median machinery: returns
    (compute_med(theta, med_prev, center), init_med(theta),
    warm_med_on_block(D_sub, med_prev)). ``center`` is the particle mean,
    read by median_impl='fused_gram' only."""
    if median_impl not in ("xla", "fused", "fused_gram"):
        raise ValueError(f"unknown median_impl: {median_impl!r}")

    def use_fused(D_sub):
        return median_impl != "xla" and fused_block_ok(*D_sub.shape)

    def warm_med_on_block(D_sub, med_prev):
        if use_fused(D_sub):
            return fused_warm_median_rows(D_sub, med_prev,
                                          warm_passes=warm_passes)
        return _warm_search(D_sub, med_prev, warm_passes)

    def compute_med(theta, med_prev, center):
        if median_impl == "fused_gram":
            med = _gram_in_kernel_med(theta, med_prev, warm_passes,
                                      median_max_rows, center)
            if med is not None:
                return med
        return warm_med_on_block(row_subsample_block(theta, median_max_rows),
                                 med_prev)

    def init_med(theta):
        """The cold seed of the carry: the same searches with no hint."""
        if median_impl == "fused_gram":
            med = _gram_in_kernel_med(theta, 0.0, median_passes,
                                      median_max_rows,
                                      svgd_tile.column_center(theta))
            if med is not None:
                return med
        D_sub = row_subsample_block(theta, median_max_rows)
        if use_fused(D_sub):
            return fused_warm_median_rows(D_sub, 0.0,
                                          warm_passes=median_passes)
        return bisect_median(theta, max_rows=median_max_rows,
                             passes=median_passes)

    return compute_med, init_med, warm_med_on_block


def make_warm_phi_fn(n_particles, kernel_impl="xla", median_max_rows=512,
                     median_passes=30, warm_passes=8, median_impl="xla",
                     pallas_precision="f32"):
    """phi_fn(theta, grads, med_prev) -> (phi, aux) threading the previous
    step's median; aux['median'] is the next step's hint. Carries
    ``init_med(theta)`` for the cold seed. ``pallas_precision`` is the
    streaming tile's (kernel_impl='pallas')."""
    if kernel_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown kernel_impl: {kernel_impl!r}")
    compute_med, init_med, warm_med_on_block = _make_warm_median_fns(
        median_max_rows, median_passes, warm_passes, median_impl)

    if kernel_impl == "pallas":
        def phi_fn(theta, grads, med_prev):
            center = svgd_tile.column_center(theta)
            med = compute_med(theta, med_prev, center)
            h2 = rbf.bandwidth_sq_from_median(med, n_particles)
            phi = svgd_tile.svgd_phi(theta, grads, h2, center=center,
                                     precision=pallas_precision)
            return phi, {"h2": h2, "median": med}
    else:
        def phi_fn(theta, grads, med_prev):
            return rbf.svgd_phi(
                theta, grads,
                median_fn=lambda D: warm_med_on_block(
                    _strided_rows(D, median_max_rows), med_prev),
            )

    phi_fn.init_med = init_med
    return phi_fn


def make_step_fn(log_p, unravel_fn, gd, phi_fn, max_phi_norm=10.0,
                 custom_grads=None, remat=False):
    """The SVGD step: (state, batch) -> (state, aux)."""
    grad_all = _make_grad_all(log_p, unravel_fn, custom_grads=custom_grads,
                              remat=remat)

    def step_fn(state, batch):
        theta = state.particles
        log_p_vals, grads = grad_all(theta, batch)
        phi, kaux = phi_fn(theta, grads)
        norm = torch.sqrt(torch.sum(phi * phi))
        delta, opt_state = gd.update(state.opt_state,
                                     _clip(phi, norm, max_phi_norm))
        new_state = SVGDState(theta + delta, opt_state, state.step + 1)
        return new_state, {"phi_norm": norm,
                           "log_p_mean": torch.mean(log_p_vals), **kaux}

    return step_fn


def make_warm_step_fn(log_p, unravel_fn, gd, warm_phi_fn,
                      max_phi_norm=10.0, custom_grads=None, remat=False):
    """Warm-median step; the carry is (SVGDState, med_prev)."""
    grad_all = _make_grad_all(log_p, unravel_fn, custom_grads=custom_grads,
                              remat=remat)

    def step_fn(carry, batch):
        state, med_prev = carry
        theta = state.particles
        log_p_vals, grads = grad_all(theta, batch)
        phi, kaux = warm_phi_fn(theta, grads, med_prev)
        norm = torch.sqrt(torch.sum(phi * phi))
        delta, opt_state = gd.update(state.opt_state,
                                     _clip(phi, norm, max_phi_norm))
        new_state = SVGDState(theta + delta, opt_state, state.step + 1)
        aux = {"phi_norm": norm, "log_p_mean": torch.mean(log_p_vals),
               **kaux}
        return (new_state, kaux["median"]), aux

    return step_fn


def make_fused_warm_step_fn(log_p, unravel_fn, gd, max_phi_norm=10.0,
                            median_max_rows=512, median_passes=30,
                            warm_passes=8, gram_in_kernel=False,
                            quadratic_form=None, inkernel_model=None,
                            remat=False):
    """Warm step whose post-gradient tail is kernel B1
    (ops.fused_step.fused_warm_step_tail). ``gram_in_kernel=True``
    (step_impl='fused_gram') computes D in the chain; False
    (step_impl='fused') hands it D = pairwise_sq_dists(theta), an f32
    torch matmul as the JAX package leaves it to XLA, and its strided row
    block. ``quadratic_form`` (step_impl='fused_glm') or ``inkernel_model``
    (step_impl='fused_model') computes the gradients and log_p values in
    the chain too; log_p_mean is then its mean plus the model's const.
    Returns (step_fn, init_med) with make_warm_step_fn's carry."""
    grad_all = _make_grad_all(log_p, unravel_fn, remat=remat)

    def step_fn(carry, batch):
        state, med_prev = carry
        theta = state.particles
        tail = functools.partial(
            fused_warm_step_tail, med_prev=med_prev,
            opt_state=state.opt_state, gd=gd, max_phi_norm=max_phi_norm,
            warm_passes=warm_passes)
        if quadratic_form is not None or inkernel_model is not None:
            if quadratic_form is not None:
                A_eff, b_eff, const = quadratic_form(batch)
                kernel_kw = {"glm": (A_eff, b_eff)}
            else:
                m = inkernel_model(batch)
                const, kernel_kw = m.const, {"model": m}
            new_theta, new_opt, (med, norm, h2, logp_m) = tail(
                theta, None, None, None, gram_in_kernel=True,
                theta_sub=subsample_rows(theta, median_max_rows),
                **kernel_kw)
            log_p_mean = logp_m + const
        else:
            log_p_vals, grads = grad_all(theta, batch)
            log_p_mean = torch.mean(log_p_vals)
            if gram_in_kernel:
                new_theta, new_opt, (med, norm, h2) = tail(
                    theta, grads, None, None, gram_in_kernel=True,
                    theta_sub=subsample_rows(theta, median_max_rows))
            else:
                D = rbf.pairwise_sq_dists(theta)
                new_theta, new_opt, (med, norm, h2) = tail(
                    theta, grads, D, _strided_rows(D, median_max_rows))
        new_state = SVGDState(new_theta, new_opt, state.step + 1)
        aux = {"phi_norm": norm, "log_p_mean": log_p_mean, "h2": h2,
               "median": med}
        return (new_state, med), aux

    return step_fn, _make_warm_median_fns(median_max_rows, median_passes,
                                          warm_passes, "fused")[1]


def make_epilogue_warm_step_fn(log_p, unravel_fn, gd, n_particles,
                               max_phi_norm=10.0, median_max_rows=512,
                               median_passes=30, warm_passes=8,
                               median_impl="xla", remat=False):
    """Warm step of the large-n streaming-tile path whose tail — the phi
    combine, the global-norm clip and the optimizer update — is kernel B6
    (ops.fused_step.fused_epilogue): step_impl='epilogue'. The tile (B3)
    and the warm median are the plain kernel_impl='pallas' path's; the
    clip norm is one plain reduction over the same combine, and the same
    centre (the column mean) feeds the tile, the norm and B6. Returns
    (step_fn, init_med) with make_warm_step_fn's carry."""
    compute_med, init_med, _ = _make_warm_median_fns(
        median_max_rows, median_passes, warm_passes, median_impl)
    grad_all = _make_grad_all(log_p, unravel_fn, remat=remat)

    def step_fn(carry, batch):
        state, med_prev = carry
        theta = state.particles
        log_p_vals, grads = grad_all(theta, batch)
        center = svgd_tile.column_center(theta)
        med = compute_med(theta, med_prev, center)
        h2 = rbf.bandwidth_sq_from_median(med, n_particles)
        ku, ksum = svgd_tile.svgd_both_ksum(theta, theta, grads, h2, center)
        phi_v = (ku + ksum * (theta - center) / h2) / n_particles
        norm = torch.sqrt(torch.sum(phi_v * phi_v))
        new_theta, new_opt = fused_epilogue(
            ku, ksum, theta, center, h2, norm, state.opt_state, gd,
            max_phi_norm=max_phi_norm, n_total=n_particles)
        new_state = SVGDState(new_theta, new_opt, state.step + 1)
        aux = {"phi_norm": norm, "log_p_mean": torch.mean(log_p_vals),
               "h2": h2, "median": med}
        return (new_state, med), aux

    return step_fn, init_med


def _shape(x):
    """Shape of a tensor or of any array-like (np.shape: None is ())."""
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


def _probe_device(probe_batch):
    """Where the probe's particles go: the probe batch's device (its first
    tensor), else the default device of the port (the current card)."""
    leaves = _tensor_leaves(probe_batch)
    if leaves:
        return leaves[0].device
    return _device.resolve_device(None, "throughput_config(probe_batch=)")


def _probe_model_hooks(model, n_particles, n_params, probe_batch):
    """throughput_config's check of a model's fused-step hook
    (``stein_tpu/api.py:680``): call the selected hook (``quadratic_form``
    wins, as in the selection) once on ``probe_batch`` and check its
    contract shapes, so a wrong hook fails here with a readable
    ValueError. The JAX package shape-traces the InKernelModel's grad_fn
    with jax.eval_shape; here it is called once on zeros of [n, p] on the
    operands' device, so on a card it launches its kernel (the port's
    contract: (grads [n, p], log_p [n]))."""
    p = n_params
    if hasattr(model, "quadratic_form"):
        try:
            A_eff, b_eff, const = model.quadratic_form(probe_batch)
        except Exception as e:
            raise ValueError(
                "throughput_config probe: model.quadratic_form(probe_batch) "
                f"raised {type(e).__name__}: {e} — the fused_glm step would "
                "fail at its first step; fix the hook or drop model="
            ) from e
        a_shape, b_shape = _shape(A_eff), _shape(b_eff)
        if a_shape != (p, p) or int(np.prod(b_shape)) != p:
            raise ValueError(
                "throughput_config probe: quadratic_form must return "
                f"(A_eff [p, p], b_eff [p], const) for p={p}; got "
                f"A_eff {a_shape}, b_eff {b_shape}"
            )
        return
    try:
        m = model.inkernel_model(probe_batch)
    except Exception as e:
        raise ValueError(
            "throughput_config probe: model.inkernel_model(probe_batch) "
            f"raised {type(e).__name__}: {e} — the fused_model step would "
            "fail at its first step; fix the hook or drop model="
        ) from e
    if not isinstance(m, InKernelModel):
        raise ValueError(
            "throughput_config probe: inkernel_model must return an "
            f"ops.fused_step.InKernelModel, got {type(m).__name__}"
        )
    for i, op in enumerate(m.operands):
        if op.dim() < 2:
            raise ValueError(
                f"throughput_config probe: in-kernel model operand {i} "
                f"must be >=2-D (the JAX protocol's layout rule; got shape "
                f"{tuple(op.shape)}); reshape rows/scalars to [1, k]"
            )
    dev = m.operands[0].device if m.operands else _probe_device(probe_batch)
    theta = torch.zeros(n_particles, p, dtype=torch.float32, device=dev)
    try:
        g, lp = m.grad_fn(theta, *m.operands)
    except Exception as e:
        raise ValueError(
            "throughput_config probe: the InKernelModel's grad_fn failed "
            f"on [{n_particles}, {p}] particles ({type(e).__name__}: {e}) "
            "— it would fail inside the fused step"
        ) from e
    if _shape(g) != (n_particles, p):
        raise ValueError(
            "throughput_config probe: grad_fn must return "
            f"(grads [{n_particles}, {p}], log_p [{n_particles}]); got "
            f"grads {_shape(g)}"
        )
    if _shape(lp) != (n_particles,):
        raise ValueError(
            "throughput_config probe: grad_fn's second return (log_p) "
            f"must be [{n_particles}]; got shape {_shape(lp)}"
        )


def _probe_custom_grads(hook, n_particles, n_params, probe_batch):
    """throughput_config's check of a custom_grads hook (e.g.
    BayesianNNModel.pallas_grads(); ``stein_tpu/api.py:763``): the JAX
    package shape-traces it with jax.eval_shape; here it is called once on
    zeros of [n, p] on the probe batch's device (on a card the hook's
    kernel launches once). Contract: (theta [n, p], batch) ->
    (logp_vals [n], grads [n, p])."""
    theta = torch.zeros(n_particles, n_params, dtype=torch.float32,
                        device=_probe_device(probe_batch))
    try:
        lp, g = hook(theta, probe_batch)
    except Exception as e:
        raise ValueError(
            "throughput_config probe: the model's pallas_grads hook "
            f"failed on [{n_particles}, {n_params}] particles "
            f"({type(e).__name__}: {e}) — the custom_grads stage would "
            "fail at its first step; fix the hook or drop model="
        ) from e
    if _shape(g) != (n_particles, n_params) or \
            _shape(lp) != (n_particles,):
        raise ValueError(
            "throughput_config probe: custom_grads must return "
            f"(logp_vals [{n_particles}], grads "
            f"[{n_particles}, {n_params}]); got ({_shape(lp)}, "
            f"{_shape(g)})"
        )


def throughput_config(n_particles, n_params, mesh=None, model_axis=None,
                      dtype=torch.float32, model=None, probe_batch=None,
                      pallas_interpret=False):
    """The JAX package's option table (stein_tpu/api.py throughput_config),
    unchanged, as a kwargs dict for SVGDSampler:

        sampler = SVGDSampler(n, log_p, template, gd, **throughput_config(n, p))

    Small f32 problems get step_impl='fused_gram' (kernel B1) with the
    fused cold seed (kernel B2); large n or p >= 256 the streaming tile
    (B3), at large p with the in-kernel-Gram median (B5, or B4 then B2)
    and, for a ``model`` with ``pallas_grads``, its gradient kernel as
    ``custom_grads`` (B7). In the small branch a model with
    ``quadratic_form`` gets step_impl='fused_glm' and one with
    ``inkernel_model`` step_impl='fused_model': B1 with its model stage
    (``ops/model_grad.py``) computing the gradients too.

    On a 1-D particle ``mesh`` (a ``ParticleMesh``, which the dict carries)
    f32 shapes whose median block passes ``bracket_pass_fits`` get
    step_impl='fused_shard' (B8 with median_collectives='rounds' on one
    process, B9 with 'grid' on more, and B3), with a model's
    ``quadratic_form`` or ``pallas_grads`` hook; beyond the gate, the
    streaming tile. ``pallas_interpret`` is accepted for parity and
    ignored: the dict never carries it (the CUDA kernels have no interpret
    mode).

    ``probe_batch=`` (with ``model=``): every branch that wires a model
    hook calls it once on this batch and checks its contract shapes
    (``_probe_model_hooks``, ``_probe_custom_grads``), raising the JAX
    package's ValueError where the hook is wrong."""
    del pallas_interpret
    f32 = dtype == torch.float32
    cfg = dict(median="bisect", warm_median=True, dtype=dtype)
    large = n_particles >= 4096
    if large:
        cfg.update(median_max_rows=128)
    if mesh is not None:
        _check_mesh_type(mesh)
        if model_axis is not None:
            raise _unported("throughput_config(model_axis=...), the 2-D "
                            "mesh,", "A7")
        cfg["mesh"] = mesh
        if f32:
            m_loc = max(min(cfg.get("median_max_rows", 512) // mesh.size,
                            max(n_particles // mesh.size, 1)), 1)
            if bracket_pass_fits(m_loc, n_particles, n_params):
                cfg.update(step_impl="fused_shard",
                           pallas_block=1024 if large else 256)
                cfg["median_collectives"] = (
                    "rounds" if mesh.size == 1 else "grid")
                cfg["median_grid_g1"] = 8
                if not large:
                    cfg["median_max_rows"] = 256
                if model is not None and hasattr(model, "quadratic_form"):
                    if probe_batch is not None:
                        _probe_model_hooks(model, n_particles, n_params,
                                           probe_batch)
                    cfg["quadratic_form"] = model.quadratic_form
                elif model is not None and hasattr(model, "pallas_grads"):
                    hook = model.pallas_grads()
                    if probe_batch is not None:
                        _probe_custom_grads(hook, n_particles, n_params,
                                            probe_batch)
                    cfg["custom_grads"] = hook
            elif large:
                cfg.update(kernel_impl="pallas", pallas_block=1024)
            elif n_params >= 256:
                cfg.update(kernel_impl="pallas", pallas_block=256)
        return cfg
    if not f32:
        return cfg
    if fused_step_fits(n_particles, n_params,
                       min(cfg.get("median_max_rows", 512), 256)):
        cfg.update(step_impl="fused_gram", median_impl="fused",
                   median_max_rows=256)
        if model is not None and probe_batch is not None and (
                hasattr(model, "quadratic_form")
                or hasattr(model, "inkernel_model")):
            _probe_model_hooks(model, n_particles, n_params, probe_batch)
        if model is not None and hasattr(model, "quadratic_form"):
            cfg.update(step_impl="fused_glm",
                       quadratic_form=model.quadratic_form,
                       median_max_rows=128)
        elif model is not None and hasattr(model, "inkernel_model"):
            cfg.update(step_impl="fused_model",
                       inkernel_model=model.inkernel_model,
                       median_max_rows=128)
        return cfg
    cfg["median_impl"] = "fused"
    if large:
        cfg.update(kernel_impl="pallas", pallas_block=1024)
    elif n_params >= 256:
        cfg.update(kernel_impl="pallas", pallas_block=512,
                   median_impl="fused_gram", median_max_rows=128)
        if model is not None and hasattr(model, "pallas_grads"):
            hook = model.pallas_grads()
            if probe_batch is not None:
                _probe_custom_grads(hook, n_particles, n_params, probe_batch)
            cfg["custom_grads"] = hook
    return cfg


def _check_mesh_type(mesh):
    if not isinstance(mesh, ParticleMesh):
        raise TypeError(
            f"mesh must be a stein_tpu_torch.parallel.ParticleMesh (see "
            f"particle_mesh), got {type(mesh).__name__}"
        )


def _check_options(n_params, dtype, median, kernel_impl, median_max_rows,
                   n_particles, kernel, warm_median, median_impl, step_impl,
                   custom_grads, remat, pallas_precision, quadratic_form,
                   inkernel_model):
    """The JAX sampler's ValueError guards, in its order, then the
    NotImplementedError of every option the port does not run yet.
    ``kernel`` is None for the default RBF kernel (an exact
    SquaredExponentialKernel included)."""
    f32 = dtype == torch.float32
    if median_impl not in ("xla", "fused", "fused_gram"):
        raise ValueError(f"unknown median_impl: {median_impl!r}")
    if median_impl != "xla" and median != "bisect":
        raise ValueError(
            f"median_impl={median_impl!r} is the single-kernel bisect "
            "search; it requires median='bisect'"
        )
    if median_impl != "xla" and not f32:
        raise ValueError(f"median_impl={median_impl!r} is f32-only")
    if median_impl == "fused_gram" and kernel_impl != "pallas":
        raise ValueError(
            "median_impl='fused_gram' requires kernel_impl='pallas'; with "
            "kernel_impl='xla' use median_impl='fused'"
        )
    if kernel_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown kernel_impl: {kernel_impl!r}")
    if kernel_impl == "pallas":
        _pallas_only_bisect(median)
    if step_impl not in _STEP_IMPLS + ("fused_shard",):
        raise ValueError(f"unknown step_impl: {step_impl!r}")
    if step_impl == "fused_shard":
        raise ValueError(
            "unknown step_impl: 'fused_shard' on a single device (it is the "
            "mesh tail; pass mesh=)"
        )
    if step_impl == "epilogue":
        if not warm_median:
            raise ValueError("step_impl='epilogue' fuses the warm-median "
                             "scan path; set warm_median=True")
        if kernel is not None or kernel_impl != "pallas":
            raise ValueError("step_impl='epilogue' requires "
                             "kernel_impl='pallas' and the default RBF "
                             "kernel")
        if not f32:
            raise ValueError("step_impl='epilogue' is f32-only")
    if step_impl == "fused_glm" and quadratic_form is None:
        raise ValueError("step_impl='fused_glm' needs quadratic_form=")
    if quadratic_form is not None and step_impl != "fused_glm":
        raise ValueError("quadratic_form is consumed only by "
                         "step_impl='fused_glm'")
    if step_impl == "fused_model" and inkernel_model is None:
        raise ValueError("step_impl='fused_model' needs inkernel_model=")
    if inkernel_model is not None and step_impl != "fused_model":
        raise ValueError("inkernel_model is consumed only by "
                         "step_impl='fused_model'")
    if step_impl in _FUSED_STEP_IMPLS:
        if not warm_median:
            raise ValueError(
                f"step_impl={step_impl!r} fuses the warm-median scan path; "
                "set warm_median=True"
            )
        if kernel is not None or kernel_impl != "xla":
            raise ValueError(
                f"step_impl={step_impl!r} requires the default RBF kernel "
                "and kernel_impl='xla' (the tail replaces both)"
            )
        if not f32:
            raise ValueError(f"step_impl={step_impl!r} is f32-only")
        if not fused_step_fits(n_particles, n_params, median_max_rows):
            vb = fused_step_vmem_bytes(n_particles, n_params,
                                       min(median_max_rows, n_particles))
            raise ValueError(
                f"step_impl={step_impl!r}: ~{vb / 2**20:.0f} MiB by the "
                "JAX package's fused-tail estimate, above its "
                f"~{FUSED_STEP_VMEM_BUDGET / 2**20:.0f} MiB gate; use the "
                "unfused path"
            )
    if warm_median and (median != "bisect" or kernel is not None):
        raise ValueError("warm_median=True requires median='bisect' and "
                         "the default RBF kernel")
    if custom_grads is not None and step_impl != "xla":
        raise ValueError(
            f"custom_grads= replaces the autodiff gradient stage, which "
            f"step_impl={step_impl!r} does not use; use step_impl='xla'"
        )
    if custom_grads is not None and remat:
        raise ValueError(
            "custom_grads= supplies its own gradient computation; "
            "remat=True (checkpointed autodiff) does not apply; drop one "
            "of the two"
        )

    if median in ("subsample", "binned"):
        raise _unported(f"median={median!r}", "A5")
    if median not in ("exact", "bisect"):
        raise ValueError(f"unknown median mode: {median!r}")
    if pallas_precision not in svgd_tile.PRECISIONS:
        raise ValueError(f"unknown pallas_precision: {pallas_precision!r}")
    if kernel is not None and kernel_impl != "xla":
        raise ValueError(
            "kernel_impl='pallas' supports only the RBF kernel; use "
            "kernel_impl='xla' for custom kernels"
        )


def _check_mesh_options(dtype, median, kernel_impl, kernel, warm_median,
                        median_impl, step_impl, custom_grads, remat,
                        pallas_precision, quadratic_form, inkernel_model,
                        model_axis, comm, median_collectives):
    """The JAX sampler's ValueError guards of a mesh, in its order, then
    the NotImplementedError of every mesh option the port does not run yet.
    The mesh builders (parallel/sharded.py, sharded_fused.py) check the
    rest, as the JAX builders do."""
    if kernel_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown kernel_impl: {kernel_impl!r}")
    if median_impl not in ("xla", "fused", "fused_gram"):
        raise ValueError(f"unknown median_impl: {median_impl!r}")
    if median_impl != "xla":
        raise ValueError(
            f"median_impl={median_impl!r} is single-device only (the mesh "
            "warm search psums counts across ranks; a kernel cannot contain "
            "the collective); the mesh fused-median path is "
            "step_impl='fused_shard'"
        )
    if step_impl not in _STEP_IMPLS + ("fused_shard",):
        raise ValueError(f"unknown step_impl: {step_impl!r}")
    if step_impl not in ("xla", "fused_shard"):
        raise ValueError(
            f"step_impl={step_impl!r} is single-device only (the tail cannot "
            "contain the mesh collectives); the mesh fused path is "
            "step_impl='fused_shard'"
        )
    if inkernel_model is not None:
        raise ValueError(
            "inkernel_model= is consumed only by the single-device "
            "step_impl='fused_model' kernel (drop the hook or the mesh)"
        )
    if quadratic_form is not None and step_impl != "fused_shard":
        raise ValueError(
            "on a mesh, quadratic_form= is consumed only by "
            "step_impl='fused_shard' (which then gathers theta only and "
            "derives the gradients from the gathered block)"
        )
    if custom_grads is not None and model_axis is not None:
        raise ValueError(
            "custom_grads= runs on 1-D particle meshes only: on a 2-D "
            "(particles x model) mesh the parameter dimension is sharded "
            "too, and the hook's contract is full [n, p] rows"
        )
    if custom_grads is not None and quadratic_form is not None:
        raise ValueError(
            "custom_grads= and quadratic_form= both replace the gradient "
            "stage; pass one"
        )
    if step_impl == "fused_shard":
        if model_axis is not None:
            raise ValueError(
                "step_impl='fused_shard' runs on 1-D particle meshes only "
                "(the 2-D step tiles the model axis with its own Gram)"
            )
        if comm == "ring" and median_collectives != "grid":
            raise ValueError(
                "comm='ring' + step_impl='fused_shard' supports "
                "median_collectives='grid' only (the rounds chain would "
                "re-count the ring D buffer per round)"
            )
        if not warm_median or median != "bisect":
            raise ValueError(
                "step_impl='fused_shard' fuses the warm-median scan path; "
                "set warm_median=True (and median='bisect')"
            )
        if kernel is not None or kernel_impl != "xla":
            raise ValueError(
                "step_impl='fused_shard' requires the default RBF kernel "
                "and kernel_impl='xla' (its own streaming tile replaces the "
                "kernel stage)"
            )
        if dtype != torch.float32:
            raise ValueError("step_impl='fused_shard' is f32-only")
    if warm_median and (median != "bisect" or kernel is not None):
        raise ValueError("warm_median=True requires median='bisect' and "
                         "the default RBF kernel")

    if model_axis is not None:
        raise _unported("model_axis=, the 2-D (particles x model) mesh,",
                        "A7")
    if median in ("subsample", "binned"):
        raise _unported(f"median={median!r}", "A5")
    if pallas_precision not in svgd_tile.PRECISIONS:
        raise ValueError(f"unknown pallas_precision: {pallas_precision!r}")


class SVGDSampler:
    """Stein variational gradient descent on one device or a 1-D particle
    mesh.

    Parameters follow ``stein_tpu.SVGDSampler``; the differences:

    generator : ``torch.Generator`` for the particle init (JAX's ``key``;
        ignored when ``theta`` is given). Defaults to one seeded with 0.
    theta : optional initial particles, an [n, p] array or tensor, or a
        structure of [n, *shape] leaves matching ``param_template``.
    dtype : a torch dtype (float32 default).
    device : where the particles, the optimizer state and every carried
        scalar live: the current card by default, which runs the
        hand-written kernels (without a card the sampler raises; pass
        device="cpu" for the plain PyTorch versions on the CPU). Batches
        must already lie on this device.
    mesh : a ``parallel.ParticleMesh`` (``particle_mesh()`` after
        ``setup_distributed``): the particles are sharded over its
        processes, each of which builds the same sampler (the same
        ``generator`` seed or ``theta``) and keeps its block. ``device``
        must be of the mesh's kind (NCCL: cuda, gloo: cpu). ``run``,
        ``train_on_batch(es)``, ``train_minibatched`` and ``load_state``
        work on the local block; ``samples``, ``theta``,
        ``function_posterior``, ``ksd`` and ``save`` all-gather the full
        particles, so every rank must call them. ``comm``,
        ``median_collectives`` and ``median_grid_g1`` are the JAX
        sampler's; ``model_axis`` (the 2-D mesh) is not ported.
    pallas_block, donate, pallas_interpret : accepted so JAX configs carry
        over and ignored: the CUDA tile's sizes are its own, PyTorch runs
        eagerly with no buffers to donate, and the kernels have no
        interpret mode.
    binned_bins, binned_block_rows : the JAX sampler's median='binned'
        settings; a value other than the default raises
        NotImplementedError (ROADMAP.md queue A, item 5).
    pallas_precision : 'f32' (default) or 'bf16', the streaming tile's
        operands (kernel_impl='pallas', on one device and on the mesh):
        'bf16' rounds the centred particles for the dot and K and u for
        the contraction to bf16, with f32 accumulation.
    custom_grads : a callable (theta [n, p], batch) -> (logp [n],
        grads [n, p]) replacing the autodiff gradient stage, e.g.
        ``BayesianNNModel.pallas_grads()`` (kernel B7).
    remat : recompute log_p's forward in the backward of the gradient
        stage (``torch.utils.checkpoint``; see ``_make_grad_all``).
    kernel : a ``kernels/`` kernel. An exact ``SquaredExponentialKernel``
        is the default RBF kernel; any other (a subclass included) takes
        the generic two-matrix path with ``kernel_impl='xla'`` and the
        cold step (``warm_median`` and the fused tails refuse it).
    quadratic_form, inkernel_model : a model's hooks for
        step_impl='fused_glm' (``LinearRegressionModel.quadratic_form``)
        and 'fused_model' (``LogisticRegressionModel.inkernel_model``),
        called on each batch; the fused tail computes the gradients.

    Options the port does not run yet raise NotImplementedError (see
    ``_check_options``); options the JAX sampler refuses raise the same
    ValueError.
    """

    def __init__(self, n_particles, log_p, param_template, gd,
                 generator=None, theta=None, dtype=torch.float32,
                 device=None, median="exact", kernel_impl="xla",
                 median_max_rows=512, max_phi_norm=10.0, mesh=None,
                 particle_axis="particles", donate=True, pallas_block=1024,
                 pallas_interpret=False, model_axis=None, comm="all_gather",
                 remat=False, kernel=None, binned_bins=4096,
                 binned_block_rows=256, median_passes=30, warm_median=False,
                 warm_passes=8, pallas_precision="f32", median_impl="xla",
                 step_impl="xla", quadratic_form=None, inkernel_model=None,
                 custom_grads=None, median_collectives="grid",
                 median_grid_g1=16):
        self.n_particles = int(n_particles)
        if self.n_particles < 2:
            raise ValueError(
                "SVGD needs n_particles >= 2 (the median-heuristic bandwidth "
                "h^2 = median(D)/log(n) is undefined for n=1)"
            )
        if (binned_bins, binned_block_rows) != (4096, 256):
            raise _unported("binned_bins= and binned_block_rows= (the "
                            "median='binned' settings)", "A5")
        if type(kernel) is SquaredExponentialKernel:
            # The default kernel itself: every dispatch (the fused RBF
            # paths, the warm_median guards) treats it as kernel=None. A
            # subclass may override weights() and stays generic.
            kernel = None
        self.device = _device.resolve_device(device, "SVGDSampler")
        self.mesh = mesh
        self.log_p = log_p
        self.gd = gd
        self.dtype = dtype
        self.n_params, self.unravel_fn = template_unraveler(param_template)
        self._posterior_cache = {}
        self._score_fn = None
        if mesh is None:
            _check_options(self.n_params, dtype, median, kernel_impl,
                           median_max_rows, self.n_particles, kernel,
                           warm_median, median_impl, step_impl, custom_grads,
                           remat, pallas_precision, quadratic_form,
                           inkernel_model)
        else:
            _check_mesh_type(mesh)
            if self.device.type != mesh.device_type:
                raise ValueError(
                    f"SVGDSampler(device={str(self.device)!r}) on a mesh of "
                    f"{mesh.device_type} tensors: NCCL meshes take "
                    "device='cuda', gloo meshes device='cpu'"
                )
            if particle_axis != mesh.axis_name:
                raise ValueError(f"particle_axis={particle_axis!r} is not "
                                 f"the mesh's axis {mesh.axis_name!r}")
            _check_mesh_options(dtype, median, kernel_impl, kernel,
                                warm_median, median_impl, step_impl,
                                custom_grads, remat, pallas_precision,
                                quadratic_form, inkernel_model, model_axis,
                                comm, median_collectives)
        del pallas_block, donate, pallas_interpret   # see the docstring

        if theta is not None:
            if isinstance(theta, (dict, list, tuple)):
                theta = ravel_particles(theta)
            # A copy: the caller's array may be shared across samplers.
            theta0 = torch.as_tensor(theta).to(device=self.device,
                                               dtype=dtype).clone()
            if tuple(theta0.shape) != (self.n_particles, self.n_params):
                raise ValueError(
                    f"theta shape {tuple(theta0.shape)} != "
                    f"{(self.n_particles, self.n_params)}"
                )
        else:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            theta0 = init_particles(generator, self.n_particles,
                                    self.n_params, dtype, device=self.device)

        self.state = SVGDState(
            theta0, gd.init(tuple(theta0.shape), dtype, self.device),
            torch.zeros((), dtype=torch.int32, device=self.device),
        )
        if mesh is not None:
            self._build_mesh_steps(
                mesh, median=median, max_phi_norm=max_phi_norm, comm=comm,
                median_max_rows=median_max_rows, median_passes=median_passes,
                kernel_impl=kernel_impl, custom_grads=custom_grads,
                warm_median=warm_median, warm_passes=warm_passes,
                step_impl=step_impl, quadratic_form=quadratic_form,
                median_collectives=median_collectives,
                median_grid_g1=median_grid_g1,
                pallas_precision=pallas_precision, kernel=kernel,
                remat=remat)
            return

        if median == "exact":
            d_bytes = self.n_particles ** 2 * theta0.element_size()
            if d_bytes > EXACT_MEDIAN_WARN_BYTES:
                warnings.warn(
                    f"median='exact' sorts the full [{self.n_particles}, "
                    f"{self.n_particles}] distance matrix every step "
                    f"({d_bytes / 2**20:.0f} MB). Use median='bisect' or "
                    "splat stein_tpu_torch.throughput_config(n, p).",
                    stacklevel=2,
                )
        self._step_fn = make_step_fn(
            log_p, self.unravel_fn, gd,
            make_phi_fn(self.n_particles, median=median,
                        kernel_impl=kernel_impl,
                        median_max_rows=median_max_rows,
                        median_passes=median_passes,
                        median_impl=median_impl,
                        pallas_precision=pallas_precision, kernel=kernel),
            max_phi_norm=max_phi_norm, custom_grads=custom_grads,
            remat=remat,
        )
        self._warm_step_fn = None
        if warm_median:
            if step_impl in _FUSED_STEP_IMPLS:
                self._warm_step_fn, self._warm_init_med = \
                    make_fused_warm_step_fn(
                        log_p, self.unravel_fn, gd,
                        max_phi_norm=max_phi_norm,
                        median_max_rows=median_max_rows,
                        median_passes=median_passes,
                        warm_passes=warm_passes,
                        gram_in_kernel=step_impl != "fused",
                        quadratic_form=quadratic_form,
                        inkernel_model=inkernel_model, remat=remat,
                    )
            elif step_impl == "epilogue":
                self._warm_step_fn, self._warm_init_med = \
                    make_epilogue_warm_step_fn(
                        log_p, self.unravel_fn, gd, self.n_particles,
                        max_phi_norm=max_phi_norm,
                        median_max_rows=median_max_rows,
                        median_passes=median_passes,
                        warm_passes=warm_passes, median_impl=median_impl,
                        remat=remat,
                    )
            else:
                warm_phi = make_warm_phi_fn(
                    self.n_particles, kernel_impl=kernel_impl,
                    median_max_rows=median_max_rows,
                    median_passes=median_passes, warm_passes=warm_passes,
                    median_impl=median_impl,
                    pallas_precision=pallas_precision,
                )
                self._warm_step_fn = make_warm_step_fn(
                    log_p, self.unravel_fn, gd, warm_phi,
                    max_phi_norm=max_phi_norm, custom_grads=custom_grads,
                    remat=remat,
                )
                self._warm_init_med = warm_phi.init_med

    def _build_mesh_steps(self, mesh, median, max_phi_norm, comm,
                          median_max_rows, median_passes, kernel_impl,
                          custom_grads, warm_median, warm_passes, step_impl,
                          quadratic_form, median_collectives, median_grid_g1,
                          pallas_precision, kernel, remat):
        """The mesh steps, as the JAX sampler builds them: the cold step
        for train_on_batch on every mesh, then the fused or plain warm step
        for run. self.state becomes this rank's block."""
        from .parallel.sharded import (
            make_sharded_step,
            make_sharded_warm_step,
        )
        from .parallel.sharded_fused import make_sharded_fused_warm_step

        full = self.state
        self._step_fn, self.state = make_sharded_step(
            self.log_p, self.unravel_fn, self.gd, self.n_particles, full,
            mesh, median=median, max_phi_norm=max_phi_norm, comm=comm,
            median_max_rows=median_max_rows, median_passes=median_passes,
            kernel_impl=kernel_impl, custom_grads=custom_grads,
            pallas_precision=pallas_precision, kernel=kernel, remat=remat)
        self._warm_step_fn = None
        common = dict(max_phi_norm=max_phi_norm,
                      median_max_rows=median_max_rows,
                      median_passes=median_passes, warm_passes=warm_passes,
                      comm=comm, custom_grads=custom_grads, remat=remat)
        if step_impl == "fused_shard":
            self._warm_step_fn, self._warm_init_med = \
                make_sharded_fused_warm_step(
                    self.log_p, self.unravel_fn, self.gd, self.n_particles,
                    full, mesh, quadratic_form=quadratic_form,
                    median_collectives=median_collectives,
                    median_grid_g1=median_grid_g1, **common)
        elif warm_median:
            self._warm_step_fn, self._warm_init_med = \
                make_sharded_warm_step(
                    self.log_p, self.unravel_fn, self.gd, self.n_particles,
                    mesh, kernel_impl=kernel_impl,
                    pallas_precision=pallas_precision, **common)

    # ------------------------------------------------------------------ API

    def _check_batch(self, batch):
        for leaf in _tensor_leaves(batch):
            if leaf.device != self.device:
                raise ValueError(
                    f"batch tensor on {leaf.device}, sampler on "
                    f"{self.device}: move the batch to the sampler's device"
                )

    def train_on_batch(self, batch):
        """One SVGD step on a batch (dict of tensors). Returns aux
        diagnostics as 0-d device tensors: phi_norm (pre-clip),
        log_p_mean, h2, median."""
        self._check_batch(batch)
        self.state, aux = self._step_fn(self.state, batch)
        return aux

    def _steps(self, n_steps, batch_at):
        """``n_steps`` steps, step i on ``batch_at(i)``; aux stacked to a
        leading [n_steps] axis on the device. The warm path seeds its carry
        with the cold median once per call, as the JAX sampler's scans do.
        The loop issues device work only: no scalar is read on the host
        until the caller reads the result. Zero steps leave the state as it
        was and return the four diagnostics with shape (0,), as a JAX scan
        of length 0 does."""
        if n_steps == 0:
            return {k: torch.empty(0, dtype=self.dtype, device=self.device)
                    for k in ("h2", "log_p_mean", "median", "phi_norm")}
        auxes = []
        if self._warm_step_fn is not None:
            med = self._warm_init_med(self.state.particles).to(self.dtype)
            carry = (self.state, med)
            for i in range(n_steps):
                carry, aux = self._warm_step_fn(carry, batch_at(i))
                auxes.append(aux)
            self.state = carry[0]
        else:
            for i in range(n_steps):
                self.state, aux = self._step_fn(self.state, batch_at(i))
                auxes.append(aux)
        return {k: torch.stack([a[k] for a in auxes]) for k in auxes[0]}

    def run(self, batch, n_steps):
        """``n_steps`` full-batch SVGD steps. Returns aux with a leading
        [n_steps] axis (see ``_steps``)."""
        n_steps = _step_count(n_steps)
        self._check_batch(batch)
        return self._steps(n_steps, lambda i: batch)

    def train_on_batches(self, batches):
        """One SVGD step per slice of the leading [k] axis of every leaf of
        ``batches`` (k stacked minibatches, e.g. gathered rows of a
        dataset); counterpart of ``stein_tpu/api.py:1731``. Returns aux
        with a leading [k] axis."""
        self._check_batch(batches)
        leaves = _tensor_leaves(batches)
        k = leaves[0].shape[0] if leaves and leaves[0].dim() else None
        if k is None or any(l.dim() == 0 or l.shape[0] != k
                            for l in leaves):
            raise ValueError(
                "train_on_batches needs tensors with one leading [k] axis, "
                f"got shapes {[tuple(l.shape) for l in leaves]}"
            )
        return self._steps(k, lambda i: _tree_map(lambda l: l[i], batches))

    def train_minibatched(self, data, n_steps, n_batch, key):
        """``n_steps`` minibatch SVGD steps on a dataset resident on the
        sampler's device; counterpart of ``stein_tpu/api.py:1755``.
        ``data`` is the full dataset (leaves [n_rows, ...]); each step
        gathers ``n_batch`` rows drawn uniformly WITH replacement (the JAX
        package's documented trade against the reference's
        replace=False). The indices of the whole call come from one draw,
        ``minibatch_indices(key, n_steps, n_batch, n_rows, device)``; its
        ``key`` is an int seed or a torch.Generator on the sampler's
        device. The JAX PRNG, and a CPU generator against a CUDA one, draw
        other indices from the same seed: the same indices gathered by the
        caller and passed to ``train_on_batches`` give the same result.
        Returns aux with a leading [n_steps] axis."""
        n_steps = _step_count(n_steps)
        self._check_batch(data)
        leaves = _tensor_leaves(data)
        if not leaves or any(l.dim() == 0 or l.shape[0] != leaves[0].shape[0]
                             for l in leaves):
            raise ValueError(
                "train_minibatched needs a dataset of tensors with one "
                f"leading [n_rows] axis, got shapes "
                f"{[tuple(l.shape) for l in leaves]}"
            )
        idx = minibatch_indices(key, n_steps, n_batch, leaves[0].shape[0],
                                self.device)
        return self._steps(n_steps, lambda i: _tree_map(
            lambda l: l.index_select(0, idx[i]), data))

    def load_state(self, state):
        """Replace the sampler state (e.g. from
        utils.convert.state_from_numpy), checking its shapes and device. On
        a mesh, the state is this rank's block (state_from_numpy(...,
        mesh=))."""
        shape = (self.n_particles // (self.mesh.size if self.mesh else 1),
                 self.n_params)
        if tuple(state.particles.shape) != shape:
            raise ValueError(f"state particles {tuple(state.particles.shape)}"
                             f" != {shape}")
        ref = self.state.opt_state
        if type(state.opt_state) is not type(ref):
            raise ValueError(
                f"optimizer state {type(state.opt_state).__name__} does not "
                f"match the sampler's {type(ref).__name__}"
            )
        for new, old in zip((state.particles, state.step, *state.opt_state),
                            (self.state.particles, self.state.step, *ref)):
            if (new.device != self.device or new.dtype != old.dtype
                    or new.shape != old.shape):
                raise ValueError(
                    f"state leaf {tuple(new.shape)} {new.dtype} on "
                    f"{new.device} != {tuple(old.shape)} {old.dtype} on "
                    f"{self.device}"
                )
        self.state = state

    def _particles(self):
        if self.mesh is None:
            return self.state.particles
        return coll.all_gather(self.state.particles, self.mesh)

    @property
    def samples(self):
        """[n_particles, n_params] particle matrix as a host numpy array
        (reference: stein_sampler.py:73-78); on a mesh, all-gathered (a
        collective: every rank reads it)."""
        return self._particles().detach().cpu().numpy()

    @property
    def theta(self):
        """Particles as a structure of [n_particles, *shape] leaves (on a
        mesh, all-gathered)."""
        return unravel_particles(self._particles(), self.unravel_fn)

    def function_posterior(self, func, batch, axis=None):
        """Posterior of ``func(params, batch) -> tensor`` over the
        particles (reference: abstract_stein_sampler.py:129-168;
        ``stein_tpu/api.py:1865``): ``torch.func.vmap`` over the particle
        rows, each result raveled, cached per ``func``. Returns the [n,
        size] samples as a host numpy array, or their mean over ``axis``.
        On a mesh it works on the all-gathered particles (a collective:
        every rank calls it)."""
        self._check_batch(batch)
        fn = self._posterior_cache.get(func)
        if fn is None:
            unravel = self.unravel_fn

            def per_particle(row, b):
                return func(unravel(row), b).reshape(-1)
            fn = vmap(per_particle, in_dims=(0, None))
            self._posterior_cache[func] = fn
        with torch.no_grad():
            dist = fn(self._particles(), batch)
            if axis is not None:
                dist = dist.mean(dim=axis)
        return dist.cpu().numpy()

    def ksd(self, batch, u_statistic=False):
        """Kernel Stein discrepancy (squared) of the current particles
        w.r.t. the target defined by log_p on ``batch``
        (``ops.diagnostics.ksd_rbf``; ``stein_tpu/api.py:1828``): the
        scores by ``torch.func`` autodiff of log_p, never ``custom_grads``,
        as in the JAX package. Returns a Python float. On a mesh it works
        on the all-gathered particles (a collective: every rank calls
        it)."""
        self._check_batch(batch)
        if self._score_fn is None:
            log_p, unravel = self.log_p, self.unravel_fn

            def log_p_flat(row, b):
                return log_p(unravel(row), b)
            self._score_fn = vmap(grad(log_p_flat), in_dims=(0, None))
        theta = self._particles()
        return float(ksd_rbf(theta, self._score_fn(theta, batch),
                             u_statistic=u_statistic))

    def save(self, path):
        """Checkpoint the full sampler state (particles, optimizer
        moments, decayed learning rate, step count) to ``path``, in the
        JAX package's npz format (``utils/checkpoint.py``). On a mesh
        every rank calls it: the blocks are all-gathered and rank 0
        writes."""
        from .utils.checkpoint import save_checkpoint
        save_checkpoint(path, self.state, mesh=self.mesh)

    def restore(self, path):
        """Restore a state saved by ``save`` (by either package) onto the
        sampler's device; on a mesh every rank restores the full state and
        keeps its own block (``parallel.sharded.shard_state``)."""
        from .utils.checkpoint import restore_checkpoint
        if self.mesh is None:
            self.state = restore_checkpoint(path, self.state)
            return
        from .parallel.sharded import shard_state
        full = _tree_map(
            lambda l: torch.empty(
                (self.n_particles, *l.shape[1:]) if l.dim() else (),
                dtype=l.dtype, device=l.device), self.state)
        self.state = shard_state(restore_checkpoint(path, full), self.mesh)


def _step_count(n_steps):
    n_steps = int(n_steps)
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0 (got {n_steps})")
    return n_steps


def minibatch_indices(key, n_steps, n_batch, n_rows, device=None):
    """The row indices ``SVGDSampler.train_minibatched`` gathers: an
    [n_steps, n_batch] int64 tensor, uniform on [0, n_rows) with
    replacement, from one ``torch.randint`` call. ``key`` is an int seed
    (a new ``torch.Generator`` on ``device`` seeded with it) or a
    ``torch.Generator`` on ``device``, which the draw advances.
    ``device`` defaults to the current card (raising without one)."""
    device = _device.resolve_device(device, "minibatch_indices")
    if isinstance(key, torch.Generator):
        gen = key
    else:
        gen = torch.Generator(device).manual_seed(int(key))
    return torch.randint(0, n_rows, (n_steps, n_batch), generator=gen,
                         device=device, dtype=torch.int64)


def _tree_map(fn, tree):
    """fn on every tensor of a structure of dicts, lists and tuples
    (named tuples kept); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_tree_map(fn, v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _tensor_leaves(tree):
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in _tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in _tensor_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


# Reference-compatible alias (stein/samplers/__init__.py:1).
SteinSampler = SVGDSampler
