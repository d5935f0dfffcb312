"""The 2-D (particles x model) sharded SVGD step over a ``Mesh2D``.

PyTorch counterpart of ``stein_tpu/parallel/sharded2d.py``. The particles
are sharded [n/dp, p/mp] over a (particles, model) mesh; every process runs
the step on its block and calls the collectives where the JAX program has
them:

- log_p needs whole parameter rows, so the rows are all-gathered over the
  model axis for the gradients, which are cut back to the local p shard;
- D = r + r^T - 2 theta theta^T needs the full inner product over p: each
  rank forms its partial row norms and Gram against the particle-axis
  gather of its columns, and the partials are psum'd over the model axis
  (the three norm partials in one concatenated psum, then the Gram), so
  every rank of a model axis holds bitwise the same D rows;
- K @ [grads | theta] then runs on the p-sharded columns, leaving phi
  p-sharded; the clip norm is psum'd over both axes.

``kernel_impl='pallas'`` streams K @ u, u = grads - theta / h^2, through
kernel B10 (``ops.svgd_tile.svgd_both_ksum_on_D``) on the psum'd D rows.
"""

import torch

from ..api import SVGDState, _make_grad_all
from ..ops import rbf, svgd_tile
from ..ops.median import (
    exact_median,
    sharded_bisect_median_on_D,
    sharded_warm_bisect_median_on_D,
    sharded_warm_grid_on_D,
)
from . import collectives as coll
from .sharded import check_exact_median_gather


def _block_2d(leaf, n, p, mesh):
    """This rank's [n/dp, p/mp] block of an [n, p] leaf; other leaves
    (scalars) whole."""
    if isinstance(leaf, torch.Tensor) and tuple(leaf.shape) == (n, p):
        n_loc, p_loc = n // mesh.particles.size, p // mesh.model.size
        i, j = mesh.particles.rank, mesh.model.rank
        return leaf[i * n_loc:(i + 1) * n_loc,
                    j * p_loc:(j + 1) * p_loc].clone(
                        memory_format=torch.contiguous_format)
    return leaf


def shard_state_2d(state, mesh):
    """This rank's block of a full SVGDState on a ``Mesh2D``: the particles
    and every optimizer leaf of the particles' shape by (particles, model)
    block, the scalars whole (the JAX package's _state_specs_2d rule)."""
    n, p = state.particles.shape
    opt = state.opt_state
    return SVGDState(_block_2d(state.particles, n, p, mesh),
                     type(opt)(*[_block_2d(leaf, n, p, mesh)
                                 for leaf in opt]),
                     state.step)


def _check_2d(n_particles, n_params, mesh):
    dp, mp = mesh.particles.size, mesh.model.size
    if n_particles % dp != 0:
        raise ValueError(f"n_particles={n_particles} not divisible by "
                         f"{mesh.particles.axis_name}={dp}")
    if n_params % mp != 0:
        raise ValueError(f"n_params={n_params} not divisible by "
                         f"{mesh.model.axis_name}={mp} (pad the template)")


def _d_rows_2d(theta_blk, theta_cols, model):
    """The exact [n_loc, n] squared-distance rows: the partial row norms
    and Gram over the local parameter shard, psum'd over the ``model``
    axis, plus the CENTRED column norms (psum'd alike) that bound the grid
    search's fallback range. One copy for the step and the warm seed, so
    the seed searches the D the step re-verifies against."""
    n = theta_cols.shape[0]
    tc_cen = theta_cols - torch.mean(theta_cols, dim=0, keepdim=True)
    partial_gram = torch.matmul(theta_blk, theta_cols.T)
    vec = coll.psum(torch.cat([
        torch.sum(theta_cols * theta_cols, dim=1),
        torch.sum(tc_cen * tc_cen, dim=1),
        torch.sum(theta_blk * theta_blk, dim=1),
    ]), model)
    rsq_all, rsq_cen, rsq_loc = vec[:n], vec[n:2 * n], vec[2 * n:]
    gram = coll.psum(partial_gram, model)
    return rsq_loc[:, None] + rsq_all[None, :] - 2.0 * gram, rsq_cen


def _core_step_2d(state, batch, compute_med, *, grad_all, gd, kernel,
                  n_particles, mesh, max_phi_norm, kernel_impl):
    """The body of the cold and warm 2-D steps: the gathers, the psum'd D
    rows, ``med = compute_med(D_rows, rsq_cen)``, the kernel tile, the
    two-axis clip and the optimizer update."""
    parts, model = mesh.particles, mesh.model
    theta_blk = state.particles                              # [n_loc, p_loc]
    p_loc = theta_blk.shape[1]
    theta_rows = coll.all_gather(theta_blk, model, dim=1)    # [n_loc, p]
    log_p_vals, grads_rows = grad_all(theta_rows, batch)
    m = model.rank
    grads_blk = grads_rows[:, m * p_loc:(m + 1) * p_loc]
    theta_cols = coll.all_gather(theta_blk, parts)           # [n, p_loc]
    grads_cols = coll.all_gather(grads_blk, parts)
    D_rows, rsq_cen = _d_rows_2d(theta_blk, theta_cols, model)

    med = compute_med(D_rows, rsq_cen)
    h2 = rbf.bandwidth_sq_from_median(med, n_particles)
    dt = theta_blk.dtype
    if kernel is None and kernel_impl == "pallas":
        # K never in memory: kernel B10 on the D rows, f32 in and out.
        f32 = torch.float32
        ku, ksum = svgd_tile.svgd_both_ksum_on_D(
            D_rows.to(f32), (grads_cols - theta_cols / h2).to(f32),
            h2.to(f32))
        phi = (ku.to(dt) + ksum.to(dt) * theta_blk / h2) / n_particles
    elif kernel is None:
        K_rows = torch.exp(-D_rows / h2 / 2.0)
        ksum = torch.sum(K_rows, dim=1, keepdim=True)
        both = torch.matmul(K_rows, torch.cat([grads_cols, theta_cols], 1))
        phi = (both[:, :p_loc] + (ksum * theta_blk - both[:, p_loc:]) / h2
               ) / n_particles
    else:
        # K and W differ: two products (kernels.generic_svgd_phi's order).
        K_rows, W_rows = kernel.weights(D_rows, h2)
        wsum = torch.sum(W_rows, dim=1, keepdim=True)
        attract = torch.matmul(K_rows, grads_cols)
        wtheta = torch.matmul(W_rows, theta_cols)
        phi = (attract + (wsum * theta_blk - wtheta)) / n_particles

    norm = torch.sqrt(coll.psum(coll.psum(torch.sum(phi * phi), parts),
                                model))
    phi = phi * (max_phi_norm / torch.clamp(norm, min=max_phi_norm))
    delta, opt_state = gd.update(state.opt_state, phi)
    new_state = SVGDState(theta_blk + delta, opt_state, state.step + 1)
    aux = {"phi_norm": norm,
           "log_p_mean": coll.pmean(torch.mean(log_p_vals), parts),
           "h2": h2, "median": med}
    return new_state, aux


def make_sharded2d_step(log_p, unravel_fn, gd, n_particles, n_params, state,
                        mesh, max_phi_norm=10.0, remat=False, median="exact",
                        median_max_rows=512, median_passes=30, kernel=None,
                        kernel_impl="xla"):
    """Build (step_fn, local_state) over a ``Mesh2D``: step_fn(local_state,
    batch) -> (local_state, aux) is the cold step every rank runs on its
    block. ``median='exact'`` gathers the full [n, n] D on every rank
    (under the 1-D mesh's byte ceiling); 'bisect' psums strided-row counts
    of the local D rows over the particle axis. A ``kernel`` other than
    exactly SquaredExponentialKernel takes the generic two-product path."""
    from ..kernels import SquaredExponentialKernel
    if type(kernel) is SquaredExponentialKernel:
        kernel = None    # the fused RBF path
    if kernel_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown kernel_impl: {kernel_impl!r}")
    if kernel_impl == "pallas" and kernel is not None:
        raise ValueError(
            "kernel_impl='pallas' implements the fused RBF tile only; "
            "use kernel_impl='xla' for custom kernels"
        )
    _check_2d(n_particles, n_params, mesh)
    if median not in ("exact", "bisect"):
        raise ValueError(
            f"unknown 2-D sharded median mode: {median!r} "
            "(use 'exact' or 'bisect')"
        )
    if median == "exact":
        check_exact_median_gather(
            n_particles, state.particles.dtype, "2-D mesh",
            "median='bisect' (exact to fp-bisection resolution, no gather)",
        )
    grad_all = _make_grad_all(log_p, unravel_fn, remat=remat)

    def compute_med(D_rows, rsq_cen):
        if median == "exact":
            return exact_median(coll.all_gather(D_rows, mesh.particles))
        return sharded_bisect_median_on_D(D_rows, mesh.particles,
                                          max_rows=median_max_rows,
                                          passes=median_passes)

    def step_fn(state, batch):
        return _core_step_2d(state, batch, compute_med, grad_all=grad_all,
                             gd=gd, kernel=kernel, n_particles=n_particles,
                             mesh=mesh, max_phi_norm=max_phi_norm,
                             kernel_impl=kernel_impl)

    return step_fn, shard_state_2d(state, mesh)


def make_sharded2d_warm_step(log_p, unravel_fn, gd, n_particles, n_params,
                             mesh, max_phi_norm=10.0, remat=False,
                             median_max_rows=512, median_passes=30,
                             warm_passes=8, kernel_impl="xla",
                             median_collectives="rounds",
                             median_grid_g1=8):
    """The warm-median 2-D step for ``run``: the carry is (local_state,
    med_prev), and the warm search counts on the psum'd local D rows over
    the particle axis only (the rows are the same on every rank of a model
    axis, so every rank refines the same interval). RBF kernel only.
    ``median_collectives``: 'rounds', the quad-ary chain
    (sharded_warm_bisect_median_on_D), or 'grid', the two-collective search
    (sharded_warm_grid_on_D) whose fallback range is 4 max |x - mean|^2 of
    the centred column norms. Returns (warm_step_fn, init_med_fn);
    init_med_fn(theta_blk) is the cold seed on the same D rows."""
    if median_collectives not in ("grid", "rounds"):
        raise ValueError(
            f"unknown median_collectives mode: {median_collectives!r}"
        )
    _check_2d(n_particles, n_params, mesh)
    grad_all = _make_grad_all(log_p, unravel_fn, remat=remat)
    parts = mesh.particles

    def warm_step_fn(carry, batch):
        state, med_prev = carry
        if median_collectives == "grid":
            def compute_med(D_rows, rsq_cen):
                hi_bound = 4.0 * torch.max(rsq_cen) * 1.0001 + 1e-30
                return sharded_warm_grid_on_D(
                    D_rows, med_prev, hi_bound, parts,
                    max_rows=median_max_rows, warm_passes=warm_passes,
                    g1=median_grid_g1)
        else:
            def compute_med(D_rows, rsq_cen):
                return sharded_warm_bisect_median_on_D(
                    D_rows, med_prev, parts, max_rows=median_max_rows,
                    warm_passes=warm_passes)
        new_state, aux = _core_step_2d(
            state, batch, compute_med, grad_all=grad_all, gd=gd,
            kernel=None, n_particles=n_particles, mesh=mesh,
            max_phi_norm=max_phi_norm, kernel_impl=kernel_impl)
        return (new_state, aux["median"].to(state.particles.dtype)), aux

    def init_med_fn(theta_blk):
        D_rows, _ = _d_rows_2d(theta_blk, coll.all_gather(theta_blk, parts),
                               mesh.model)
        return sharded_bisect_median_on_D(D_rows, parts,
                                          max_rows=median_max_rows,
                                          passes=median_passes)

    return warm_step_fn, init_med_fn
