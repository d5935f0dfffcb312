"""The particle-sharded SVGD step over a 1-D ``ParticleMesh``.

PyTorch counterpart of ``stein_tpu/parallel/sharded.py``. Where the JAX
package runs one SPMD program under ``shard_map``, here every process runs
the step on its own block and calls the collectives
(``parallel/collectives.py``) where the JAX program has them:

- each rank holds a particle block [n_loc, p] and the matching optimizer
  moment blocks; scalar state is whole on every rank;
- per-particle gradients run locally (``torch.func``, or ``custom_grads``);
- the n x n kernel is local rows x global columns, against an all-gathered
  particle and gradient block (comm='all_gather') or blocks circulated
  around the ring (comm='ring');
- the median is global: exact from the gathered distance rows, or the
  bisect searches of ``ops/median.py`` with psum'd counts;
- the clip norm is a psum of the local squared sums
  (abstract_stein_sampler.py:125), so every rank clips alike.

A ``kernels/`` kernel other than the RBF one takes the generic
weights-kernel tile (K @ grads and W @ theta, gathered or around the ring)
on the cold step.
"""

import torch

from ..api import SVGDState, _make_grad_all
from ..ops import rbf, svgd_tile
from ..ops.median import (
    _row_block_sq_dists,
    binned_median,
    exact_median,
    ring_binned_median,
    ring_bisect_median,
    ring_warm_bisect_median,
    sharded_bisect_median,
    sharded_warm_bisect_median,
    sharded_warm_bisect_median_on_D,
)
from . import collectives as coll

# Per-device ceiling for the [n, n] gather median='exact' requires
# (2^28 B = 256 MB -> n <= 8192 in f32), as in the JAX package.
EXACT_MEDIAN_GATHER_LIMIT_BYTES = 2 ** 28


def check_exact_median_gather(n_particles, dtype, context, alternatives):
    """Refuse median='exact' when its [n, n] all-gather onto every device
    would exceed EXACT_MEDIAN_GATHER_LIMIT_BYTES."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    gather_bytes = n_particles * n_particles * itemsize
    if gather_bytes > EXACT_MEDIAN_GATHER_LIMIT_BYTES:
        n_max = int((EXACT_MEDIAN_GATHER_LIMIT_BYTES // itemsize) ** 0.5)
        raise ValueError(
            f"median='exact' on a {context} would all-gather the full "
            f"[{n_particles}, {n_particles}] distance matrix onto every "
            f"device ({gather_bytes / 2**20:.0f} MB/device). Use "
            f"{alternatives} for n_particles > {n_max}."
        )


def _block(leaf, n, mesh):
    """This rank's rows of a leaf whose leading dimension is n; other
    leaves (scalars) whole."""
    if isinstance(leaf, torch.Tensor) and leaf.dim() >= 1 \
            and leaf.shape[0] == n:
        n_loc = n // mesh.size
        return leaf[mesh.rank * n_loc:(mesh.rank + 1) * n_loc].clone()
    return leaf


def shard_state(state, mesh):
    """This rank's block of a full SVGDState: rows [r n_loc, (r+1) n_loc) of
    the particles and of every optimizer leaf whose leading dimension is n,
    the scalars whole (the JAX package's _state_specs rule)."""
    n = state.particles.shape[0]
    opt = state.opt_state
    return SVGDState(_block(state.particles, n, mesh),
                     type(opt)(*[_block(leaf, n, mesh) for leaf in opt]),
                     state.step)


def replicate_batch(batch, mesh):
    """The batch on this rank's device: every rank passes the same values
    (nothing is sent), as on a multi-controller JAX mesh."""
    if isinstance(batch, dict):
        return {k: replicate_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(replicate_batch(v, mesh) for v in batch)
    if isinstance(batch, torch.Tensor):
        return batch.to(mesh.device)
    return batch


def _ring_kernel_pass(theta_loc, grads_loc, rsq_loc, h2, mesh):
    """The ring alternative to the gathered kernel tile: each rank's
    [grads | theta] block circulates while every rank accumulates its local
    rows' K @ [grads | theta] and row sums. Returns (attract, ktheta,
    ksum)."""
    p = theta_loc.shape[1]
    blk = torch.cat([grads_loc, theta_loc], dim=1)
    blk_rsq = rsq_loc
    acc_both = torch.zeros(theta_loc.shape[0], 2 * p, dtype=theta_loc.dtype,
                           device=theta_loc.device)
    acc_ksum = torch.zeros(theta_loc.shape[0], 1, dtype=theta_loc.dtype,
                           device=theta_loc.device)
    for r in range(mesh.size):
        D = _row_block_sq_dists(theta_loc, blk[:, p:], rsq_loc, blk_rsq)
        K = torch.exp(-D / h2 / 2.0)
        acc_both = acc_both + torch.matmul(K, blk)
        acc_ksum = acc_ksum + torch.sum(K, dim=1, keepdim=True)
        if r + 1 < mesh.size:
            blk = coll.ppermute_ring(blk, mesh)
            blk_rsq = coll.ppermute_ring(blk_rsq, mesh)
    return acc_both[:, :p], acc_both[:, p:], acc_ksum


def _ring_generic_pass(theta_loc, grads_loc, rsq_loc, h2, mesh, kernel):
    """The ring pass for a weights-kernel (``kernels/``): each visiting
    block's D gives (K, W) = kernel.weights(D, h2), and the local rows
    accumulate K @ grads, W @ theta and W's row sums. Returns (attract,
    wtheta, wsum)."""
    p = theta_loc.shape[1]
    blk = torch.cat([grads_loc, theta_loc], dim=1)
    blk_rsq = rsq_loc
    z = torch.zeros_like(theta_loc)
    acc_attract, acc_wtheta = z, z
    acc_wsum = torch.zeros(theta_loc.shape[0], 1, dtype=theta_loc.dtype,
                           device=theta_loc.device)
    for r in range(mesh.size):
        D = _row_block_sq_dists(theta_loc, blk[:, p:], rsq_loc, blk_rsq)
        K, W = kernel.weights(D, h2)
        acc_attract = acc_attract + torch.matmul(K, blk[:, :p])
        acc_wtheta = acc_wtheta + torch.matmul(W, blk[:, p:])
        acc_wsum = acc_wsum + torch.sum(W, dim=1, keepdim=True)
        if r + 1 < mesh.size:
            blk = coll.ppermute_ring(blk, mesh)
            blk_rsq = coll.ppermute_ring(blk_rsq, mesh)
    return acc_attract, acc_wtheta, acc_wsum


def _ring_kernel_pass_pallas(theta_loc, grads_loc, h2, mesh,
                             precision="f32"):
    """The ring pass with each rotation's tile streamed through kernel B3
    (ops.svgd_tile.svgd_both_ksum, at the sampler's pallas_precision), all
    about the global particle mean (one [p] psum). Returns (ku, ksum,
    center); phi = (ku + ksum (theta - center) / h2) / n."""
    n_loc, p = theta_loc.shape
    center = coll.psum(
        torch.sum(theta_loc.to(torch.float32), dim=0, keepdim=True), mesh,
    ) / (n_loc * mesh.size)
    blk = torch.cat([grads_loc, theta_loc], dim=1)
    acc_ku = torch.zeros(n_loc, p, dtype=torch.float32,
                         device=theta_loc.device)
    acc_ksum = torch.zeros(n_loc, 1, dtype=torch.float32,
                           device=theta_loc.device)
    for r in range(mesh.size):
        t_ku, t_ksum = svgd_tile.svgd_both_ksum(
            theta_loc, blk[:, p:], blk[:, :p], h2, center, precision)
        acc_ku = acc_ku + t_ku
        acc_ksum = acc_ksum + t_ksum
        if r + 1 < mesh.size:
            blk = coll.ppermute_ring(blk, mesh)
    dt = theta_loc.dtype
    return acc_ku.to(dt), acc_ksum.to(dt), center.to(dt)


def _rbf_phi_rows_xla(theta_loc, theta_all, grads_all, D_rows, h2,
                      n_particles):
    """The RBF tile of local rows against the gathered columns: K, its row
    sums and one [n_loc, n] x [n, 2p] product (ops/rbf.svgd_phi's order)."""
    p = theta_loc.shape[1]
    K_rows = torch.exp(-D_rows / h2 / 2.0)
    ksum = torch.sum(K_rows, dim=1, keepdim=True)
    both = torch.matmul(K_rows, torch.cat([grads_all, theta_all], dim=1))
    return (both[:, :p] + (ksum * theta_loc - both[:, p:]) / h2) / n_particles


def _rbf_phi_rows_pallas(theta_loc, theta_all, grads_all, h2, n_particles,
                         precision="f32"):
    """The same tile by kernel B3, centred at the gathered columns' mean."""
    return svgd_tile.svgd_phi_rect(theta_loc, theta_all, grads_all, h2,
                                   n_total=n_particles, precision=precision)


def _clip_update_aux(state, phi, log_p_vals, h2, med, gd, max_phi_norm,
                     mesh):
    """The shared tail of every mesh step: the psum'd global-norm clip
    (abstract_stein_sampler.py:125), the optimizer update, the aux dict."""
    theta_loc = state.particles
    norm = torch.sqrt(coll.psum(torch.sum(phi * phi), mesh))
    phi = phi * (max_phi_norm / torch.clamp(norm, min=max_phi_norm))
    delta, opt_state = gd.update(state.opt_state, phi)
    new_state = SVGDState(theta_loc + delta, opt_state, state.step + 1)
    aux = {"phi_norm": norm,
           "log_p_mean": coll.pmean(torch.mean(log_p_vals), mesh),
           "h2": h2, "median": med}
    return new_state, aux


def _check_divides(n_particles, mesh):
    if n_particles % mesh.size != 0:
        raise ValueError(
            f"n_particles={n_particles} must divide evenly over the "
            f"{mesh.size}-way particle axis {mesh.axis_name!r}"
        )


def make_sharded_step(log_p, unravel_fn, gd, n_particles, state, mesh,
                      median="exact", max_phi_norm=10.0, comm="all_gather",
                      median_max_rows=512, median_passes=30,
                      kernel_impl="xla", custom_grads=None,
                      pallas_precision="f32", kernel=None, remat=False,
                      binned_bins=4096, binned_block_rows=256):
    """Build (step_fn, local_state): step_fn(local_state, batch) ->
    (local_state, aux) is the cold mesh step every rank runs on its block;
    local_state is this rank's block of the full ``state``.

    ``median='binned'`` psums the histograms of the local rows against the
    gathered columns (``binned_median``; ``binned_bins`` bins a level, row
    blocks of ``binned_block_rows``), or with comm='ring' against each
    circulating block (``ring_binned_median``, ``binned_bins`` only).

    ``kernel_impl='pallas'`` streams the tiles through kernel B3: local rows
    against the gathered columns, or one [n_loc, n_loc] tile per ring
    rotation, at ``pallas_precision``. It needs the bisect median (the tile
    never materialises the rows median='exact' sorts). A ``kernel`` other
    than exactly SquaredExponentialKernel takes the generic weights-kernel
    tile (``stein_tpu/parallel/sharded.py:307``)."""
    from ..kernels import SquaredExponentialKernel
    if type(kernel) is SquaredExponentialKernel:
        kernel = None    # the fused RBF path
    _check_divides(n_particles, mesh)
    grad_all = _make_grad_all(log_p, unravel_fn, custom_grads, remat)
    if comm not in ("all_gather", "ring"):
        raise ValueError(f"unknown comm mode: {comm!r}")
    if kernel_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown kernel_impl: {kernel_impl!r}")
    if kernel_impl == "pallas" and kernel is not None:
        raise ValueError(
            "kernel_impl='pallas' implements the fused RBF tile only; "
            "custom kernels use kernel_impl='xla' (the generic two-matmul "
            "tile path)"
        )
    if kernel_impl == "pallas" and median not in ("bisect", "binned"):
        raise ValueError(
            f"kernel_impl='pallas' requires a gather-free median ('bisect' "
            f"or 'binned', got {median!r}): the streaming tile does not "
            "materialise the [n_loc, n] rows median='exact' sorts"
        )
    if median == "exact":
        check_exact_median_gather(
            n_particles, state.particles.dtype, "mesh",
            "median='bisect' (exact to fp-bisection resolution, no "
            "gather) or median='binned' (psum'd histogram)",
        )
    if comm == "ring" and median not in ("binned", "bisect"):
        raise ValueError(
            f"comm='ring' supports median='bisect' (the ring-assembled "
            f"strided row block) or 'binned', got {median!r}: the ring never "
            "assembles the global column block the other median modes need"
        )
    if median not in ("exact", "bisect", "binned"):
        raise ValueError(f"unknown sharded median mode: {median!r} (use "
                         "'exact', 'bisect', or 'binned')")

    def step_fn(state, batch):
        theta_loc = state.particles
        log_p_vals, grads_loc = grad_all(theta_loc, batch)
        rsq_loc = torch.sum(theta_loc * theta_loc, dim=1)
        if comm == "ring":
            if median == "bisect":
                med = ring_bisect_median(theta_loc, mesh,
                                         max_rows=median_max_rows,
                                         passes=median_passes)
            else:
                med = ring_binned_median(theta_loc, mesh, n_bins=binned_bins)
            h2 = rbf.bandwidth_sq_from_median(med.to(theta_loc.dtype),
                                              n_particles)
            if kernel_impl == "pallas":
                ku, ksum, c = _ring_kernel_pass_pallas(
                    theta_loc, grads_loc, h2, mesh, pallas_precision)
                phi = (ku + ksum * (theta_loc - c) / h2) / n_particles
            elif kernel is None:
                attract, ktheta, ksum = _ring_kernel_pass(
                    theta_loc, grads_loc, rsq_loc, h2, mesh)
                phi = (attract + (ksum * theta_loc - ktheta) / h2) \
                    / n_particles
            else:
                attract, wtheta, wsum = _ring_generic_pass(
                    theta_loc, grads_loc, rsq_loc, h2, mesh, kernel)
                phi = (attract + (wsum * theta_loc - wtheta)) / n_particles
        else:
            theta_all = coll.all_gather(theta_loc, mesh)
            grads_all = coll.all_gather(grads_loc, mesh)
            D_rows = None
            if kernel_impl == "xla":
                D_rows = _row_block_sq_dists(
                    theta_loc, theta_all, rsq_loc,
                    torch.sum(theta_all * theta_all, dim=1))
            if median == "exact":
                med = exact_median(coll.all_gather(D_rows, mesh))
            elif median == "bisect":
                med = sharded_bisect_median(theta_loc, theta_all, mesh,
                                            max_rows=median_max_rows,
                                            passes=median_passes)
            else:
                med = binned_median(theta_loc, n_bins=binned_bins,
                                    block_rows=binned_block_rows, mesh=mesh,
                                    theta_cols=theta_all)
            h2 = rbf.bandwidth_sq_from_median(med.to(theta_loc.dtype),
                                              n_particles)
            if kernel_impl == "pallas":
                phi = _rbf_phi_rows_pallas(theta_loc, theta_all, grads_all,
                                           h2, n_particles, pallas_precision)
            elif kernel is None:
                phi = _rbf_phi_rows_xla(theta_loc, theta_all, grads_all,
                                        D_rows, h2, n_particles)
            else:
                # The generic tile: K and W differ, so the attractive and
                # repulsive products cannot share one matmul (the order of
                # kernels.generic_svgd_phi).
                K_rows, W_rows = kernel.weights(D_rows, h2)
                wsum = torch.sum(W_rows, dim=1, keepdim=True)
                attract = torch.matmul(K_rows, grads_all)
                wtheta = torch.matmul(W_rows, theta_all)
                phi = (attract + (wsum * theta_loc - wtheta)) / n_particles
        return _clip_update_aux(state, phi, log_p_vals, h2, med, gd,
                                max_phi_norm, mesh)

    return step_fn, shard_state(state, mesh)


def make_sharded_warm_step(log_p, unravel_fn, gd, n_particles, mesh,
                           max_phi_norm=10.0, median_max_rows=512,
                           median_passes=30, warm_passes=8,
                           kernel_impl="xla", comm="all_gather",
                           custom_grads=None, pallas_precision="f32",
                           remat=False):
    """The warm-median mesh step for ``run``: the carry is (local_state,
    med_prev) and the bandwidth search refines the previous median inside a
    count-verified bracket, its counts psum'd (ops/median.
    sharded_warm_bisect_median, or ring_warm_bisect_median with
    comm='ring'). Returns (warm_step_fn, init_med_fn); init_med_fn(theta_loc)
    is the cold sharded bisect that seeds the carry."""
    _check_divides(n_particles, mesh)
    if kernel_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown kernel_impl: {kernel_impl!r}")
    if comm not in ("all_gather", "ring"):
        raise ValueError(f"unknown comm mode: {comm!r}")
    grad_all = _make_grad_all(log_p, unravel_fn, custom_grads, remat)

    def warm_step_fn(carry, batch):
        state, med_prev = carry
        theta_loc = state.particles
        log_p_vals, grads_loc = grad_all(theta_loc, batch)
        if comm == "ring":
            med = ring_warm_bisect_median(theta_loc, med_prev, mesh,
                                          max_rows=median_max_rows,
                                          warm_passes=warm_passes)
            h2 = rbf.bandwidth_sq_from_median(med.to(theta_loc.dtype),
                                              n_particles)
            if kernel_impl == "pallas":
                ku, ksum, c = _ring_kernel_pass_pallas(
                    theta_loc, grads_loc, h2, mesh, pallas_precision)
                phi = (ku + ksum * (theta_loc - c) / h2) / n_particles
            else:
                attract, ktheta, ksum = _ring_kernel_pass(
                    theta_loc, grads_loc,
                    torch.sum(theta_loc * theta_loc, dim=1), h2, mesh)
                phi = (attract + (ksum * theta_loc - ktheta) / h2) \
                    / n_particles
        else:
            theta_all = coll.all_gather(theta_loc, mesh)
            grads_all = coll.all_gather(grads_loc, mesh)
            if kernel_impl == "pallas":
                med = sharded_warm_bisect_median(
                    theta_loc, theta_all, med_prev, mesh,
                    max_rows=median_max_rows, warm_passes=warm_passes)
                h2 = rbf.bandwidth_sq_from_median(med.to(theta_loc.dtype),
                                                  n_particles)
                phi = _rbf_phi_rows_pallas(theta_loc, theta_all, grads_all,
                                           h2, n_particles, pallas_precision)
            else:
                D_rows = _row_block_sq_dists(
                    theta_loc, theta_all,
                    torch.sum(theta_loc * theta_loc, dim=1),
                    torch.sum(theta_all * theta_all, dim=1))
                med = sharded_warm_bisect_median_on_D(
                    D_rows, med_prev, mesh, max_rows=median_max_rows,
                    warm_passes=warm_passes)
                h2 = rbf.bandwidth_sq_from_median(med.to(theta_loc.dtype),
                                                  n_particles)
                phi = _rbf_phi_rows_xla(theta_loc, theta_all, grads_all,
                                        D_rows, h2, n_particles)
        new_state, aux = _clip_update_aux(state, phi, log_p_vals, h2, med,
                                          gd, max_phi_norm, mesh)
        return (new_state, med.to(theta_loc.dtype)), aux

    def init_med_fn(theta_loc):
        # The cold seed honours the comm mode: the ring circulates the
        # column blocks where all_gather gathers [n, p] once.
        if comm == "ring":
            return ring_bisect_median(theta_loc, mesh,
                                      max_rows=median_max_rows,
                                      passes=median_passes)
        return sharded_bisect_median(theta_loc,
                                     coll.all_gather(theta_loc, mesh), mesh,
                                     max_rows=median_max_rows,
                                     passes=median_passes)

    return warm_step_fn, init_med_fn
