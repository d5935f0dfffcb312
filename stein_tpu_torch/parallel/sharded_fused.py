"""The fused mesh step (step_impl='fused_shard'): the single-device fused
tail split at its collectives.

PyTorch counterpart of ``stein_tpu/parallel/sharded_fused.py``. Per rank,
with comm='all_gather':

  gradients   torch.func (or custom_grads; or none with quadratic_form)
  coll 1      all_gather theta and gradients (theta only with
              quadratic_form: the gradients b - theta A come from the
              gathered block by one matmul)
  KERNEL      the bracket pass: the median block's centred Gram, its range
              and bracket counts (B8, median_collectives='rounds'), or its
              counts at every candidate's grid (B9, 'grid')
  coll 2      'rounds': one pmax, one psum, then a psum per quad-ary round
              over the emitted D; 'grid': one psum, then one g2-ary round
  KERNEL      the streaming tile (B3) against the gathered block, about the
              same centre
  coll 3      psum of the local ||phi||^2 (the global clip,
              abstract_stein_sampler.py:125)
  tail        phi combine, clip and optimizer (epilogue='xla'), or kernel
              B6 (epilogue='fused')

With comm='ring' nothing is gathered: each rank's [m_loc, p] median-row
packet circulates and every rotation runs B9 on (visiting rows x local
columns), banking the block in a [m_global, n_loc] buffer; then the tiles
circulate [n_loc, 2p] blocks ([n_loc, p] with quadratic_form). The centre is
one [p] psum and the fallback bound one pmax there.

One centre anchors every in-kernel Gram of a step (bracket pass, tiles,
combine): the mean of the gathered block, computed alike on every rank, or
the psum'd mean on the ring. Every rank agrees bitwise on the median, h^2
and the clip norm, since each comes from psum'd integer counts or from the
same gathered block reduced the same way.
"""

import torch

from ..api import SVGDState, _make_grad_all
from ..ops import rbf, svgd_tile
from ..ops.fused_median import (
    bracket_pass_fits,
    fused_bracket_grid_pass,
    fused_bracket_pass,
)
from ..ops.fused_step import fused_epilogue
from ..ops.median import (
    DEFAULT_BRACKETS,
    _count_dtype,
    _local_row_idx,
    ring_bisect_median,
    sharded_bisect_median,
    sharded_warm_from_bracket,
    sharded_warm_from_grid,
)
from ..utils.profiling import annotate
from . import collectives as coll
from .sharded import _check_divides


def make_sharded_fused_warm_step(log_p, unravel_fn, gd, n_particles, state,
                                 mesh, max_phi_norm=10.0, median_max_rows=512,
                                 median_passes=30, warm_passes=8,
                                 brackets=DEFAULT_BRACKETS, epilogue="xla",
                                 quadratic_form=None,
                                 median_collectives="grid", median_grid_g1=16,
                                 comm="all_gather", custom_grads=None,
                                 remat=False):
    """Build (warm_step_fn, init_med_fn), the contract of
    parallel.sharded.make_sharded_warm_step, for the fused mesh step. f32,
    the RBF kernel and a 1-D particle mesh (the sampler guards the rest).
    Numerics: the fused_gram class (the in-kernel centred Gram feeds both
    the median counts and the tiles). ``state`` is read for p only.

    ``quadratic_form(batch) -> (A_eff, b_eff, const)`` (a model with log_p =
    -0.5 w^T A w + b^T w + const) gathers theta only and derives the
    gradients b - theta A from the gathered block (on the ring, from each
    visiting block); log_p values come from the local rows' quadratics.
    ``median_collectives`` 'grid' is the two-psum search (B9 +
    ops.median.sharded_warm_from_grid), 'rounds' the pmax + psum + one psum
    per quad-ary round chain (B8 + sharded_warm_from_bracket); the ring is
    grid-only."""
    _check_divides(n_particles, mesh)
    if epilogue not in ("fused", "xla"):
        raise ValueError(f"unknown epilogue mode: {epilogue!r}")
    if median_collectives not in ("grid", "rounds"):
        raise ValueError(
            f"unknown median_collectives mode: {median_collectives!r}"
        )
    if comm not in ("all_gather", "ring"):
        raise ValueError(f"unknown comm mode: {comm!r}")
    if comm == "ring" and median_collectives != "grid":
        raise ValueError(
            "comm='ring' fused_shard supports median_collectives='grid' "
            "only (the rounds chain would re-count the ring D buffer once "
            "per quad-ary round for strictly more collectives)"
        )
    n_loc = n_particles // mesh.size
    p = state.particles.shape[1]
    m_loc = max(min(median_max_rows // mesh.size, n_loc), 1)
    # Ring blocks are (visiting rows x local columns).
    n_cols_blk = n_loc if comm == "ring" else n_particles
    if not bracket_pass_fits(m_loc, n_cols_blk, p):
        raise ValueError(
            "step_impl='fused_shard': the fused bracket pass's "
            f"[{m_loc}, {n_cols_blk}] median block (+ operands) exceeds the "
            "JAX package's gate; lower median_max_rows or use the unfused "
            "mesh step (step_impl='xla')"
        )
    grad_all = _make_grad_all(log_p, unravel_fn, custom_grads, remat)

    def finish(state, theta_loc, ku, ksum, center, h2, med, log_p_vals):
        """The phi combine, the psum'd global clip and the update (one
        span, svgd.update)."""
        with annotate("svgd.update"):
            phi = (ku + ksum * (theta_loc - center) / h2) / n_particles
            norm = torch.sqrt(coll.psum(torch.sum(phi * phi), mesh))
            if epilogue == "fused":
                new_theta, opt_state = fused_epilogue(
                    ku, ksum, theta_loc, center, h2, norm, state.opt_state,
                    gd, max_phi_norm=max_phi_norm, n_total=n_particles)
            else:
                delta, opt_state = gd.update(
                    state.opt_state,
                    phi * (max_phi_norm / torch.clamp(norm,
                                                      min=max_phi_norm)))
                new_theta = theta_loc + delta
            aux = {"phi_norm": norm,
                   "log_p_mean": coll.pmean(torch.mean(log_p_vals), mesh),
                   "h2": h2, "median": med}
            return ((SVGDState(new_theta, opt_state, state.step + 1), med),
                    aux)

    def gathered_step(carry, batch):
        state, med_prev = carry
        theta_loc = state.particles
        with annotate("svgd.grad"):   # the gathers too
            if quadratic_form is not None:
                A_eff, b_eff, const = quadratic_form(batch)
                theta_all = coll.all_gather(theta_loc, mesh)
                G_all = torch.matmul(theta_all, A_eff)
                grads_all = b_eff.reshape(1, -1) - G_all
                G_loc = G_all[mesh.rank * n_loc:(mesh.rank + 1) * n_loc]
                log_p_vals = torch.sum(
                    theta_loc * (b_eff.reshape(1, -1) - 0.5 * G_loc), dim=1
                ) + const
            else:
                log_p_vals, grads_loc = grad_all(theta_loc, batch)
                theta_all = coll.all_gather(theta_loc, mesh)
                grads_all = coll.all_gather(grads_loc, mesh)
        with annotate("svgd.median"):
            center = torch.mean(theta_all, dim=0, keepdim=True)
            idx, m_global = _local_row_idx(n_loc, mesh, median_max_rows,
                                           theta_loc.device)
            total = m_global * n_particles
            if median_collectives == "grid":
                # The fallback range's bound from the gathered block, alike
                # on every rank: |a - b|^2 <= 4 max |x - c|^2, with headroom.
                rsq_all = torch.sum((theta_all - center) ** 2, dim=1)
                hi_bound = 4.0 * torch.max(rsq_all) * 1.0001 + 1e-30
                D_sub, cnts = fused_bracket_grid_pass(
                    theta_loc[idx], theta_all, med_prev, center, hi_bound,
                    brackets=brackets, g1=median_grid_g1)
                med = sharded_warm_from_grid(
                    D_sub, med_prev, cnts, hi_bound, mesh, total=total,
                    warm_passes=warm_passes, brackets=brackets,
                    g1=median_grid_g1)
            else:
                D_sub, mm, cnts = fused_bracket_pass(
                    theta_loc[idx], theta_all, med_prev, center,
                    brackets=brackets)
                med = sharded_warm_from_bracket(
                    D_sub, med_prev, mm, cnts, mesh, total=total,
                    warm_passes=warm_passes, brackets=brackets)
        with annotate("svgd.phi"):
            h2 = rbf.bandwidth_sq_from_median(med, n_particles)
            ku, ksum = svgd_tile.svgd_both_ksum(theta_loc, theta_all,
                                                grads_all, h2, center)
        return finish(state, theta_loc, ku, ksum, center, h2, med,
                      log_p_vals)

    def ring_step(carry, batch):
        state, med_prev = carry
        theta_loc = state.particles
        if quadratic_form is not None:
            A_eff, b_eff, const = quadratic_form(batch)
            b_row = b_eff.reshape(1, -1)
            G_loc = torch.matmul(theta_loc, A_eff)
            log_p_vals = torch.sum(theta_loc * (b_row - 0.5 * G_loc),
                                   dim=1) + const
        else:
            log_p_vals, grads_loc = grad_all(theta_loc, batch)
        # No gathered block here: the centre is one [p] psum and the
        # fallback bound one pmax.
        center = coll.psum(torch.sum(theta_loc.to(torch.float32), dim=0,
                                     keepdim=True), mesh) / n_particles
        rsq_loc = torch.sum((theta_loc - center) ** 2, dim=1)
        hi_bound = 4.0 * coll.pmax(torch.max(rsq_loc), mesh) * 1.0001 + 1e-30

        # The median: circulate each rank's row packet; every rotation
        # counts the same grid edges on (visiting rows x local columns),
        # adds the counts and banks its block at the packet's source slot.
        idx, m_global = _local_row_idx(n_loc, mesh, median_max_rows,
                                       theta_loc.device)
        total = m_global * n_particles
        m = idx.shape[0]
        D_buf = torch.empty(m_global, n_loc, dtype=torch.float32,
                            device=theta_loc.device)
        cnts_loc = 0
        rows = theta_loc[idx]
        for t in range(mesh.size):
            D_blk, cnts = fused_bracket_grid_pass(
                rows, theta_loc, med_prev, center, hi_bound,
                brackets=brackets, g1=median_grid_g1)
            src = (mesh.rank - t) % mesh.size
            D_buf[src * m:(src + 1) * m] = D_blk
            # Accumulate in the global total's count type (f32 past 2^31).
            cnts_loc = cnts_loc + cnts.to(_count_dtype(total))
            if t + 1 < mesh.size:
                rows = coll.ppermute_ring(rows, mesh)
        med = sharded_warm_from_grid(
            D_buf, med_prev, cnts_loc, hi_bound, mesh, total=total,
            warm_passes=warm_passes, brackets=brackets, g1=median_grid_g1)
        h2 = rbf.bandwidth_sq_from_median(med, n_particles)

        # The tiles: [grads | theta] circulates (theta only with a
        # quadratic form, each visiting block's gradients recomputed).
        ku = torch.zeros(n_loc, p, dtype=torch.float32,
                         device=theta_loc.device)
        ksum = torch.zeros(n_loc, 1, dtype=torch.float32,
                           device=theta_loc.device)
        blk = theta_loc if quadratic_form is not None else \
            torch.cat([grads_loc, theta_loc], dim=1)
        for t in range(mesh.size):
            if quadratic_form is not None:
                theta_blk = blk
                grads_blk = b_row - torch.matmul(theta_blk, A_eff)
            else:
                theta_blk, grads_blk = blk[:, p:], blk[:, :p]
            t_ku, t_ksum = svgd_tile.svgd_both_ksum(
                theta_loc, theta_blk, grads_blk, h2, center)
            ku = ku + t_ku
            ksum = ksum + t_ksum
            if t + 1 < mesh.size:
                blk = coll.ppermute_ring(blk, mesh)
        return finish(state, theta_loc, ku, ksum, center, h2, med,
                      log_p_vals)

    if comm == "ring":
        # The cold seed without a gather either: the ring search.
        def init_med_fn(theta_loc):
            return ring_bisect_median(theta_loc, mesh,
                                      max_rows=median_max_rows,
                                      passes=median_passes)
    else:
        def init_med_fn(theta_loc):
            return sharded_bisect_median(
                theta_loc, coll.all_gather(theta_loc, mesh), mesh,
                max_rows=median_max_rows, passes=median_passes)

    return (ring_step if comm == "ring" else gathered_step), init_med_fn
