"""The collectives of the particle mesh, over ``torch.distributed``.

The JAX mesh code calls ``jax.lax`` primitives inside ``shard_map``; the port
calls these, each with the ``ParticleMesh`` in place of the axis name:

    all_gather(x, mesh)      jax.lax.all_gather(x, axis, tiled=True)
    all_gather(x, mesh, dim=1)   the same, concatenated along axis 1
    psum, pmax, pmin, pmean  jax.lax.psum / pmax / pmin / pmean
    ppermute_ring(x, mesh)   jax.lax.ppermute(x, axis, [(j, j + 1 mod n)])
    axis_index, axis_size    jax.lax.axis_index / axis_size

On a ``Mesh2D`` (the 2-D mesh), ``all_gather`` and ``psum`` run over both
axes: the [n_loc, p_loc] blocks become the full [n, p], and a sum covers
every rank.

Each returns a new tensor (``torch.distributed`` reduces in place, so the
input is copied first) and leaves the input as it was. Reductions and
gathers run through the backend at any size, so a one-process NCCL group
drives the same calls as a real mesh; at size 1 their result is the input,
JAX's semantics of a one-device axis. The ring's self-send at size 1 is not
sent at all (NCCL does not send to its own rank outside a group call). Every
rank of the group must make the same calls in the same order.
"""

import torch
import torch.distributed as dist

from .mesh import Mesh2D

# torch 2.13 renamed all_gather_into_tensor (which it still has, with a
# deprecation warning); older releases have only the old name.
_all_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def _check(x, mesh):
    if x.device.type != mesh.device_type:
        raise ValueError(
            f"collective on a {x.device.type} tensor over a mesh of "
            f"{mesh.device_type} tensors"
        )
    return x.contiguous()


def axis_index(mesh):
    """This process's index on the particle axis."""
    return mesh.rank


def axis_size(mesh):
    """The number of processes on the particle axis."""
    return mesh.size


def all_gather(x, mesh, tiled=True, dim=0):
    """The blocks of every rank in rank order, concatenated along axis
    ``dim`` (``tiled=True``; a 0-d x gives [size]) or stacked along a new
    leading axis ([size, *x.shape]). On a ``Mesh2D``, this rank's [n_loc,
    p_loc] block becomes the full [n, p]."""
    if isinstance(mesh, Mesh2D):
        return all_gather(all_gather(x, mesh.model, dim=1), mesh.particles)
    x = _check(x, mesh)
    if not tiled or x.dim() == 0:
        x = x.reshape(1, *x.shape)
    out = torch.empty((mesh.size * x.shape[0], *x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _all_gather_single(out, x, group=mesh.group)
    if tiled and dim != 0:
        parts = out.reshape(mesh.size, *x.shape)
        out = torch.cat(list(parts.unbind(0)), dim=dim)
    return out


def _all_reduce(x, mesh, op):
    out = _check(x, mesh).clone()
    dist.all_reduce(out, op=op, group=mesh.group)
    return out


def psum(x, mesh):
    """The sum over the ranks (0-d or 1-d; int32 or f32); on a ``Mesh2D``
    over the particle axis, then the model axis."""
    if isinstance(mesh, Mesh2D):
        return psum(psum(x, mesh.particles), mesh.model)
    return _all_reduce(x, mesh, dist.ReduceOp.SUM)


def pmax(x, mesh):
    """The elementwise maximum over the ranks."""
    return _all_reduce(x, mesh, dist.ReduceOp.MAX)


def pmin(x, mesh):
    """The elementwise minimum over the ranks."""
    return _all_reduce(x, mesh, dist.ReduceOp.MIN)


def pmean(x, mesh):
    """psum(x) / size, as JAX's pmean."""
    return psum(x, mesh) / mesh.size


def ppermute_ring(x, mesh):
    """Rank j's block, received by rank j + 1 (mod size): each rank returns
    the block of rank j - 1."""
    if mesh.size == 1:
        return x
    x = _check(x, mesh)
    out = torch.empty_like(x)
    nxt = dist.get_global_rank(mesh.group, (mesh.rank + 1) % mesh.size) \
        if mesh.group is not None else (mesh.rank + 1) % mesh.size
    prv = dist.get_global_rank(mesh.group, (mesh.rank - 1) % mesh.size) \
        if mesh.group is not None else (mesh.rank - 1) % mesh.size
    ops = [dist.P2POp(dist.isend, x, nxt, mesh.group),
           dist.P2POp(dist.irecv, out, prv, mesh.group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out
