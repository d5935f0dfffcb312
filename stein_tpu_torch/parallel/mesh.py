"""The particle meshes over ``torch.distributed``: 1-D and 2-D.

PyTorch counterpart of ``stein_tpu/parallel/mesh.py``. Where the JAX package
shards the particle axis over a ``jax.sharding.Mesh`` of devices, the port
runs one process per device: a ``ParticleMesh`` is a process group (NCCL
for CUDA tensors, gloo for CPU ones), its axis name, its size and this
process's index on it. Every process builds the same sampler and keeps its
own block of particles; ``parallel/collectives.py`` holds the collectives
the mesh steps call.

A ``Mesh2D`` is the JAX package's ``Mesh(devices.reshape(dp, mp),
("particles", "model"))``: global rank r sits at (r // mp, r % mp), and
each axis is a ``ParticleMesh`` over the ranks that share r's index on the
other axis (``mesh_2d`` builds it).
"""

import dataclasses
from typing import Any

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class ParticleMesh:
    """A 1-D particle mesh: ``size`` processes of ``group``, this one at
    ``rank``, holding tensors of ``device_type`` ('cuda' under NCCL, 'cpu'
    under gloo)."""

    group: Any
    axis_name: str
    size: int
    rank: int
    device_type: str

    @property
    def device(self):
        """This process's device on the mesh (its current card under
        NCCL)."""
        if self.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.device_type)


_BACKEND_DEVICE = {"nccl": "cuda", "gloo": "cpu"}


def particle_mesh(group=None, axis_name="particles"):
    """The mesh over ``group`` (default: the default process group, which
    must be initialised, e.g. by ``setup_distributed``)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "particle_mesh: torch.distributed is not initialised; call "
            "stein_tpu_torch.parallel.setup_distributed first"
        )
    backend = str(dist.get_backend(group))
    if backend not in _BACKEND_DEVICE:
        raise ValueError(
            f"particle_mesh: backend {backend!r} is not supported (nccl for "
            "CUDA tensors, gloo for CPU tensors)"
        )
    return ParticleMesh(group, axis_name, dist.get_world_size(group),
                        dist.get_rank(group), _BACKEND_DEVICE[backend])


def setup_distributed(backend=None, init_method=None, world_size=None,
                      rank=None, store=None, device_id=None):
    """Initialise ``torch.distributed`` once per process (a thin wrapper of
    ``init_process_group``). ``backend`` defaults to NCCL when a card is
    present, else gloo. Give either ``init_method`` (e.g.
    ``tcp://localhost:<port>``) with ``world_size`` and ``rank``, or a
    ``store`` (a one-process group needs only ``dist.HashStore()``), or
    neither, to read the ``MASTER_ADDR``/``RANK`` environment. Returns
    (rank, world_size), as the JAX package's returns (process_index,
    process_count)."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if store is not None:
        kw["store"] = store
    if init_method is not None:
        kw["init_method"] = init_method
    if world_size is not None:
        kw.update(world_size=world_size, rank=rank)
    if device_id is not None:
        kw["device_id"] = device_id
    dist.init_process_group(backend, **kw)
    return dist.get_rank(), dist.get_world_size()


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A 2-D (particles x model) mesh: ``particles`` is this rank's
    particle axis (the ranks of its model index, ``dp`` of them),
    ``model`` its model axis (the ranks of its particle index, ``mp``).
    ``axis_names`` and ``shape`` read as a ``jax.sharding.Mesh``'s."""

    particles: ParticleMesh
    model: ParticleMesh

    @property
    def axis_names(self):
        return (self.particles.axis_name, self.model.axis_name)

    @property
    def shape(self):
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return {self.particles.axis_name: self.particles.size,
                self.model.axis_name: self.model.size}

    @property
    def rank(self):
        """This process's global rank on the mesh, i * mp + j."""
        return self.particles.rank * self.model.size + self.model.rank

    @property
    def device_type(self):
        return self.particles.device_type

    @property
    def device(self):
        return self.particles.device

    def axis(self, name):
        """The ``ParticleMesh`` of the axis called ``name``."""
        for m in (self.particles, self.model):
            if m.axis_name == name:
                return m
        raise ValueError(f"the mesh has axes {self.axis_names}, not "
                         f"{name!r}")


def mesh_2d(dp, mp, backend=None, axis_names=("particles", "model")):
    """The 2-D mesh of ``dp * mp`` processes (the default group's, which
    must be initialised): rank r at (r // mp, r % mp). ``backend`` is the
    subgroups' (default: the default group's; gloo gives a CPU mesh beside
    an NCCL default group). Every process must call this, with the same
    arguments: it creates a group for every row and every column, all in
    one order on every rank, as ``dist.new_group`` requires."""
    if not dist.is_initialized():
        raise RuntimeError(
            "mesh_2d: torch.distributed is not initialised; call "
            "stein_tpu_torch.parallel.setup_distributed first"
        )
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp * mp != world:
        raise ValueError(f"mesh_2d: {dp} x {mp} = {dp * mp} ranks, the "
                         f"default group has {world}")
    kw = {} if backend is None else {"backend": backend}
    rows = [dist.new_group([i * mp + j for j in range(mp)], **kw)
            for i in range(dp)]
    cols = [dist.new_group([i * mp + j for i in range(dp)], **kw)
            for j in range(mp)]
    i, j = divmod(rank, mp)
    return Mesh2D(particle_mesh(cols[j], axis_names[0]),
                  particle_mesh(rows[i], axis_names[1]))
