"""Particle-sharded SVGD over ``torch.distributed`` (counterpart of
``stein_tpu/parallel``): the meshes (``mesh.py``: the 1-D
``ParticleMesh`` and the 2-D ``Mesh2D``), their collectives
(``collectives.py``) and the mesh steps (``sharded.py``,
``sharded_fused.py``, ``sharded2d.py``).

The steps import ``..api``, which imports this package's collectives, so
their names load on first use (a module ``__getattr__``)."""

from .mesh import (
    Mesh2D,
    ParticleMesh,
    mesh_2d,
    particle_mesh,
    setup_distributed,
)

_LAZY = {
    "make_sharded_step": "sharded",
    "shard_state": "sharded",
    "replicate_batch": "sharded",
    "make_sharded2d_step": "sharded2d",
    "make_sharded2d_warm_step": "sharded2d",
    "shard_state_2d": "sharded2d",
}

__all__ = ["ParticleMesh", "particle_mesh", "setup_distributed", "Mesh2D",
           "mesh_2d", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        import importlib
        module = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
