"""Particle-sharded SVGD over ``torch.distributed`` (counterpart of
``stein_tpu/parallel``): the mesh (``mesh.py``), its collectives
(``collectives.py``), the mesh steps (``sharded.py``, ``sharded_fused.py``).
The 2-D (particles x model) mesh is not ported yet."""

from .mesh import ParticleMesh, particle_mesh, setup_distributed

__all__ = ["ParticleMesh", "particle_mesh", "setup_distributed"]
