from .ravel import (
    template_unraveler,
    ravel_particles,
    unravel_particles,
    init_particles,
)
from .convert import state_from_numpy

__all__ = [
    "template_unraveler",
    "ravel_particles",
    "unravel_particles",
    "init_particles",
    "state_from_numpy",
]
