from .ravel import (
    template_unraveler,
    ravel_particles,
    unravel_particles,
    init_particles,
)
from .convert import state_from_numpy
from .checkpoint import save_checkpoint, restore_checkpoint
from .metrics import MetricsLogger
from .cache import enable_compilation_cache

__all__ = [
    "template_unraveler",
    "ravel_particles",
    "unravel_particles",
    "init_particles",
    "state_from_numpy",
    "save_checkpoint",
    "restore_checkpoint",
    "MetricsLogger",
    "enable_compilation_cache",
]
