"""Reference-compatible import path (stein/samplers/__init__.py:1;
``stein_tpu/samplers.py``):

    from stein_tpu_torch.samplers import SteinSampler
"""

from .api import SVGDSampler, SVGDState, SteinSampler

__all__ = ["SVGDSampler", "SVGDState", "SteinSampler"]
