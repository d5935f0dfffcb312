"""stein_tpu_torch — the stein_tpu SVGD engine ported to PyTorch and CUDA.

A second package beside the JAX one (``stein_tpu``), which stays the
reference: module paths and public names follow it, so every module here
names its counterpart. Plain tensor code is PyTorch; the JAX package's Pallas
kernels on the main path are hand-written CUDA kernels for Hopper
(``csrc/``), built with nvcc at their first use. The package imports torch
and never jax.
"""

from .version import __version__
from .api import (
    SVGDSampler,
    SVGDState,
    SteinSampler,
    throughput_config,
)
from .kernels import InverseMultiquadricKernel, SquaredExponentialKernel
from .models import BayesianNNModel, LogisticRegressionModel
from .ops.fused_step import InKernelModel
from .ops.optimizers import (
    Adam,
    Adagrad,
    AdamGradientDescent,
    AdagradGradientDescent,
)

__all__ = [
    "__version__",
    "SVGDSampler",
    "SVGDState",
    "SteinSampler",
    "throughput_config",
    "InKernelModel",
    "BayesianNNModel",
    "LogisticRegressionModel",
    "Adam",
    "Adagrad",
    "AdamGradientDescent",
    "AdagradGradientDescent",
    "SquaredExponentialKernel",
    "InverseMultiquadricKernel",
]
