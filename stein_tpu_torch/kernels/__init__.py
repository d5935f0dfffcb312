from .kernels import (
    SquaredExponentialKernel,
    InverseMultiquadricKernel,
    generic_svgd_phi,
)

__all__ = [
    "SquaredExponentialKernel",
    "InverseMultiquadricKernel",
    "generic_svgd_phi",
]
