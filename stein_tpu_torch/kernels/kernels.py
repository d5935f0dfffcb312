"""Pluggable kernel layer, in PyTorch.

PyTorch counterpart of ``stein_tpu/kernels/kernels.py`` (the reference's
AbstractKernel / SquaredExponentialKernel hierarchy,
stein/kernels/abstract_kernel.py:17-62, squared_exponential_kernel.py:18-35).
A kernel supplies, from the squared-distance matrix D and the
median-heuristic bandwidth^2:

- ``K``: the kernel matrix (the SVGD attractive weights), and
- ``W``: the repulsive weight matrix, such that the repulsive term is
  ``dK_i = sum_j W_ij (theta_i - theta_j) = rowsum(W)_i theta_i - (W @
  theta)_i``.

For the RBF kernel W = K / h^2, and the sampler takes its fused paths (and
their kernels on a card); any other kernel takes the generic two-matrix path
below, plain ``torch.matmul``s as the JAX package computes it outside any
Pallas kernel.
"""

import dataclasses

import torch

from ..ops import rbf
from ..ops.median import exact_median


@dataclasses.dataclass(frozen=True)
class SquaredExponentialKernel:
    """RBF kernel K = exp(-D / h^2 / 2) (squared_exponential_kernel.py:22);
    counterpart of ``stein_tpu/kernels/kernels.py:31``."""

    def weights(self, D, h2):
        K = torch.exp(-D / h2 / 2.0)
        return K, K / h2

    def kernel_and_grad(self, theta, median_fn=exact_median):
        """Reference-compatible surface: (K, dK) for an [n, p] particle
        matrix (squared_exponential_kernel.py:25-35)."""
        K, dK, _ = rbf.rbf_kernel_and_repulse(theta, median_fn=median_fn)
        return K, dK


@dataclasses.dataclass(frozen=True)
class InverseMultiquadricKernel:
    """IMQ kernel k(x, y) = (c^2 + ||x-y||^2 / h^2)^beta with beta < 0;
    counterpart of ``stein_tpu/kernels/kernels.py:47``.

    W_ij = -(2 beta / h^2) (c^2 + D_ij/h^2)^(beta-1) >= 0 for beta < 0.
    """

    c: float = 1.0
    beta: float = -0.5

    def __post_init__(self):
        # beta >= 0 turns the repulsion into attraction; c == 0 puts
        # 0^beta = inf on the diagonal (D_ii = 0).
        if not self.beta < 0.0:
            raise ValueError(
                f"InverseMultiquadricKernel needs beta < 0 (got "
                f"{self.beta}): beta >= 0 makes the repulsive weights "
                "W <= 0 — that is a multiquadric, not an IMQ Stein "
                "kernel"
            )
        if self.c == 0.0:
            raise ValueError(
                "InverseMultiquadricKernel needs c != 0: c = 0 makes "
                "k(x, x) = 0^beta = inf on the diagonal"
            )

    def weights(self, D, h2):
        base = self.c ** 2 + D / h2
        K = base ** self.beta
        W = (-2.0 * self.beta / h2) * base ** (self.beta - 1.0)
        return K, W

    def kernel_and_grad(self, theta, median_fn=exact_median):
        n = theta.shape[0]
        D = rbf.pairwise_sq_dists(theta)
        h2 = rbf.bandwidth_sq_from_median(median_fn(D), n)
        K, W = self.weights(D, h2)
        wsum = torch.sum(W, dim=1, keepdim=True)
        dK = wsum * theta - torch.matmul(W, theta)
        return K, dK


def generic_svgd_phi(kernel, theta, grads, median_fn=exact_median):
    """SVGD direction phi = (K @ grads + dK) / n for any weights-kernel, as
    two [n, n] x [n, p] products (K @ grads and W @ theta); counterpart of
    ``stein_tpu/kernels/kernels.py:96``. Returns (phi, aux) with aux =
    {"h2": bandwidth^2, "median": median(D)}."""
    n = theta.shape[0]
    D = rbf.pairwise_sq_dists(theta)
    med = median_fn(D)
    h2 = rbf.bandwidth_sq_from_median(med, n)
    K, W = kernel.weights(D, h2)
    attract = torch.matmul(K, grads)
    wsum = torch.sum(W, dim=1, keepdim=True)
    repulse = wsum * theta - torch.matmul(W, theta)
    phi = (attract + repulse) / n
    return phi, {"h2": h2, "median": med}
