"""RBF (squared-exponential) kernel and the SVGD direction, plain PyTorch.

PyTorch counterpart of ``stein_tpu/ops/rbf.py`` (the reference-semantics
path, ``kernel_impl='xla'``). The Gram and the contraction are f32
``torch.matmul``s: PyTorch keeps f32 matmuls at full f32 unless the caller
turns TF32 on, which is the JAX HIGHEST/HIGH precision this path asks for.

- D = r + r^T - 2 T T^T            (abstract_kernel.py:33-35)
- h^2 = median(D) / log(n)         (abstract_kernel.py:38-40)
- K = exp(-D / h^2 / 2)            (squared_exponential_kernel.py:22)
- dK_i = (sum_j K_ij theta_i - (K@theta)_i) / h^2 (:29-35)
- phi = (K @ grads + dK) / n       (abstract_stein_sampler.py:105)
"""

import functools

import torch

from .median import exact_median


def pairwise_sq_dists(theta):
    """D = r + r^T - 2 T T^T, the reference's exact algebraic form."""
    r = torch.sum(theta * theta, dim=1, keepdim=True)
    return r + r.T - 2.0 * torch.matmul(theta, theta.T)


@functools.lru_cache(maxsize=None)
def log_n(n_particles, dtype=torch.float32):
    """log(n) rounded as the JAX package computes it (``jnp.log`` of an
    ``n`` cast to the particle dtype), as a Python float."""
    return torch.log(torch.tensor(float(n_particles), dtype=dtype)).item()


def bandwidth_sq_from_median(med, n_particles):
    """h^2 = median / log(n)  (abstract_kernel.py:40, squared)."""
    return med / log_n(n_particles, med.dtype)


def rbf_kernel_and_repulse(theta, median_fn=exact_median):
    """Return (K, dK, h2) exactly as the oracle's rbf_kernel_and_repulse
    (``stein_tpu/ops/rbf.py:53``)."""
    n = theta.shape[0]
    D = pairwise_sq_dists(theta)
    h2 = bandwidth_sq_from_median(median_fn(D), n)
    K = torch.exp(-D / h2 / 2.0)
    ksum = torch.sum(K, dim=1, keepdim=True)
    dK = (ksum * theta - torch.matmul(K, theta)) / h2
    return K, dK, h2


def svgd_phi(theta, grads, median_fn=exact_median):
    """SVGD direction phi = (K @ grads + dK) / n, with the attractive and
    repulsive contractions as one [n, n] x [n, 2p] product. Returns
    (phi, aux) with aux = {"h2": bandwidth^2, "median": median(D)}."""
    n, p = theta.shape
    D = pairwise_sq_dists(theta)
    med = median_fn(D)
    h2 = bandwidth_sq_from_median(med, n)
    K = torch.exp(-D / h2 / 2.0)
    ksum = torch.sum(K, dim=1, keepdim=True)
    both = torch.matmul(K, torch.cat([grads, theta], dim=1))
    attract = both[:, :p]
    ktheta = both[:, p:]
    phi = (attract + (ksum * theta - ktheta) / h2) / n
    return phi, {"h2": h2, "median": med}
