from .rbf import pairwise_sq_dists, rbf_kernel_and_repulse, svgd_phi
from .median import (
    exact_median,
    subsampled_sq_dist_median,
    binned_median,
    bisect_median,
)
from .optimizers import (
    Adam,
    Adagrad,
    AdamGradientDescent,
    AdagradGradientDescent,
)

__all__ = [
    "pairwise_sq_dists",
    "rbf_kernel_and_repulse",
    "svgd_phi",
    "exact_median",
    "subsampled_sq_dist_median",
    "binned_median",
    "bisect_median",
    "Adam",
    "Adagrad",
    "AdamGradientDescent",
    "AdagradGradientDescent",
]
