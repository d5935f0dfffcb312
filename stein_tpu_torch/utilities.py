"""Reference-compatible import path (stein/utilities/__init__.py:1-2;
``stein_tpu/utilities.py``):

    from stein_tpu_torch.utilities import convert_dictionary_to_array,
                                          convert_array_to_dictionary,
                                          compute_median
"""

from .ops.median import exact_median as compute_median
from .utils.ravel import (
    convert_array_to_dictionary,
    convert_dictionary_to_array,
)

__all__ = [
    "convert_dictionary_to_array",
    "convert_array_to_dictionary",
    "compute_median",
]
