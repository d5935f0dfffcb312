"""Where the hand-written CUDA kernels are built and looked up.

PyTorch counterpart of ``stein_tpu/utils/cache.py``. What the JAX package
compiles at run time is XLA programs, and its cache keeps them across runs.
What the port compiles is the nvcc library of ``csrc/``: ``_cuda.library()``
builds it at the first CUDA call into ``<build root>/<hash>/`` (the hash
covers the sources and the flags) and loads it from there on every later
run. This function chooses that build root."""

import os
from pathlib import Path

from .. import _cuda


def enable_compilation_cache(path=str(_cuda.BUILD_ROOT),
                             min_compile_secs=1.0):
    """Make ``path`` and build and look up the kernel library under
    ``path/<hash>/`` from now on; returns ``path``. The default is the
    build root beside the package (``build/stein_tpu_torch/``, listed in
    ``.gitignore``).

    Nothing is built here: the kernels are still built from ``csrc/`` at
    the first CUDA call. Calling it again is safe. Once the library is
    loaded in this process, a later call changes nothing for this process:
    the loaded library stays loaded and is not built again.
    ``min_compile_secs`` is accepted so the JAX signature carries over and
    has no effect: every nvcc build is cached, however short."""
    del min_compile_secs   # see the docstring
    os.makedirs(path, exist_ok=True)
    _cuda.BUILD_ROOT = Path(path)
    return path
