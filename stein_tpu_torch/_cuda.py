"""Build and bind the hand-written CUDA kernels (``csrc/``).

``nvcc`` compiles every source under ``csrc/`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``. The build
runs at the first CUDA call, not at import, and is cached under
``build/stein_tpu_torch/<hash>/`` beside the package, keyed by a hash of the
sources and the flags. A missing ``nvcc`` or a failed build raises with
nvcc's output in the message.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "stein_tpu_torch"
# No --use_fast_math: the median search relies on IEEE f32 rounding.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "stein_max_p": ((), _I),
    "stein_median_blocks": ((_I, ctypes.POINTER(_I)), _I),
    "stein_phi_splits": ((_I,), _I),
    "stein_reduce_blocks": ((_I, _I), _I),
    "stein_warm_median": (
        (_P, _I, _P, _I, _I, _P, _P, _I, _F,   # D .. log_n
         _P, _P, _P, _P),                      # out, scratch, stream
        _I),
    "stein_fused_step_tail": (
        (_P, _P, _P, _I, _I, _I,            # theta, grads, rows, n, p, m
         _P, _I, _I, _P, _P, _I, _F, _F,    # med_prev .. log_n, max_norm
         _I, _P, _P, _P, _P, _P,            # opt kind/consts, moments, count, lr
         _P, _P, _P, _P, _P, _P,            # outputs
         _P, _P, _P, _P, _P, _I,            # median scratch, splits
         _P, _P, _P, _P, _P,                # phi scratch
         _P),                               # stream
        _I),
}


class Library:
    """The loaded kernel library, its build log and build time."""

    def __init__(self, lib, log, seconds):
        self.lib = lib
        self.build_log = log
        self.build_seconds = seconds


def _nvcc():
    cand = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(cand):
        raise RuntimeError(
            "stein_tpu_torch: nvcc not found (PATH or /usr/local/cuda/bin); "
            "the CUDA kernels are built from csrc/ at first use"
        )
    return cand


@functools.lru_cache(maxsize=None)
def library():
    """Build (once per source hash) and load the kernel library."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    so = out_dir / "libstein_kernels.so"
    log, seconds = "(cached)", 0.0
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"stein_tpu_torch: nvcc failed ({res.returncode}):\n"
                f"{' '.join(cmd)}\n{log}"
            )
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return Library(lib, log, seconds)


@functools.lru_cache(maxsize=None)
def median_blocks(p):
    """Blocks of the cooperative median grid (one per SM) when its Gram
    stage has width p (p=0: search only)."""
    blocks = ctypes.c_int(0)
    check(library().lib.stein_median_blocks(p, ctypes.byref(blocks)),
          "median grid query")
    return blocks.value


def check(err, what):
    """Raise if a C entry point returned a CUDA error (a refused launch
    never runs, and a later synchronize does not report it)."""
    if err != 0:
        raise RuntimeError(f"stein_tpu_torch: {what} failed with CUDA error "
                           f"{err}")
