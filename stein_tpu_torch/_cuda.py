"""Build and bind the hand-written CUDA kernels (``csrc/``).

``nvcc`` compiles each source under ``csrc/`` for ``sm_90a`` (one process
per source, all started together) and links the objects into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
the first CUDA call, not at import, and is cached under
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
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "stein_median_blocks": ((_I, ctypes.POINTER(_I)), _I),
    "stein_reduce_blocks": ((_I, _I), _I),
    "stein_gram_prep_floats": ((_I, _I, _I), _I),
    "stein_warm_median": (
        (_P, _I, _P, _I, _I, _P, _P, _I, _F,   # D .. log_n
         _P, _P, _P, _P),                      # out, scratch, stream
        _I),
    "stein_warm_from_theta": (
        (_P, _P, _P, _I, _I, _I,            # rows, cols, center, m, n, p
         _P, _I, _I, _P, _P, _I, _F,        # med_prev .. log_n
         _P, _P, _P, _P, _P, _P),           # out, scratch, prep, stream
        _I),
    "stein_dist_block": (
        (_P, _P, _P, _I, _I, _I,            # rows, cols, center, m, n, p
         _P, _P, _P),                       # D, prep, stream
        _I),
    "stein_bracket_pass": (
        (_P, _P, _P, _I, _I, _I,            # rows, cols, center, m, n, p
         _P, _P, _P, _I, _P, _I,            # med_prev, br_lo/hi, nb,
                                            # hi_bound, g1
         _P, _P, _P, _P, _P, _P),           # D, cnts, mm, thr, prep,
                                            # stream
        _I),
    "stein_tile_splits": ((_I, _I, _I), _I),
    "stein_tile_prep_floats": ((_I, _I, _I), ctypes.c_longlong),
    "stein_svgd_tile": (
        (_P, _P, _P, _P, _P, _I, _I, _I,    # rows .. h2, m, n, p
         _I, _P, _P,                        # splits, scratch
         _P, _P, _P, _F,                    # ku, ksum, phi, n_total
         _I, _I, _P, _P),                   # bf16, div_h2, prep, stream
        _I),
    "stein_max_smem": ((), _I),
    "stein_nn_grad_smem": ((_I, _I), _I),
    "stein_nn_grads": (
        (_P, _I, _I, _P, _P, _I, _I, _I,    # theta, n, p, X, y, B, f, H
         _P, _P, _P, _P),                   # consts, logp, grads, stream
        _I),
    "stein_fused_step_tail": (
        (_P, _P, _P, _I, _I, _I, _P, _I,    # theta, grads, block, n, p, m, D,
                                            # d_once
         _P, _I, _I, _P, _P, _I, _F, _F,    # med_prev .. log_n, max_norm
         _I, _P, _P, _P, _P, _P, _P,        # opt kind/consts, moments, count,
                                            # lr, logp
         _P, _P, _P, _P, _P, _P,            # outputs
         _P, _P, _P, _P, _P, _I,            # median scratch, splits
         _P, _P, _P, _P, _P,                # phi scratch
         _P, _P),                           # tile prep, stream
        _I),
    "stein_fused_epilogue": (
        (_P, _P, _P, _P, _P, _P, _I, _I,    # ku, ksum, theta, center, h2,
                                            # norm, n, p
         _F, _F, _I, _P, _P, _P, _P, _P,    # n_total, max_norm, opt, state
         _P, _P, _P, _P, _P, _P),           # outputs, stream
        _I),
    "stein_on_d_splits": ((_I, _I, _I), _I),
    "stein_on_d_blocks": ((_I, _I, _I), _I),
    "stein_svgd_on_d": (
        (_P, _P, _P, _P, _P, _P,            # D, u, grads, cols, center, h2
         _I, _I, _I, _I,                    # m, n, p, splits
         _P, _P, _P, _P, _P, _P),           # scratch, u_buf, ku, ksum, stream
        _I),
    "stein_sym_scratch_floats": ((_I, _I), ctypes.c_longlong),
    "stein_svgd_sym": (
        (_P, _P, _P, _I, _I, _I,            # theta, grads, h2, n, p, blocks
         _P, _P, _P),                       # scratch, phi, stream
        _I),
    "stein_logistic_grad_smem": ((_I, _I), _I),
    "stein_glm_grads": (
        (_P, _I, _I, _P, _P, _P, _P, _P),   # theta, n, p, A, b, grads, logp
        _I),
    "stein_logistic_grads": (
        (_P, _I, _I, _P, _P, _I, _P, _P,    # theta, n, p, X, y, N, masks
         _F, _F, _P, _P, _P),               # scale, d/2, grads, logp, stream
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


def _build(nvcc, sources, so):
    """Compile every source at once (one nvcc each), then link. Returns
    the compilers' output; raises on the first failure."""
    objs = [so.parent / (src.stem + ".o") for src in sources]
    procs = [(subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-o", str(obj), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), src)
        for src, obj in zip(sources, objs)]
    log, failed = "", []
    for proc, src in procs:
        out = proc.communicate()[0]
        log += f"== {src.name}\n{out}"
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"stein_tpu_torch: nvcc failed on {failed}:\n"
                           f"{log}")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    cmd = [nvcc, *ARCH, "-shared", "-o", tmp, *map(str, objs)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        if os.path.exists(tmp):   # nvcc removes it on some failures
            os.unlink(tmp)
        raise RuntimeError(f"stein_tpu_torch: nvcc link failed "
                           f"({res.returncode}):\n{' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    return log + res.stdout + res.stderr


@functools.lru_cache(maxsize=None)
def library():
    """Build (once per source hash) and load the kernel library."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + ARCH).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    so = out_dir / "libstein_kernels.so"
    log, seconds = "(cached)", 0.0
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        log = _build(_nvcc(), sources, so)
        seconds = time.perf_counter() - t0
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
