"""The streaming SVGD tile (kernel B3), the tile on a given D (B10) and the
symmetric-traversal tile (B11).

PyTorch counterpart of the single-device part of
``stein_tpu/ops/pallas_svgd.py``: ``pallas_svgd_both_ksum`` (here
``svgd_both_ksum``), ``pallas_svgd_phi_rect`` (``svgd_phi_rect``),
``pallas_svgd_phi`` (``svgd_phi``), ``pallas_svgd_both_ksum_on_D``
(``svgd_both_ksum_on_D``) and ``pallas_svgd_phi_sym`` (``svgd_phi_sym``, at
the end). For an [m, p] row block against [n, p]
column particles and gradients, with the columns' mean c as the centre:

  D  = |r - c|^2 + |t - c|^2 - 2 (r - c)(t - c)^T       (centred, f32 dot)
  K  = exp2((D / h^2) * (-log2(e) / 2))
  ku = K @ (g - (t - c) / h^2),  ksum = rowsum K
  phi = (ku + ksum * (r - c) / h^2) / n_total

The CUDA kernel (``csrc/svgd_tile.cu``, the same tile that B1's step tail
launches) replaces ``stein_tpu/ops/pallas_svgd.py:_svgd_tile_kernel``. A
prep launch forms the centred operands, u and the norms (what the JAX
wrapper computes before its pallas_call); the tile kernel runs both
products on the tensor cores (mma.sync: 3xTF32 for ``precision='f32'``,
bf16 for ``'bf16'``), each block holding 64 rows and streaming a share of
the 32-column tiles through a cp.async ring, K never in device memory;
then a third launch adds the shares in a fixed order (two calls give
bitwise-equal output) and forms phi. h^2 is read from device memory. The
tile sizes are the kernel's own (the JAX functions' block arguments have no
counterpart). ``precision='bf16'`` casts what the JAX kernel's ``mxu_dtype``
casts: the centred rows and columns for the dot, K and u for the
contraction; the norms, K and its row sums stay f32. For a CPU tensor the
wrapper runs the plain version; for a CUDA tensor it launches the kernel or
raises.
"""

import torch

from .fused_median import _scalar_on

_LOG2E_HALF = -1.4426950408889634 / 2.0


def column_center(cols):
    """The tile's centre: the mean of the column particles, [1, p]."""
    return torch.mean(cols.to(torch.float32), dim=0, keepdim=True)


PRECISIONS = ("f32", "bf16")


def _operand(x, precision):
    """A product's operand: f32, or rounded to bf16 and back (the JAX
    kernel's mxu_dtype cast; the product then accumulates in f32)."""
    if precision == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    return x


def svgd_both_ksum_plain(rows, cols, grads, h2, center, precision="f32",
                         div_h2=True):
    """Kernel B3's plain version: (ku [m, p], ksum [m, 1]), the JAX
    kernel body on the whole block (torch matmuls), with the dot's and the
    contraction's operands rounded to bf16 for ``precision='bf16'``. K's
    exponent is (D / h^2) (-log2(e)/2), the JAX tile's order, or with
    ``div_h2=False`` D ((-log2(e)/2) / h^2), the JAX step tail's (B1)."""
    rows_c = rows - center
    cols_c = cols - center
    u = grads - cols_c / h2
    rsq_i = torch.sum(rows_c * rows_c, dim=1, keepdim=True)
    rsq_j = torch.sum(cols_c * cols_c, dim=1, keepdim=True)
    D = rsq_i + rsq_j.reshape(1, -1) - 2.0 * torch.matmul(
        _operand(rows_c, precision), _operand(cols_c, precision).T)
    K = torch.exp2(D / h2 * _LOG2E_HALF if div_h2 else
                   D * (_LOG2E_HALF / h2))
    return (torch.matmul(_operand(K, precision), _operand(u, precision)),
            torch.sum(K, dim=1, keepdim=True))


def _combine(ku, ksum, rows, center, h2, n_total):
    return (ku + ksum * (rows - center) / h2) / n_total


def _check(rows, cols, grads, center, precision):
    if precision not in PRECISIONS:
        raise ValueError(f"unknown pallas_precision: {precision!r}")
    m, p = rows.shape
    n = cols.shape[0]
    for name, t, shape in (("rows", rows, (m, p)), ("cols", cols, (n, p)),
                           ("grads", grads, (n, p)),
                           ("center", center, (1, p))):
        if t.dtype != torch.float32:
            raise TypeError(f"svgd tile is f32-only (got {name}={t.dtype})")
        if tuple(t.shape) != shape or t.device != rows.device:
            raise ValueError(f"svgd tile: {name} must be {shape} on "
                             f"{rows.device}, got {tuple(t.shape)} on "
                             f"{t.device}")


def _launch(rows, cols, grads, h2, center, n_total, precision, div_h2):
    """B3's launches; n_total=None returns (ku, ksum), else phi."""
    from .. import _cuda

    lib = _cuda.library().lib
    m, p = rows.shape
    n = cols.shape[0]
    dev = rows.device
    splits = lib.stein_tile_splits(m, n, p)
    part_ku = torch.empty(splits * m * p, dtype=torch.float32, device=dev)
    part_ksum = torch.empty(splits * m, dtype=torch.float32, device=dev)
    prep = torch.empty(lib.stein_tile_prep_floats(m, n, p),
                       dtype=torch.float32, device=dev)
    if n_total is None:
        ku = torch.empty(m, p, dtype=torch.float32, device=dev)
        ksum = torch.empty(m, 1, dtype=torch.float32, device=dev)
        ptrs = (ku.data_ptr(), ksum.data_ptr(), 0)
    else:
        phi = torch.empty(m, p, dtype=torch.float32, device=dev)
        ptrs = (0, 0, phi.data_ptr())
    err = lib.stein_svgd_tile(
        rows.data_ptr(), cols.data_ptr(), grads.data_ptr(),
        center.data_ptr(), h2.data_ptr(), m, n, p, splits,
        part_ku.data_ptr(), part_ksum.data_ptr(), *ptrs,
        float(n_total or 0), int(precision == "bf16"), int(div_h2),
        prep.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _cuda.check(err, "svgd_tile_kernel launch")
    svgd_both_ksum.launches += 1
    if precision == "bf16":
        svgd_both_ksum.bf16_launches += 1
    return (ku, ksum) if n_total is None else phi


def _tile(rows, cols, grads, h2, center, n_total, precision, div_h2=True):
    """B3 on [m, p] rows against [n, p] columns; ``div_h2=False`` is B1's
    exponent order (the card tests drive both)."""
    center = center.reshape(1, -1)
    _check(rows, cols, grads, center, precision)
    h2 = _scalar_on(h2, rows)
    if rows.device.type == "cpu":
        ku, ksum = svgd_both_ksum_plain(rows, cols, grads, h2, center,
                                        precision, div_h2)
        if n_total is None:
            return ku, ksum
        return _combine(ku, ksum, rows, center, h2, n_total)
    if rows.device.type != "cuda":
        raise ValueError(f"svgd tile: no kernel for {rows.device}")
    return _launch(rows.contiguous(), cols.contiguous(), grads.contiguous(),
                   h2, center.contiguous(), n_total, precision, div_h2)


def svgd_both_ksum(rows, cols, grads, h2, center, precision="f32"):
    """The raw accumulators (ku [m, p], ksum [m, 1]) of rows [m, p]
    against cols/grads [n, p] about ``center`` ([1, p]); callers combine
    phi = (ku + ksum * (rows - center) / h2) / n_total with the same
    centre. f32 inputs; ``precision`` is the JAX function's ('f32' or
    'bf16' dot operands)."""
    return _tile(rows, cols, grads, h2, center, None, precision)


# Every launch of the tile; of them, those of its bf16 route.
svgd_both_ksum.launches = 0
svgd_both_ksum.bf16_launches = 0


def svgd_phi_rect(rows, cols, grads, h2, n_total=None, center=None,
                  precision="f32"):
    """phi for an [m, p] row block against [n, p] columns, centred at the
    mean of the columns (pass ``center`` when the caller already holds
    it); n_total defaults to n."""
    if n_total is None:
        n_total = cols.shape[0]
    if center is None:
        center = column_center(cols)
    return _tile(rows, cols, grads, h2, center, n_total, precision)


def svgd_phi(theta, grads, h2, center=None, precision="f32"):
    """The SVGD direction phi for [n, p] particles and gradients."""
    return svgd_phi_rect(theta, theta, grads, h2, center=center,
                         precision=precision)


def svgd_both_ksum_on_D_plain(D_rows, u_cols, h2):
    """Kernel B10's plain version: K = exp2(D (-log2(e)/2) / h^2) in the
    JAX on-D tile's operation order, (K @ u, rowsum K)."""
    K = torch.exp2(D_rows * _LOG2E_HALF / h2)
    return torch.matmul(K, u_cols), torch.sum(K, dim=1, keepdim=True)


def svgd_both_ksum_on_D(D_rows, u_cols, h2):
    """(ku [m, p], ksum [m, 1]) from a given [m, n] distance block and the
    regrouped operand u = grads - theta / h^2 [n, p], K never in device
    memory (``stein_tpu/ops/pallas_svgd.py:pallas_svgd_both_ksum_on_D``).
    f32 only. The CUDA kernel (``csrc/svgd_on_d.cu``) replaces
    ``pallas_svgd.py:_svgd_on_d_tile_kernel``; B1's D-given tail
    (step_impl='fused') runs the same tile, counted here too."""
    m, n = D_rows.shape
    _check_on_d(D_rows, (("u_cols", u_cols, (n, u_cols.shape[1])),))
    h2 = _scalar_on(h2, D_rows)
    if D_rows.device.type == "cpu":
        return svgd_both_ksum_on_D_plain(D_rows, u_cols, h2)
    return _launch_on_d(D_rows, h2, u_cols.shape[1], u=u_cols)


def svgd_both_ksum_on_D_about_plain(D_rows, grads, cols, center, h2):
    """The plain version of B10's tile as B12's chain runs it: u = grads -
    (cols - center) / h^2, K = exp2(D (-log2(e)/2 / h^2)) (the step tails'
    exponent order)."""
    K = torch.exp2(D_rows * (_LOG2E_HALF / h2))
    u = grads - (cols - center) / h2
    return torch.matmul(K, u), torch.sum(K, dim=1, keepdim=True)


def svgd_both_ksum_on_D_about(D_rows, grads, cols, center, h2):
    """B10's tile with u = grads - (cols - center) / h^2 formed on the card
    (by its prep launch) about ``center`` ([p] or [1, p]), in the step
    tails' exponent order: the form B12's chain launches on its own D,
    exposed so that the card tests can hold it to its plain version.
    Counted with B10."""
    m, n = D_rows.shape
    p = grads.shape[1]
    center = center.reshape(1, p)
    _check_on_d(D_rows, (("grads", grads, (n, p)), ("cols", cols, (n, p)),
                         ("center", center, (1, p))))
    h2 = _scalar_on(h2, D_rows)
    if D_rows.device.type == "cpu":
        return svgd_both_ksum_on_D_about_plain(D_rows, grads, cols, center,
                                               h2)
    return _launch_on_d(D_rows, h2, p, grads=grads, cols=cols,
                        center=center)


def _check_on_d(D_rows, operands):
    for name, t, shape in (("D_rows", D_rows, tuple(D_rows.shape)),
                           *operands):
        if t.dtype != torch.float32:
            raise TypeError(f"svgd tile on D is f32-only (got "
                            f"{name}={t.dtype})")
        if tuple(t.shape) != shape or t.device != D_rows.device:
            raise ValueError(f"svgd tile on D: {name} must be {shape} on "
                             f"{D_rows.device}, got {tuple(t.shape)}")
    if D_rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"svgd tile on D: no kernel for {D_rows.device}")


def _launch_on_d(D_rows, h2, p, u=None, grads=None, cols=None, center=None):
    from .. import _cuda

    lib = _cuda.library().lib
    m, n = D_rows.shape
    D_rows = D_rows.contiguous()
    dev = D_rows.device
    u, grads, cols, center = (None if t is None else t.contiguous()
                              for t in (u, grads, cols, center))

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    splits = lib.stein_on_d_splits(m, n, p)
    part_ku = torch.empty(splits * m * p, dtype=torch.float32, device=dev)
    part_ksum = torch.empty(splits * m, dtype=torch.float32, device=dev)
    u_buf = None if u is not None else torch.empty(n * p, dtype=torch.float32,
                                                   device=dev)
    ku = torch.empty(m, p, dtype=torch.float32, device=dev)
    ksum = torch.empty(m, 1, dtype=torch.float32, device=dev)
    err = lib.stein_svgd_on_d(
        D_rows.data_ptr(), ptr(u), ptr(grads), ptr(cols), ptr(center),
        h2.data_ptr(), m, n, p, splits, part_ku.data_ptr(),
        part_ksum.data_ptr(), ptr(u_buf), ku.data_ptr(), ksum.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(err, "svgd_on_d_kernel launch")
    svgd_both_ksum_on_D.launches += 1
    return ku, ksum


svgd_both_ksum_on_D.launches = 0

# Blocks of B11's persistent launch; 0 takes as many as are resident on the
# card. phi does not depend on it (the card tests and chip_smoke.py check
# another value bitwise).
SYM_BLOCKS = 0


def svgd_phi_sym_plain(theta, grads, h2):
    """Kernel B11's plain version: phi of the symmetric-traversal tile, on
    the whole array. Uncentred, as the JAX kernel is: D = rsq_i + rsq_j -
    2 theta theta^T, K = exp2((D / h^2) (-log2(e)/2)), [attract | ktheta] =
    K @ [g | theta], phi = (attract + (ksum theta - ktheta) / h^2) / n. In
    f32, returned in theta's dtype."""
    f32 = torch.float32
    n, p = theta.shape
    t, g = theta.to(f32), grads.to(f32)
    rsq = torch.sum(t * t, dim=1, keepdim=True)
    D = rsq + rsq.reshape(1, n) - 2.0 * torch.matmul(t, t.T)
    K = torch.exp2(D / h2 * _LOG2E_HALF)
    both = torch.matmul(K, torch.cat([g, t], dim=1))
    ksum = torch.sum(K, dim=1, keepdim=True)
    phi = (both[:, :p] + (ksum * t - both[:, p:]) / h2) / n
    return phi.to(theta.dtype)


def svgd_phi_sym(theta, grads, h2, block=512):
    """The SVGD direction of [n, p] particles by the symmetric traversal
    (``stein_tpu/ops/pallas_svgd.py:pallas_svgd_phi_sym``): only the tiles
    j >= i are formed, each strictly upper tile feeding its row block and,
    by K's symmetry, its column block. Uncentred (|theta| large against the
    spread costs f32 digits, as in the JAX kernel). Computed in f32,
    returned in theta's dtype. No sampler option reaches it; it is an entry
    point of its own.

    The CUDA kernel (``csrc/svgd_sym.cu``) replaces
    ``pallas_svgd.py:_svgd_sym_tile_kernel``. It computes the same phi
    regrouped as B3's tile does, (K @ (g - theta / h^2) + ksum theta / h^2)
    / n, a contraction p wide: a prep launch forms the padded operands, then
    one persistent launch whose blocks take runs of upper 128 x 128 tiles in
    a fixed order from a ticket counter. Each tile runs its products by
    mma.sync 3xTF32; a run's row sides stay in registers, each column side
    is added into an [n, p + 1] f32 accumulator at once, and a counter per
    16-row slice orders the adds, so two calls give bitwise-equal output
    whatever block takes whatever run (``SYM_BLOCKS`` sets the grid). The
    scratch is O(n p). The JAX function's ``block`` has no counterpart in the kernel's
    tiling and is accepted for parity (a positive int, as the JAX function
    needs)."""
    if int(block) < 1:
        raise ValueError(f"svgd_phi_sym: block must be positive (got {block}; "
                         "it is accepted for parity with the JAX function and "
                         "does not change the CUDA tiling)")
    n, p = theta.shape
    if tuple(grads.shape) != (n, p) or grads.device != theta.device:
        raise ValueError(f"svgd_phi_sym: grads must be {(n, p)} on "
                         f"{theta.device}, got {tuple(grads.shape)} on "
                         f"{grads.device}")
    for name, t in (("theta", theta), ("grads", grads)):
        if not t.is_floating_point():
            raise TypeError(f"svgd_phi_sym takes floating particles (got "
                            f"{name}={t.dtype})")
    h2 = _scalar_on(h2, theta)
    if theta.device.type == "cpu":
        return svgd_phi_sym_plain(theta, grads, h2)
    if theta.device.type != "cuda":
        raise ValueError(f"svgd_phi_sym: no kernel for {theta.device}")
    from .. import _cuda

    lib = _cuda.library().lib
    f32 = torch.float32
    dev = theta.device
    t = theta.to(f32).contiguous()
    g = grads.to(f32).contiguous()
    with torch.cuda.device(dev):
        scratch = torch.empty(lib.stein_sym_scratch_floats(n, p), dtype=f32,
                              device=dev)
        phi = torch.empty(n, p, dtype=f32, device=dev)
        err = lib.stein_svgd_sym(
            t.data_ptr(), g.data_ptr(), h2.data_ptr(), n, p, SYM_BLOCKS,
            scratch.data_ptr(), phi.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(err, "sym_tile_kernel launch")
    svgd_phi_sym.launches += 1
    return phi.to(theta.dtype)


svgd_phi_sym.launches = 0
