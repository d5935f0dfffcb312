"""The linear models' per-particle data products, with a fixed reduction
order.

PyTorch counterpart of ``jnp.matmul(batch["X"], w)`` and ``A @ w`` in
``stein_tpu/models/linear_regression.py:93`` and ``:87``, and of the
logistic model's logits in its ``log_p`` (``jnp.matmul(batch["X"], w)`` at
``stein_tpu/models/logistic_regression.py:163``), all under
``jax.vmap(jax.value_and_grad(...))`` at ``stein_tpu/api.py:442``. XLA forms
them on the TPU; no Pallas kernel does.

Two ``torch.autograd.Function``s, each the other's backward:

- ``MatVec``: ``y = M @ w`` for a shared data matrix M [N, p] and one
  particle's w [p] or [p, 1]. Its vmap rule folds the particle axis into
  one launch, ``Y = W M^T`` [n, N];
- ``MatTVec``: ``g = M^T @ r``; its vmap rule gives ``G = R M`` [n, p].

So ``vmap(grad_and_value(log_p))`` runs two launches a step and no
``bmm``. Under a plain ``vmap`` with ordinary autograd (``remat=True``'s
checkpointed forward) the vmap rule's folded call is itself a ``MatVec``,
whose backward autograd records. Only an unbatched M is taken (every path
passes the batch with ``in_dims=None``); a batched M raises.

The folded products (``data_product``, ``data_product_t``) launch
``csrc/data_product.cu`` for a CUDA tensor: f32 on the tensor cores in
3xTF32, bf16 in bf16 (f64 as FMA chains), every sum in an order that
depends on (N, p, dtype) alone, so a particle's row is the same bits in a
launch over 250 particles as over 1000 (cuBLAS's bmm, picked by the shape,
is not). The transpose's contraction over N goes in ``transpose_plan(N)``'s
chunks, one block of a thread-block cluster each, added back in a fixed
order. For a CPU tensor they run the plain version beside them
(``torch.matmul`` of the folded operands).
"""

import torch

_DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
# The transpose's split of its contraction: at most _MAX_SPLITS chunks (a
# cluster's blocks), about _MIN_CHUNK indices or more each, every chunk a
# whole number of the kernel's _RUN-index runs.
_MAX_SPLITS, _MIN_CHUNK, _RUN = 8, 128, 32


def transpose_plan(N):
    """(S, chunk): how ``G = R M`` cuts its contraction over N, a function
    of N alone (row invariance). S0 = min(8, ceil(N / 128)) parts of
    ceil(N / S0) indices, rounded up to a multiple of 32 (the kernel's
    runs), give the chunk; S = ceil(N / chunk) chunks, [j chunk, min(N,
    (j + 1) chunk)), none empty. N = 1000: (8, 128), the last chunk 104;
    N <= 128: one chunk."""
    def cdiv(a, b):
        return -(-a // b)

    s0 = max(1, min(_MAX_SPLITS, cdiv(N, _MIN_CHUNK)))
    chunk = _RUN * max(1, cdiv(cdiv(N, s0), _RUN))
    return max(1, cdiv(N, chunk)), chunk


def _check(M, A, what):
    """M [N, p] and the folded operand A [n, k] on one device in one
    dtype."""
    if M.dim() != 2 or A.dim() != 2:
        raise ValueError(f"{what}: the data matrix and the particles' rows "
                         f"must be 2-D (got {tuple(M.shape)} and "
                         f"{tuple(A.shape)})")
    if M.dtype != A.dtype or M.device != A.device:
        raise TypeError(f"{what}: the data matrix is {M.dtype} on "
                        f"{M.device}, the rows {A.dtype} on {A.device}")


def _launch(fn, A, M, shape, n, N, p, *plan):
    from .. import _cuda

    if A.dtype not in _DTYPES:
        raise TypeError(f"{fn}: the kernel takes float32, float64 or "
                        f"bfloat16, not {A.dtype}")
    A, M = A.contiguous(), M.contiguous()
    out = torch.empty(shape, dtype=A.dtype, device=A.device)
    err = getattr(_cuda.library().lib, fn)(
        A.data_ptr(), M.data_ptr(), out.data_ptr(), n, N, p,
        _DTYPES[A.dtype], *plan,
        torch.cuda.current_stream(A.device).cuda_stream)
    _cuda.check(err, f"{fn} launch")
    return out


def data_product_plain(M, W):
    """Y = W M^T, the folded forward product's plain version."""
    return torch.matmul(W, M.T)


def data_product_t_plain(M, R):
    """G = R M, the folded transpose product's plain version."""
    return torch.matmul(R, M)


def data_product(M, W):
    """Y [n, N] = W [n, p] M [N, p]^T; kernel for a CUDA tensor, plain
    version for a CPU one."""
    _check(M, W, "data_product")
    (N, p), n = M.shape, W.shape[0]
    if W.shape[1] != p:
        raise ValueError(f"data_product: rows of width {W.shape[1]} against "
                         f"a [{N}, {p}] data matrix")
    if W.device.type == "cpu":
        return data_product_plain(M, W)
    if W.device.type != "cuda":
        raise ValueError(f"data_product: no kernel for {W.device}")
    if n * N == 0:
        return W.new_zeros(n, N)
    out = _launch("stein_data_product", W, M, (n, N), n, N, p)
    data_product.launches += 1
    return out


data_product.launches = 0


def data_product_t(M, R):
    """G [n, p] = R [n, N] M [N, p]; kernel for a CUDA tensor, plain
    version for a CPU one."""
    _check(M, R, "data_product_t")
    (N, p), n = M.shape, R.shape[0]
    if R.shape[1] != N:
        raise ValueError(f"data_product_t: rows of width {R.shape[1]} "
                         f"against a [{N}, {p}] data matrix")
    if R.device.type == "cpu":
        return data_product_t_plain(M, R)
    if R.device.type != "cuda":
        raise ValueError(f"data_product_t: no kernel for {R.device}")
    if n * p == 0:
        return R.new_zeros(n, p)
    out = _launch("stein_data_product_t", R, M, (n, p), n, N, p,
                  *transpose_plan(N))
    data_product_t.launches += 1
    return out


data_product_t.launches = 0


def _out_shape(x, rows, length, out_len):
    """The per-call output shape for an operand x along a contraction of
    ``length``: rows [n, length] -> [n, out_len]; a particle's [length] or
    [length, 1] -> [out_len] or [out_len, 1]."""
    if rows:
        ok, shape = x.dim() == 2 and x.shape[1] == length, (x.shape[0],
                                                            out_len)
    else:
        ok = x.shape in ((length,), (length, 1))
        shape = (out_len,) + tuple(x.shape[1:])
    if not ok:
        raise ValueError(f"data product: an operand of shape "
                         f"{tuple(x.shape)} against a contraction of "
                         f"{length} (a particle's [{length}] or "
                         f"[{length}, 1])")
    return shape


def _fold(fn, in_dims, M, x, rows):
    """The vmap rule of both Functions: the vmapped axis of x joins the
    rows of one folded call of ``fn`` (itself a Function, so autograd
    outside torch.func records it)."""
    m_dim, x_dim = in_dims[0], in_dims[1]
    if m_dim is not None:
        raise ValueError("data product: the data matrix is batched under "
                         "vmap; only the particles may carry the vmapped "
                         "axis (in_dims=(0, None))")
    if x_dim is None:
        return fn.apply(M, x, rows), None
    N, p = M.shape
    length, out_len = (p, N) if fn is MatVec else (N, p)
    X = x.movedim(x_dim, 0)
    shape = _out_shape(X[0], rows, length, out_len)
    out = fn.apply(M, X.reshape(-1, length), True)
    return out.reshape((X.shape[0],) + shape), 0


class MatVec(torch.autograd.Function):
    """y = M @ w: M [N, p] shared, w [p] or [p, 1] a particle's (``rows``:
    w [n, p] already folded, y [n, N]). Backward: ``MatTVec``."""

    generate_vmap_rule = False

    @staticmethod
    def forward(M, w, rows=False):
        N, p = M.shape
        shape = _out_shape(w, rows, p, N)
        return data_product(M, w.reshape(-1, p)).reshape(shape)

    @staticmethod
    def setup_context(ctx, inputs, output):
        M, _, rows = inputs
        if M.requires_grad:
            raise ValueError("data product: the data matrix takes no "
                             "gradient")
        ctx.save_for_backward(M)
        ctx.rows = rows

    @staticmethod
    def backward(ctx, grad_y):
        M, = ctx.saved_tensors
        return None, MatTVec.apply(M, grad_y, ctx.rows), None

    @staticmethod
    def vmap(info, in_dims, M, w, rows=False):
        return _fold(MatVec, in_dims, M, w, rows)


class MatTVec(torch.autograd.Function):
    """g = M^T @ r: M [N, p] shared, r [N] or [N, 1] (``rows``: r [n, N],
    g [n, p]). Backward: ``MatVec``."""

    generate_vmap_rule = False

    @staticmethod
    def forward(M, r, rows=False):
        N, p = M.shape
        shape = _out_shape(r, rows, N, p)
        return data_product_t(M, r.reshape(-1, N)).reshape(shape)

    @staticmethod
    def setup_context(ctx, inputs, output):
        M, _, rows = inputs
        if M.requires_grad:
            raise ValueError("data product: the data matrix takes no "
                             "gradient")
        ctx.save_for_backward(M)
        ctx.rows = rows

    @staticmethod
    def backward(ctx, grad_g):
        M, = ctx.saved_tensors
        return None, MatVec.apply(M, grad_g, ctx.rows), None

    @staticmethod
    def vmap(info, in_dims, M, r, rows=False):
        return _fold(MatTVec, in_dims, M, r, rows)


def matvec(M, w):
    """``M @ w`` for one particle's w, through ``MatVec``."""
    return MatVec.apply(M, w)
