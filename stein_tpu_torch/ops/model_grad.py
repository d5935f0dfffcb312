"""The in-kernel model stage of the fused step (kernel B1's model branch).

PyTorch counterpart of the ``grad_fn``s that ``stein_tpu/ops/pallas_step.py``
traces into its step kernel: ``_glm_grad`` (step_impl='fused_glm') and
``LogisticRegressionModel.inkernel_model``'s (step_impl='fused_model'). A
CUDA kernel cannot trace a Python function, so the port knows these two model
kinds, each a frozen dataclass whose call returns (grads [n, p], log_p [n])
for theta [n, p] and the model's operands:

- ``GlmGrad``: operands (A_eff [p, p], b_eff [1, p]); grads = b - theta A,
  log_p_i = theta_i . (b - (theta A)_i / 2) (log_p minus its constant).
- ``LogisticGrad(scale, n_feats)``: operands (X_pad [N, p], y_row [1, N],
  w_mask [1, p], la_onehot [1, p]); the hierarchical logistic likelihood's
  gradients and log_p minus its constant.

Each call launches its kernel (``csrc/model_grad.cu``) for a CUDA tensor and
runs the plain version beside it (``.plain``, the JAX grad_fn's expressions
with per-row log_p) for a CPU tensor. The fused step takes the mean of the
rows' log_p itself.
"""

import dataclasses

import torch


def _check(theta, operands, shapes, what):
    if theta.dim() != 2 or theta.dtype != torch.float32:
        raise TypeError(f"{what} is f32-only on [n, p] particles (got "
                        f"{theta.dtype} {tuple(theta.shape)})")
    for i, (op, shape) in enumerate(zip(operands, shapes)):
        if op.dtype != torch.float32:
            raise TypeError(f"{what}: operand {i} is {op.dtype}, not f32")
        if tuple(op.shape) != shape or op.device != theta.device:
            raise ValueError(f"{what}: operand {i} must be {shape} on "
                             f"{theta.device}, got {tuple(op.shape)} on "
                             f"{op.device}")


def _launch(fn, theta, *args):
    """Launch a model-gradient kernel, ``fn(theta, n, p, *args, grads,
    logp, stream)`` with each tensor of ``args`` as its pointer. Returns
    (grads [n, p], logp [n])."""
    from .. import _cuda

    n, p = theta.shape
    theta = theta.contiguous()
    args = [a.contiguous() if isinstance(a, torch.Tensor) else a
            for a in args]
    grads = torch.empty_like(theta)
    logp = torch.empty(n, dtype=torch.float32, device=theta.device)
    err = getattr(_cuda.library().lib, fn)(
        theta.data_ptr(), n, p,
        *[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args],
        grads.data_ptr(), logp.data_ptr(),
        torch.cuda.current_stream(theta.device).cuda_stream)
    _cuda.check(err, f"{fn} launch")
    return grads, logp


def glm_grads_plain(theta, A, b_row):
    """The glm stage's plain version (pallas_step.py:_glm_grad, with the
    log_p per row)."""
    G = torch.matmul(theta, A)
    return b_row - G, torch.sum(theta * (b_row - 0.5 * G), dim=1)


def glm_grads(theta, A, b_row):
    """(grads, logp) of the explicit quadratic; kernel for a CUDA tensor,
    plain version for a CPU one."""
    p = theta.shape[-1]
    _check(theta, (A, b_row), ((p, p), (1, p)), "glm gradient stage")
    if theta.device.type == "cpu":
        return glm_grads_plain(theta, A, b_row)
    if theta.device.type != "cuda":
        raise ValueError(f"glm gradient stage: no kernel for {theta.device}")
    out = _launch("stein_glm_grads", theta, A, b_row)
    glm_grads.launches += 1
    return out


glm_grads.launches = 0


def logistic_grads_plain(theta, X_pad, y_row, w_mask, la_onehot, scale,
                         n_feats):
    """The logistic stage's plain version: the JAX grad_fn of
    LogisticRegressionModel.inkernel_model, with the log_p per row."""
    d = n_feats
    la = torch.sum(theta * la_onehot, dim=1, keepdim=True)
    alpha = torch.exp(la)
    w = theta * w_mask
    logits = torch.matmul(theta, X_pad.T)
    sig = 1.0 / (1.0 + torch.exp(-logits))
    glik = torch.matmul(y_row - sig, X_pad)
    wsq = torch.sum(w * w, dim=1, keepdim=True)
    g_la = 0.5 * d - 0.5 * alpha * wsq - 0.01 * alpha
    grads = scale * glik - alpha * w + la_onehot * g_la
    sce = (torch.clamp(logits, min=0.0) - logits * y_row
           + torch.log1p(torch.exp(-torch.abs(logits))))
    logp = (-scale * torch.sum(sce, dim=1, keepdim=True)
            + 0.5 * d * la - 0.5 * alpha * wsq - 0.01 * alpha)
    return grads, logp[:, 0]


def logistic_grads(theta, X_pad, y_row, w_mask, la_onehot, scale, n_feats):
    """(grads, logp) of the logistic model; kernel for a CUDA tensor, plain
    version for a CPU one."""
    p = theta.shape[-1]
    N = X_pad.shape[0]
    _check(theta, (X_pad, y_row, w_mask, la_onehot),
           ((N, p), (1, N), (1, p), (1, p)), "logistic gradient stage")
    if theta.device.type == "cpu":
        return logistic_grads_plain(theta, X_pad, y_row, w_mask, la_onehot,
                                    scale, n_feats)
    if theta.device.type != "cuda":
        raise ValueError(f"logistic gradient stage: no kernel for "
                         f"{theta.device}")
    from .. import _cuda

    lib = _cuda.library().lib
    if lib.stein_logistic_grad_smem(p, N) > lib.stein_max_smem():
        raise ValueError(f"logistic gradient stage: a batch of {N} x {p} "
                         "does not fit the kernel's shared memory")
    out = _launch("stein_logistic_grads", theta, X_pad, y_row, N, w_mask,
                  la_onehot, float(scale), 0.5 * n_feats)
    logistic_grads.launches += 1
    return out


logistic_grads.launches = 0


@dataclasses.dataclass(frozen=True)
class GlmGrad:
    """grad_fn of the explicit quadratic (operands A_eff, b_eff [1, p])."""

    def __call__(self, theta, A, b_row):
        return glm_grads(theta, A, b_row)

    def plain(self, theta, A, b_row):
        return glm_grads_plain(theta, A, b_row)


@dataclasses.dataclass(frozen=True)
class LogisticGrad:
    """grad_fn of the hierarchical logistic model (operands X_pad, y_row,
    w_mask, la_onehot); scale = n_train / n_batch."""

    scale: float
    n_feats: int

    def __call__(self, theta, X_pad, y_row, w_mask, la_onehot):
        return logistic_grads(theta, X_pad, y_row, w_mask, la_onehot,
                              self.scale, self.n_feats)

    def plain(self, theta, X_pad, y_row, w_mask, la_onehot):
        return logistic_grads_plain(theta, X_pad, y_row, w_mask, la_onehot,
                                    self.scale, self.n_feats)


# The model kinds the fused step's CUDA chain runs.
KERNEL_MODELS = (GlmGrad, LogisticGrad)
