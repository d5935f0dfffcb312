"""Bayesian neural-network regression (1-hidden-layer ReLU MLP).

PyTorch counterpart of ``stein_tpu/models/bayesian_nn.py``: the reference
example's model (examples/regression_neural_network/main.py:29-85).
Gamma(alpha, beta) priors on the weight precision lambda = exp(log_lambda)
and the noise precision gamma = exp(log_gamma), evaluated at the exp'd
values with no Jacobian correction as the reference does; N(0, lambda^-1/2)
priors on all weights and biases; a Gaussian likelihood with scale
gamma^-1/2, rescaled by n_train/n_batch; the whole log-posterior divided by
n_train. The JAX model's ``precision=`` field is kept and checked and
changes nothing: data products are f32 ``torch.matmul``s (see
``models/distributions.py``).

``pallas_grads()`` keeps its JAX name, by which ``throughput_config(model=)``
and user code find the hook. It returns the per-particle log-posterior and
its hand-derived gradient, as kernel B7 (``csrc/nn_grad.cu``, replacing
``stein_tpu/models/bayesian_nn.py:_nn_grad_kernel``) for a CUDA tensor and
as the same math in plain PyTorch (``nn_grads_plain``) for a CPU tensor.
"""

import ctypes
import dataclasses
import math

import torch

from .distributions import check_precision, gamma_log_prob, normal_log_prob

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class BayesianNNModel:
    n_feats: int
    n_hidden: int
    n_train: int
    n_batch: int
    prior_alpha: float = 1.0
    prior_beta: float = 0.01
    precision: str = "high"

    def __post_init__(self):
        check_precision(self.precision)

    def template(self, dtype=torch.float32):
        f, H = self.n_feats, self.n_hidden
        return {
            "log_lambda": torch.zeros((), dtype=dtype),
            "log_gamma": torch.zeros((), dtype=dtype),
            "w_1": torch.zeros(f, H, dtype=dtype),
            "b_1": torch.zeros(H, dtype=dtype),
            "w_2": torch.zeros(H, 1, dtype=dtype),
            "b_2": torch.zeros((), dtype=dtype),
        }

    def predict(self, params, batch):
        h = torch.clamp(torch.matmul(batch["X"], params["w_1"])
                        + params["b_1"], min=0.0)
        return torch.matmul(h, params["w_2"]) + params["b_2"]

    def log_p(self, params, batch):
        lam = torch.exp(params["log_lambda"])
        gam = torch.exp(params["log_gamma"])
        pred = self.predict(params, batch)
        log_l = torch.sum(normal_log_prob(batch["y"], pred,
                                          1.0 / torch.sqrt(gam)))
        prior_scale = 1.0 / torch.sqrt(lam)
        log_prior = (
            gamma_log_prob(lam, self.prior_alpha, self.prior_beta)
            + gamma_log_prob(gam, self.prior_alpha, self.prior_beta)
            + torch.sum(normal_log_prob(params["w_1"], 0.0, prior_scale))
            + torch.sum(normal_log_prob(params["w_2"], 0.0, prior_scale))
            + torch.sum(normal_log_prob(params["b_1"], 0.0, prior_scale))
            + normal_log_prob(params["b_2"], 0.0, prior_scale)
        )
        scale = self.n_train / self.n_batch
        return (log_l * scale + log_prior) / self.n_train

    def _consts(self):
        """The scalars of the hand-derived backward, as Python floats (the
        JAX kernel's weakly-typed constants, rounded to f32 at use)."""
        f, H = self.n_feats, self.n_hidden
        alpha, beta = float(self.prior_alpha), float(self.prior_beta)
        return dict(
            s=self.n_train / self.n_batch, inv_nt=1.0 / self.n_train,
            am1=alpha - 1.0, beta=beta, n_weights=f * H + H + H + 1,
            c_prior=alpha * math.log(beta) - math.lgamma(alpha),
        )

    def pallas_grads(self):
        """The ``custom_grads=`` hook (SVGDSampler): grad_all(theta [n, p]
        f32, batch) -> (logp [n], grads [n, p]), the log-posterior and its
        hand-derived gradient for every particle, in the ravel layout
        b_1 [H] | b_2 | log_gamma | log_lambda | w_1 [f*H] | w_2 [H].
        A CUDA tensor launches kernel B7, a CPU tensor runs its plain
        version. Use as ``SVGDSampler(custom_grads=model.pallas_grads())``
        or let ``throughput_config(model=...)`` wire it."""
        f, H = self.n_feats, self.n_hidden
        consts = self._consts()

        def grad_all(theta, batch):
            return nn_grads(theta, batch, f, H, consts)

        return grad_all


def nn_grads(theta, batch, f, H, consts):
    """Kernel B7's wrapper: checks the inputs, then launches the kernel
    for a CUDA tensor or runs ``nn_grads_plain`` for a CPU tensor."""
    if theta.dtype != torch.float32:
        raise TypeError(f"pallas_grads is f32-only (got {theta.dtype})")
    n, p = theta.shape
    if p != f * H + 2 * H + 3:
        raise ValueError(f"pallas_grads: theta has {p} columns, the model "
                         f"{f * H + 2 * H + 3}")
    X = batch["X"].to(torch.float32)
    y = batch["y"].to(torch.float32).reshape(-1)
    if X.dim() != 2 or X.shape[1] != f or y.shape[0] != X.shape[0]:
        raise ValueError(
            f"pallas_grads: batch X {tuple(X.shape)} / y "
            f"{tuple(batch['y'].shape)} do not fit n_feats={f}"
        )
    if theta.device.type == "cpu":
        return nn_grads_plain(theta, X, y, f, H, consts)
    if theta.device.type != "cuda":
        raise ValueError(f"pallas_grads: no kernel for {theta.device}")
    out = _launch_nn_grads(theta.contiguous(), X.contiguous(),
                           y.contiguous(), f, H, consts)
    nn_grads.launches += 1
    return out


nn_grads.launches = 0


def nn_grads_plain(theta, X, y, f, H, c):
    """Kernel B7's plain version: the JAX kernel's hand-derived forward and
    backward, op for op, with the observation loop as a batch axis.
    theta [n, p], X [B, f], y [B], all f32; ``c`` from _consts."""
    B = X.shape[0]
    b1 = theta[:, :H]
    b2 = theta[:, H:H + 1]
    lg = theta[:, H + 1:H + 2]
    ll = theta[:, H + 2:H + 3]
    w1 = theta[:, H + 3:H + 3 + f * H]
    w2 = theta[:, H + 3 + f * H:]
    gam = torch.exp(lg)                                      # [n, 1]
    lam = torch.exp(ll)

    a = b1[:, None, :]                                       # [n, B, H]
    for j in range(f):
        a = a + X[None, :, j, None] * w1[:, None, j * H:(j + 1) * H]
    h = torch.clamp(a, min=0.0)
    pred = torch.sum(h * w2[:, None, :], dim=2) + b2         # [n, B]
    r = y[None, :] - pred
    sum_r2 = torch.sum(r * r, dim=1, keepdim=True)           # [n, 1]
    gr = gam * r                                             # [n, B]
    dw2 = torch.sum(gr[:, :, None] * h, dim=1)               # [n, H]
    db2 = torch.sum(gr, dim=1, keepdim=True)
    da = torch.where(a > 0.0, gr[:, :, None] * w2[:, None, :], 0.0)
    db1 = torch.sum(da, dim=1)
    dw1 = torch.cat([torch.sum(X[None, :, j, None] * da, dim=1)
                     for j in range(f)], dim=1)

    w_sq = (torch.sum(w1 * w1, dim=1, keepdim=True)
            + torch.sum(b1 * b1, dim=1, keepdim=True)
            + torch.sum(w2 * w2, dim=1, keepdim=True)
            + b2 * b2)
    s, inv_nt, am1, beta = c["s"], c["inv_nt"], c["am1"], c["beta"]
    nw = c["n_weights"]
    db1_t = (s * db1 - lam * b1) * inv_nt
    dw1_t = (s * dw1 - lam * w1) * inv_nt
    dw2_t = (s * dw2 - lam * w2) * inv_nt
    db2_t = (s * db2 - lam * b2) * inv_nt
    dlg = (s * (-0.5 * gam * sum_r2 + 0.5 * B) + am1 - beta * gam) * inv_nt
    dll = (am1 - beta * lam + 0.5 * nw - 0.5 * lam * w_sq) * inv_nt

    log_l = -0.5 * gam * sum_r2 + B * (0.5 * lg - _HALF_LOG_2PI)
    g_lam = c["c_prior"] + am1 * ll - beta * lam
    g_gam = c["c_prior"] + am1 * lg - beta * gam
    prior_w = -0.5 * lam * w_sq + nw * (0.5 * ll - _HALF_LOG_2PI)
    logp = (s * log_l + g_lam + g_gam + prior_w) * inv_nt
    grads = torch.cat([db1_t, db2_t, dlg, dll, dw1_t, dw2_t], dim=1)
    return logp[:, 0], grads


def _launch_nn_grads(theta, X, y, f, H, c):
    from .. import _cuda

    lib = _cuda.library().lib
    n, p = theta.shape
    B = X.shape[0]
    if X.device != theta.device or y.device != theta.device:
        raise ValueError("pallas_grads: the batch must lie on theta's device")
    if lib.stein_nn_grad_smem(B, f) > lib.stein_max_smem():
        raise ValueError(f"pallas_grads: a batch of {B} x {f} does not fit "
                         "the kernel's shared memory")
    consts = (ctypes.c_float * 8)(
        c["s"], c["inv_nt"], c["am1"], c["beta"], c["n_weights"],
        c["c_prior"], _HALF_LOG_2PI, float(B))
    logp = torch.empty(n, dtype=torch.float32, device=theta.device)
    grads = torch.empty_like(theta)
    err = lib.stein_nn_grads(
        theta.data_ptr(), n, p, X.data_ptr(), y.data_ptr(), B, f, H,
        ctypes.cast(consts, ctypes.c_void_p), logp.data_ptr(),
        grads.data_ptr(), torch.cuda.current_stream(theta.device).cuda_stream,
    )
    _cuda.check(err, "nn_grad_kernel launch")
    return logp, grads
