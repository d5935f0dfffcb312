"""Pure-functional step rules matching the reference optimizers exactly.

PyTorch counterpart of ``stein_tpu/ops/optimizers.py``. Each rule is a pure
(state, phi) -> (step, state) function whose state is a ``NamedTuple`` of
tensors on the particles' device. Scalars (``count``, ``learning_rate``) are
0-d device tensors, so a step loop never reads them on the host.

Reproduced quirks (see SURVEY.md §2 #6/#7):

- Adam (adam_gradient_descent.py:41-58): first-iteration moments initialise to
  mu=phi, nu=phi^2 (not zero) while bias correction is *still* applied; the
  learning rate decays multiplicatively after every step.
- Adagrad (adagrad_gradient_descent.py:34-44): RMSProp-style decayed
  squared-gradient history with first-iteration hist=phi^2, epsilon 1e-6, and
  — unlike Adam — no learning-rate decay applied inside update.

``init`` puts the state on the given device, else on the current card, and
raises without one (as every entry point of the port does).

Only the ``update`` form with a float pow exists here: the JAX package's
``Adam.update_kernel`` (pow as exp/log) was a Mosaic work-around, and CUDA
has ``powf``.
"""

import dataclasses
from typing import NamedTuple

import torch

from .. import _device


def _scalar_dtype(dtype):
    """The dtype for an optimizer's scalar state and internal arithmetic: at
    least f32 (bf16 cannot represent 0.999; see the JAX module)."""
    return torch.promote_types(dtype, torch.float32)


class AdamState(NamedTuple):
    mu: torch.Tensor             # [n, p] first moment
    nu: torch.Tensor             # [n, p] second moment
    count: torch.Tensor          # 0-d int32, completed steps
    learning_rate: torch.Tensor  # 0-d, decayed multiplicatively


class AdagradState(NamedTuple):
    hist: torch.Tensor           # [n, p] decayed squared-gradient history
    count: torch.Tensor          # 0-d int32
    learning_rate: torch.Tensor  # 0-d (never decayed — reference quirk)


def _rounded(value, sdt):
    """``value`` rounded to ``sdt``, as a Python float. torch applies a
    Python scalar operand at the tensor's precision, the way JAX applies its
    weakly-typed constants, and it needs no host-to-device copy."""
    return torch.tensor(value, dtype=sdt).item()


def _one_minus(value, sdt):
    """``1.0 - value`` computed in ``sdt``, as JAX's ``1.0 - b1`` is."""
    return (torch.tensor(1.0, dtype=sdt)
            - torch.tensor(value, dtype=sdt)).item()


@dataclasses.dataclass(frozen=True)
class Adam:
    """Adam step rule (reference: adam_gradient_descent.py:15-58)."""

    learning_rate: float = 1e-3
    decay: float = 1.0
    beta_1: float = 0.9
    beta_2: float = 0.999

    def init(self, shape, dtype=torch.float32, device=None):
        device = _device.resolve_device(device, "Adam.init")
        return AdamState(
            mu=torch.zeros(shape, dtype=dtype, device=device),
            nu=torch.zeros(shape, dtype=dtype, device=device),
            count=torch.zeros((), dtype=torch.int32, device=device),
            learning_rate=torch.tensor(
                self.learning_rate, dtype=_scalar_dtype(dtype), device=device
            ),
        )

    def update(self, state, phi):
        dtype = phi.dtype
        sdt = _scalar_dtype(dtype)
        b1, b2 = _rounded(self.beta_1, sdt), _rounded(self.beta_2, sdt)
        c1, c2 = _one_minus(self.beta_1, sdt), _one_minus(self.beta_2, sdt)
        phis = phi.to(sdt)
        first = state.count == 0
        mu = torch.where(first, phis, b1 * state.mu.to(sdt) + c1 * phis)
        nu = torch.where(
            first, phis * phis, b2 * state.nu.to(sdt) + c2 * (phis * phis),
        )
        t = state.count + 1
        tf_ = t.to(sdt)
        mup = mu / (1.0 - torch.pow(b1, tf_))
        nup = nu / (1.0 - torch.pow(b2, tf_))
        step = mup / (1e-8 + torch.sqrt(nup)) * state.learning_rate
        new_lr = state.learning_rate * _rounded(self.decay, sdt)
        return step.to(dtype), AdamState(
            mu.to(dtype), nu.to(dtype), t, new_lr
        )


@dataclasses.dataclass(frozen=True)
class Adagrad:
    """RMSProp-style rule (reference: adagrad_gradient_descent.py:13-44)."""

    learning_rate: float = 1e-3
    decay: float = 1.0   # accepted for API parity; never applied (reference quirk)
    alpha: float = 0.9

    def init(self, shape, dtype=torch.float32, device=None):
        device = _device.resolve_device(device, "Adagrad.init")
        return AdagradState(
            hist=torch.zeros(shape, dtype=dtype, device=device),
            count=torch.zeros((), dtype=torch.int32, device=device),
            learning_rate=torch.tensor(
                self.learning_rate, dtype=_scalar_dtype(dtype), device=device
            ),
        )

    def update(self, state, phi):
        dtype = phi.dtype
        sdt = _scalar_dtype(dtype)
        a, c = _rounded(self.alpha, sdt), _one_minus(self.alpha, sdt)
        phis = phi.to(sdt)
        first = state.count == 0
        hist = torch.where(
            first, phis * phis, a * state.hist.to(sdt) + c * (phis * phis),
        )
        step = phis / (1e-6 + torch.sqrt(hist)) * state.learning_rate
        return step.to(dtype), AdagradState(
            hist.to(dtype), state.count + 1, state.learning_rate
        )


# Reference-compatible aliases (stein/optimizers/__init__.py:1-2).
AdamGradientDescent = Adam
AdagradGradientDescent = Adagrad
