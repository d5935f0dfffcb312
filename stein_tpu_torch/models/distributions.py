"""Log-density helpers matching tf.contrib.distributions semantics.

PyTorch counterpart of ``stein_tpu/models/distributions.py`` (the part the
ported models use). ``resolve_precision`` becomes ``check_precision``: the
models keep the JAX ``precision=`` field, but f32 products run at full f32
unless the caller turns TF32 on (the precision the JAX models' default
"high" tier stands for), so the field is checked and changes nothing.
"""

import math

import torch

# The JAX models' precision names (distributions.resolve_precision).
PRECISIONS = ("high", "default", "highest")


def check_precision(name):
    """Raise for a name the JAX package's resolve_precision does not know."""
    if name not in PRECISIONS:
        raise ValueError(f"unknown model precision {name!r} (one of "
                         f"{PRECISIONS}; it changes nothing in the port)")


def normal_log_prob(x, loc, scale):
    """log N(x; loc, scale). Matches tf.distributions.Normal.log_prob.
    ``scale`` is a Python number or a tensor."""
    z = (x - loc) / scale
    log_scale = (torch.log(scale) if isinstance(scale, torch.Tensor)
                 else math.log(scale))
    return -0.5 * z * z - log_scale - 0.5 * math.log(2.0 * math.pi)


def sigmoid_cross_entropy_with_logits(labels, logits):
    """Matches tf.nn.sigmoid_cross_entropy_with_logits:
    max(x, 0) - x*z + log(1 + exp(-|x|))."""
    return (torch.clamp(logits, min=0.0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def gamma_log_prob(x, concentration, rate):
    """log Gamma(x; concentration alpha, rate beta).

    Matches tf.distributions.Gamma.log_prob:
    alpha*log(beta) - lgamma(alpha) + (alpha-1)*log(x) - beta*x, with
    alpha and beta cast to x's dtype first, as the JAX helper does."""
    a = torch.as_tensor(concentration, dtype=x.dtype, device=x.device)
    b = torch.as_tensor(rate, dtype=x.dtype, device=x.device)
    return (a * torch.log(b) - torch.lgamma(a) + (a - 1.0) * torch.log(x)
            - b * x)
