"""The port's step rules against the JAX package's (stein_tpu/ops/
optimizers.py): the same phi sequence, made with numpy, through both.

Tolerance rtol 1e-6: the two packages run the same f32 expression tree; the
only difference is the float pow of the bias correction (XLA's vs torch's,
~1 ulp)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stein_tpu.ops import optimizers as jopt
from stein_tpu_torch.ops import optimizers as topt

RULES = [
    ("Adam", dict(learning_rate=1e-1, decay=0.999)),
    ("Adam", dict(learning_rate=3e-2, beta_1=0.8, beta_2=0.99)),
    ("Adagrad", dict(learning_rate=5e-2)),
    ("Adagrad", dict(learning_rate=1e-1, alpha=0.5, decay=0.9)),
]


@pytest.mark.parametrize("name,kw", RULES)
def test_step_rule_matches_jax(name, kw):
    rng = np.random.default_rng(0)
    phis = rng.normal(size=(5, 7, 3)).astype(np.float32)
    jgd, tgd = getattr(jopt, name)(**kw), getattr(topt, name)(**kw)
    js = jgd.init((7, 3), jnp.float32)
    ts = tgd.init((7, 3), torch.float32, device="cpu")
    for phi in phis:   # the first update is the mu=phi / nu=phi^2 quirk
        jd, js = jgd.update(js, jnp.asarray(phi))
        td, ts = tgd.update(ts, torch.from_numpy(phi))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
        for tl, jl in zip(ts, js):
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       rtol=1e-6)
    assert ts.count.dtype == torch.int32 and int(ts.count) == 5
    assert ts.learning_rate.dtype == torch.float32


def test_adam_decays_lr_and_adagrad_does_not():
    phi = torch.ones(2, 2)
    s = topt.Adam(learning_rate=1.0, decay=0.5).init((2, 2), device="cpu")
    _, s = topt.Adam(learning_rate=1.0, decay=0.5).update(s, phi)
    assert float(s.learning_rate) == 0.5
    a = topt.Adagrad(learning_rate=1.0, decay=0.5)
    _, s = a.update(a.init((2, 2), device="cpu"), phi)
    assert float(s.learning_rate) == 1.0


def test_reference_aliases():
    assert topt.AdamGradientDescent is topt.Adam
    assert topt.AdagradGradientDescent is topt.Adagrad


@pytest.mark.parametrize("rule", ["Adam", "Adagrad"])
def test_init_default_device_is_the_card(rule, monkeypatch):
    """No device given: init takes the current card and, without one,
    raises (no fallback to the CPU); tests/test_torch_cuda.py checks that
    it lands on cuda:<current>."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=f"{rule}.init.*no CUDA device"):
        getattr(topt, rule)().init((4, 2))
    assert getattr(topt, rule)().init((4, 2), device="cpu").count.device \
        == torch.device("cpu")
