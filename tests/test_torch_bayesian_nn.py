"""The port's BayesianNNModel (stein_tpu_torch/models/bayesian_nn.py) and
kernel B7's plain version against the JAX package, on the same numpy
inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

import stein_tpu as sj
import stein_tpu_torch as st
from stein_tpu.models import BayesianNNModel as JNN
from stein_tpu.utils.ravel import template_unraveler as j_unraveler
from stein_tpu_torch.models import BayesianNNModel as TNN
from stein_tpu_torch.models import gamma_log_prob
from stein_tpu_torch.utils.convert import state_from_numpy
from stein_tpu_torch.utils.ravel import template_unraveler as t_unraveler


def _data(B, f, seed):
    """The JAX suite's NN data: y = cos(10 x) 5 x + noise on x ~ U[0, 1]."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(B, f))
    y = np.cos(10 * X[:, :1]) * (5 * X[:, :1]) + rng.normal(size=(B, 1)) * .1
    return X, y


@pytest.mark.parametrize("f,H,n_train,n_batch,beta", [
    (2, 8, 100, 10, 0.01),
    (1, 20, 20, 20, 10.0),
    (3, 5, 50, 7, 1.0),
])
def test_log_p_and_autodiff_match_jax_f64(f, H, n_train, n_batch, beta):
    """log_p and its torch.func gradient against JAX's log_p and autodiff,
    in f64, at the JAX suite's rtol 1e-8 (tests/test_models.py)."""
    jm = JNN(f, H, n_train, n_batch, prior_beta=beta)
    tm = TNN(f, H, n_train, n_batch, prior_beta=beta)
    p, junravel = j_unraveler(jm.template(jnp.float64))
    tp, tunravel = t_unraveler(tm.template(torch.float64))
    assert tp == p
    rng = np.random.default_rng(f * 100 + H)
    theta = rng.normal(size=(6, p)) * 0.5
    X, y = _data(n_batch, f, f)
    jb = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    tb = {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}

    jfn = jax.vmap(jax.value_and_grad(lambda r: jm.log_p(junravel(r), jb)))
    jv, jg = jfn(jnp.asarray(theta))
    tg, tv = vmap(grad_and_value(lambda r: tm.log_p(tunravel(r), tb)))(
        torch.from_numpy(theta))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-8)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-8,
                               atol=1e-12)


def test_gamma_log_prob_matches_jax():
    from stein_tpu.models.distributions import gamma_log_prob as jgamma
    x = np.random.default_rng(0).uniform(0.1, 5.0, size=20)
    np.testing.assert_allclose(
        gamma_log_prob(torch.from_numpy(x), 1.5, 10.0).numpy(),
        np.asarray(jgamma(jnp.asarray(x), 1.5, 10.0)), rtol=1e-12)


def _grad_inputs(n, B, f, H, seed=0):
    """tests/test_models.py::test_pallas_grads_match_autodiff's inputs."""
    rng = np.random.default_rng(seed)
    jm = JNN(f, H, n_train=5 * B, n_batch=B, prior_beta=10.0)
    tm = TNN(f, H, n_train=5 * B, n_batch=B, prior_beta=10.0)
    p = f * H + 2 * H + 3
    theta = (rng.normal(size=(n, p)) * 0.3).astype(np.float32)
    X = rng.uniform(size=(B, f)).astype(np.float32)
    y = (np.cos(10 * X[:, :1]) * (5 * X[:, :1])
         + rng.normal(size=(B, 1)) * 0.1).astype(np.float32)
    return jm, tm, theta, X, y


# The two shapes of tests/test_models.py::test_pallas_grads_match_autodiff
# and its tolerances: logp rtol 2e-5 / atol 1e-5, grads atol 2e-5 max|g|
# (f32 sums in other orders).
GRAD_SHAPES = [(64, 20, 1, 100), (600, 12, 3, 50)]


@pytest.mark.parametrize("n,B,f,H", GRAD_SHAPES)
def test_b7_plain_matches_jax_kernel(n, B, f, H):
    jm, tm, theta, X, y = _grad_inputs(n, B, f, H)
    jlp, jg = jm.pallas_grads(interpret=True)(
        jnp.asarray(theta), {"X": jnp.asarray(X), "y": jnp.asarray(y)},
        block_rows=256)
    tlp, tg = tm.pallas_grads()(torch.from_numpy(theta),
                                {"X": torch.from_numpy(X),
                                 "y": torch.from_numpy(y)})
    assert tlp.shape == (n,) and tg.shape == theta.shape
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=2e-5,
                               atol=1e-5)
    scale = np.abs(np.asarray(jg)).max()
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=2e-5 * scale)


@pytest.mark.parametrize("n,B,f,H", GRAD_SHAPES)
def test_b7_plain_matches_torch_autodiff(n, B, f, H):
    """The hand-derived backward against torch.func on the port's own
    log_p: the ravel layout of the gradient is the template's."""
    _, tm, theta, X, y = _grad_inputs(n, B, f, H, seed=1)
    tb = {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}
    _, unravel = t_unraveler(tm.template())
    g_ref, lp_ref = vmap(grad_and_value(
        lambda r: tm.log_p(unravel(r), tb)))(torch.from_numpy(theta))
    lp, g = tm.pallas_grads()(torch.from_numpy(theta), tb)
    np.testing.assert_allclose(lp.numpy(), lp_ref.numpy(), rtol=2e-5,
                               atol=1e-5)
    scale = g_ref.abs().max().item()
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), atol=2e-5 * scale)


def test_b7_guards():
    _, tm, theta, X, y = _grad_inputs(8, 5, 1, 4)
    tb = {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}
    grad_all = tm.pallas_grads()
    with pytest.raises(TypeError, match="f32"):
        grad_all(torch.from_numpy(theta).double(), tb)
    with pytest.raises(ValueError, match="columns"):
        grad_all(torch.from_numpy(theta)[:, :-1], tb)


def test_nn_state_handoff_from_jax():
    """A JAX NN sampler runs 3 steps; its particles and Adam state cross
    over through state_from_numpy; both run 3 more on the reference path
    (autodiff gradients, exact median). rtol 1e-5 / atol 1e-6: f32 sums
    in other orders, as tests/test_torch_sampler.py's REF_TOL."""
    n, B, f, H = 40, 20, 1, 10
    jm = JNN(f, H, B, B, prior_beta=10.0)
    tm = TNN(f, H, B, B, prior_beta=10.0)
    p = f * H + 2 * H + 3
    X, y = _data(B, f, 11)
    theta0 = (np.random.default_rng(3).normal(size=(n, p)) * 0.1
              ).astype(np.float32)
    gd = dict(learning_rate=0.1, decay=0.999)
    js = sj.SVGDSampler(n, jm.log_p, jm.template(), sj.Adam(**gd),
                        theta=jnp.asarray(theta0))
    ts = st.SVGDSampler(n, tm.log_p, tm.template(), st.Adam(**gd),
                        theta=theta0, device="cpu")
    jb = {"X": jnp.asarray(X, jnp.float32), "y": jnp.asarray(y, jnp.float32)}
    tb = {"X": torch.tensor(X, dtype=torch.float32),
          "y": torch.tensor(y, dtype=torch.float32)}
    js.run(jb, 3)
    s = js.state
    ts.load_state(state_from_numpy(
        np.asarray(s.particles),
        {k: np.asarray(v) for k, v in s.opt_state._asdict().items()},
        np.asarray(s.step), device="cpu"))
    ja = js.run(jb, 3)
    ta = ts.run(tb, 3)
    np.testing.assert_allclose(ts.samples, js.samples, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ta["log_p_mean"].numpy(),
                               np.asarray(ja["log_p_mean"]), rtol=1e-5)
    assert int(ts.state.step) == 6
