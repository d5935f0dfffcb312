"""The port's LogisticRegressionModel (stein_tpu_torch/models/
logistic_regression.py), its in-kernel model stage (ops/model_grad.py,
plain version) and the step_impl='fused_model' sampler against the JAX
package, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

import stein_tpu as sj
import stein_tpu_torch as st
from stein_tpu.models import LogisticRegressionModel as JL
from stein_tpu.models.logistic_regression import (
    sigmoid_cross_entropy_with_logits as j_sce,
)
from stein_tpu.utils.ravel import template_unraveler as j_unraveler
from stein_tpu_torch.models import LogisticRegressionModel as TL
from stein_tpu_torch.models import sigmoid_cross_entropy_with_logits as t_sce
from stein_tpu_torch.ops.fused_step import InKernelModel
from stein_tpu_torch.utils.convert import state_from_numpy
from stein_tpu_torch.utils.ravel import template_unraveler as t_unraveler


def _data(n_obs, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_obs, d))
    y = (X @ rng.normal(size=(d, 1)) > 0).astype(np.float64)
    return X.astype(dtype), y.astype(dtype), rng


def _batches(X, y):
    return ({"X": jnp.asarray(X), "y": jnp.asarray(y)},
            {"X": torch.from_numpy(X), "y": torch.from_numpy(y)})


def test_sigmoid_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=50) * 20
    z = (rng.uniform(size=50) > 0.5).astype(np.float64)
    np.testing.assert_allclose(
        t_sce(torch.from_numpy(z), torch.from_numpy(x)).numpy(),
        np.asarray(j_sce(jnp.asarray(z), jnp.asarray(x))), rtol=1e-12)


@pytest.mark.parametrize("d,n_train,n_batch", [(6, 200, 20), (54, 581012, 50),
                                               (3, 40, 7)])
def test_log_p_and_autodiff_match_jax_f64(d, n_train, n_batch):
    """log_p and its torch.func gradient against JAX's log_p and autodiff,
    in f64, at the JAX suite's rtol 1e-8 (tests/test_models.py)."""
    jm, tm = JL(d, n_train, n_batch), TL(d, n_train, n_batch)
    p, junravel = j_unraveler(jm.template(jnp.float64))
    tp, tunravel = t_unraveler(tm.template(torch.float64))
    assert tp == p == d + 1
    X, y, rng = _data(n_batch, d, d, np.float64)
    theta = rng.normal(size=(6, p)) * 0.5
    jb, tb = _batches(X, y)
    jfn = jax.vmap(jax.value_and_grad(lambda r: jm.log_p(junravel(r), jb)))
    jv, jg = jfn(jnp.asarray(theta))
    tg, tv = vmap(grad_and_value(lambda r: tm.log_p(tunravel(r), tb)))(
        torch.from_numpy(theta))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-8)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-8,
                               atol=1e-10)


def test_ravel_layout_and_operands_match_jax():
    d, n_obs = 7, 12
    jm, tm = JL(d, 100, n_obs), TL(d, 100, n_obs)
    la_j, w_j, p_j = jm._ravel_layout()
    la_t, w_t, p_t = tm._ravel_layout()
    assert (la_t, p_t) == (la_j, p_j) == (0, d + 1)
    np.testing.assert_array_equal(w_t.numpy(), w_j)
    X, y, _ = _data(n_obs, d, 3)
    jb, tb = _batches(X, y)
    jk, tk = jm.inkernel_model(jb), tm.inkernel_model(tb)
    assert len(tk.operands) == len(jk.operands) == 4
    for a, b in zip(tk.operands, jk.operands):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tk.const == pytest.approx(float(jk.const), rel=1e-12)
    assert tk.extra_vmem(1000) == jk.extra_vmem(1000)


@pytest.mark.parametrize("n,d,n_obs,n_train", [(48, 6, 20, 200),
                                               (300, 54, 50, 581012),
                                               (97, 200, 33, 3300),
                                               (7, 130, 70, 700)])
def test_inkernel_grad_fn_matches_jax(n, d, n_obs, n_train):
    """The logistic stage's plain version against the JAX grad_fn on the
    same theta, at tests/test_pallas_step.py's
    test_logreg_inkernel_grad_matches_autodiff tolerances (grads atol
    2e-6 max|g|, log_p mean rtol 1e-6), and against the port's own
    autodiff of log_p; also at the kernel's edges: n not a multiple of
    its 4-particle block, N past 32 and not a multiple of 4, p past 128."""
    jm, tm = JL(d, n_train, n_obs), TL(d, n_train, n_obs)
    X, y, rng = _data(n_obs, d, n)
    theta = (rng.normal(size=(n, d + 1)) * 0.1).astype(np.float32)
    jb, tb = _batches(X, y)
    jk, tk = jm.inkernel_model(jb), tm.inkernel_model(tb)
    jg, jlp = jk.grad_fn(jnp.asarray(theta), *jk.operands)
    tg, tlp = tk.grad_fn(torch.from_numpy(theta), *tk.operands)
    assert tg.shape == theta.shape and tlp.shape == (n,)
    scale = np.abs(np.asarray(jg)).max()
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=2e-6 * scale)
    np.testing.assert_allclose(float(tlp.mean()), float(jlp), rtol=1e-6)

    _, unravel = t_unraveler(tm.template())
    ag, av = vmap(grad_and_value(lambda r: tm.log_p(unravel(r), tb)))(
        torch.from_numpy(theta))
    np.testing.assert_allclose(tg.numpy(), ag.numpy(),
                               atol=2e-6 * ag.abs().max().item())
    np.testing.assert_allclose(float(tlp.mean()) + tk.const,
                               float(av.mean()), rtol=1e-6)


def _logreg_problem(n=48, d=6, n_obs=20):
    """tests/test_pallas_step.py's _logreg_problem."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(n_obs, d))
    y = (X @ rng.normal(size=(d, 1)) > 0).astype(np.float64)
    theta0 = (rng.normal(size=(n, d + 1)) * 0.1).astype(np.float32)
    return (X.astype(np.float32), y.astype(np.float32), theta0,
            JL(d, 200, n_obs), TL(d, 200, n_obs))


def _pair(rule, gd_kw):
    """JAX (interpret mode) and port fused_model samplers from one theta0."""
    X, y, theta0, jm, tm = _logreg_problem()
    n = theta0.shape[0]
    common = dict(median="bisect", warm_median=True, warm_passes=6,
                  step_impl="fused_model")
    js = sj.SVGDSampler(n, jm.log_p, jm.template(),
                        getattr(sj, rule)(**gd_kw), theta=jnp.asarray(theta0),
                        pallas_interpret=True,
                        inkernel_model=jm.inkernel_model, **common)
    ts = st.SVGDSampler(n, tm.log_p, tm.template(),
                        getattr(st, rule)(**gd_kw), theta=theta0,
                        device="cpu", inkernel_model=tm.inkernel_model,
                        **common)
    jb, tb = _batches(X, y)
    return js, ts, jb, tb


@pytest.mark.parametrize("rule,gd_kw", [
    ("Adam", dict(learning_rate=1e-1, decay=0.999)),
    ("Adagrad", dict(learning_rate=5e-2)),
])
def test_fused_model_trajectory_matches_jax(rule, gd_kw):
    """15 steps of step_impl='fused_model' against the JAX sampler's
    (interpret mode), at tests/test_pallas_step.py's fused_model class:
    the first median bitwise, medians rtol 5e-3, log_p_mean rtol 1e-4,
    samples rtol 2e-4 / atol 1e-6."""
    js, ts, jb, tb = _pair(rule, gd_kw)
    ja, ta = js.run(jb, 15), ts.run(tb, 15)
    med_j, med_t = np.asarray(ja["median"]), ta["median"].numpy()
    assert med_t[0] == med_j[0]
    np.testing.assert_allclose(med_t, med_j, rtol=5e-3)
    np.testing.assert_allclose(ta["log_p_mean"].numpy(),
                               np.asarray(ja["log_p_mean"]), rtol=1e-4)
    np.testing.assert_allclose(ts.samples, js.samples, rtol=2e-4, atol=1e-6)
    aj, at = js.train_on_batch(jb), ts.train_on_batch(tb)
    np.testing.assert_allclose(at["log_p_mean"].numpy(),
                               np.asarray(aj["log_p_mean"]), rtol=1e-4)


@pytest.mark.parametrize("n", [50, 1000, 4096])
@pytest.mark.parametrize("d", [6, 54, 300])
def test_throughput_config_with_logistic_matches_jax(n, d):
    want = sj.throughput_config(n, d + 1, model=JL(d, 1000, 50))
    got = st.throughput_config(n, d + 1, model=TL(d, 1000, 50))
    assert got.pop("dtype") is torch.float32
    assert want.pop("dtype") == jnp.float32
    assert ({k: callable(v) or v for k, v in got.items()}
            == {k: callable(v) or v for k, v in want.items()})
    assert ("inkernel_model" in got) == (got.get("step_impl")
                                         == "fused_model")


def test_logistic_state_handoff_from_jax():
    """A JAX logistic sampler runs 4 fused_model steps; its particles and
    Adam state cross over through state_from_numpy; both run 4 more at the
    fused_model class."""
    gd = dict(learning_rate=1e-1, decay=0.99)
    js, ts, jb, tb = _pair("Adam", gd)
    js.run(jb, 4)
    s = js.state
    ts.load_state(state_from_numpy(
        np.asarray(s.particles),
        {k: np.asarray(v) for k, v in s.opt_state._asdict().items()},
        np.asarray(s.step), device="cpu"))
    assert int(ts.state.step) == 4 and int(ts.state.opt_state.count) == 4
    np.testing.assert_array_equal(ts.samples, js.samples)
    ja, ta = js.run(jb, 4), ts.run(tb, 4)
    np.testing.assert_allclose(ts.samples, js.samples, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(ta["log_p_mean"].numpy(),
                               np.asarray(ja["log_p_mean"]), rtol=1e-4)
    np.testing.assert_allclose(float(ts.state.opt_state.learning_rate),
                               float(js.state.opt_state.learning_rate),
                               rtol=1e-6)


def test_fused_model_guards():
    """The JAX suite's test_fused_model_guards and test_fused_model_vmem_gate,
    and the port's own: an in-kernel model the CUDA chain does not know is
    refused with TypeError, on the CPU too."""
    X, y, theta0, _, tm = _logreg_problem()
    tb = {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}
    common = dict(median="bisect", warm_median=True, theta=theta0,
                  device="cpu")

    def make(**kw):
        return st.SVGDSampler(48, tm.log_p, tm.template(), st.Adam(),
                              **common, **kw)

    with pytest.raises(ValueError, match="inkernel_model"):
        make(step_impl="fused_model")
    with pytest.raises(ValueError, match="fused_model"):
        make(step_impl="fused_gram", inkernel_model=tm.inkernel_model)
    base = tm.inkernel_model(tb)
    fat = make(step_impl="fused_model", inkernel_model=lambda b: InKernelModel(
        base.operands, base.grad_fn, base.const, vmem_bytes=lambda n: 1 << 30))
    with pytest.raises(ValueError, match="VMEM"):
        fat.run(tb, 2)
    custom = make(step_impl="fused_model",
                  inkernel_model=lambda b: InKernelModel(
                      base.operands, base.grad_fn.plain, base.const))
    with pytest.raises(TypeError, match="GlmGrad"):
        custom.run(tb, 1)
    flat = make(step_impl="fused_model",
                inkernel_model=lambda b: InKernelModel(
                    (base.operands[0], base.operands[1].reshape(-1)),
                    base.grad_fn))
    with pytest.raises(ValueError, match="2-D"):
        flat.run(tb, 1)
