"""The rest of the port's sampler API (stein_tpu_torch/api.py) against the
JAX sampler on the same numpy inputs: train_on_batches, train_minibatched,
function_posterior, remat=, the zero-step calls (run(batch, 0) and its
kin), and the golden f64 trajectories against the NumPy oracle
(baselines/numpy_svgd.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stein_tpu as sj
import stein_tpu_torch as st
from baselines.numpy_svgd import NumpyAdagrad, NumpyAdam, NumpySVGD
from stein_tpu.models import BayesianNNModel as JNN
from stein_tpu.models import LinearRegressionModel as JLR
from stein_tpu.models import LogisticRegressionModel as JL
from stein_tpu.parallel import particle_mesh as jax_mesh
from stein_tpu_torch.api import minibatch_indices
from stein_tpu_torch.models import BayesianNNModel as TNN
from stein_tpu_torch.models import LinearRegressionModel as TLR
from stein_tpu_torch.models import LogisticRegressionModel as TL
from test_models import _np_nn_log_p_and_grad
from torch_mesh_runner import one_process_mesh

# The reference path's tolerance (tests/test_torch_sampler.py, REF_TOL).
REF_TOL = dict(rtol=1e-5, atol=1e-6)
# The golden trajectories' (tests/test_sampler.py:35,58).
GOLDEN_TOL = dict(rtol=1e-8, atol=1e-12)
AUX_KEYS = {"h2", "log_p_mean", "median", "phi_norm"}


def _linreg(seed=0, n_obs=40, n_feats=3, n_particles=16, dtype=np.float32):
    """tests/test_sampler.py's _linreg_setup."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_obs, n_feats))
    w_true = rng.normal(size=(n_feats, 1)) * 2.0
    y = X @ w_true + rng.normal(size=(n_obs, 1)) * 0.3
    theta0 = rng.normal(size=(n_particles, n_feats)) * 0.01
    return X.astype(dtype), y.astype(dtype), theta0.astype(dtype)


def _lr_pair(theta0, jkw=None, tkw=None, f64=False, rule="Adam",
             gd_kw=None):
    """The JAX and the port's linear-regression samplers from theta0."""
    p = theta0.shape[1]
    jm, tm = JLR(p), TLR(p)
    gd_kw = gd_kw or dict(learning_rate=1e-1)
    jdt, tdt = (jnp.float64, torch.float64) if f64 else (jnp.float32,
                                                        torch.float32)
    js = sj.SVGDSampler(theta0.shape[0], jm.log_p, jm.template(jdt),
                        getattr(sj, rule)(**gd_kw),
                        theta=jnp.asarray(theta0), dtype=jdt, **(jkw or {}))
    ts = st.SVGDSampler(theta0.shape[0], tm.log_p, tm.template(tdt),
                        getattr(st, rule)(**gd_kw), theta=theta0,
                        dtype=tdt, device="cpu", **(tkw or jkw or {}))
    return js, ts


def _stacked(X, y, k, m, seed=0):
    """k minibatches of m rows, as tests/test_sampler.py:209 draws them."""
    idx = np.random.default_rng(seed).integers(0, X.shape[0], size=(k, m))
    return ({"X": jnp.asarray(X[idx]), "y": jnp.asarray(y[idx])},
            {"X": torch.from_numpy(X[idx]), "y": torch.from_numpy(y[idx])})


WARM = dict(median="bisect", warm_median=True, warm_passes=6)


@pytest.mark.parametrize("cfg", [{}, WARM], ids=["cold", "warm"])
def test_train_on_batches_matches_jax(cfg):
    """train_on_batches on the same stacked minibatches as JAX's, on the
    cold (exact median) and warm xla samplers, at the reference path's
    tolerance; the aux has a leading [k] axis."""
    X, y, theta0 = _linreg(seed=12)
    jb, tb = _stacked(X, y, 6, 8)
    js, ts = _lr_pair(theta0, cfg)
    ja, ta = js.train_on_batches(jb), ts.train_on_batches(tb)
    np.testing.assert_allclose(ts.samples, js.samples, **REF_TOL)
    assert set(ta) == AUX_KEYS and all(v.shape == (6,) for v in ta.values())
    for key in AUX_KEYS:
        np.testing.assert_allclose(ta[key].numpy(), np.asarray(ja[key]),
                                   rtol=1e-5)
    assert int(ts.state.step) == 6


def test_train_on_batches_matches_iterated_steps():
    """tests/test_sampler.py::test_train_on_batches_matches_iterated_steps
    on the port (f64): the stacked call equals k train_on_batch calls
    bitwise."""
    X, y, theta0 = _linreg(seed=12, dtype=np.float64)
    _, tb = _stacked(X, y, 5, 8)
    _, a = _lr_pair(theta0, f64=True)
    _, b = _lr_pair(theta0, f64=True)
    for t in range(5):
        a.train_on_batch({"X": tb["X"][t], "y": tb["y"][t]})
    aux = b.train_on_batches(tb)
    np.testing.assert_array_equal(a.samples, b.samples)
    assert aux["log_p_mean"].shape == (5,)


def test_train_on_batches_fused_model_matches_jax_interpret():
    """step_impl='fused_model' (the logistic stage and B1's chain, plain
    versions here) on stacked minibatches against the JAX sampler in
    interpret mode, at tests/test_torch_logistic.py's fused_model class:
    medians rtol 5e-3, log_p_mean rtol 1e-4, samples rtol 2e-4 / atol
    1e-6."""
    rng = np.random.default_rng(1)
    d, n, n_rows, m = 6, 48, 200, 20
    X = rng.normal(size=(n_rows, d)).astype(np.float32)
    y = (X @ rng.normal(size=(d, 1)) > 0).astype(np.float32)
    theta0 = (rng.normal(size=(n, d + 1)) * 0.1).astype(np.float32)
    jm, tm = JL(d, n_rows, m), TL(d, n_rows, m)
    jb, tb = _stacked(X, y, 8, m, seed=5)
    common = dict(median="bisect", warm_median=True, warm_passes=6,
                  step_impl="fused_model")
    js = sj.SVGDSampler(n, jm.log_p, jm.template(), sj.Adam(1e-1),
                        theta=jnp.asarray(theta0), pallas_interpret=True,
                        inkernel_model=jm.inkernel_model, **common)
    ts = st.SVGDSampler(n, tm.log_p, tm.template(), st.Adam(1e-1),
                        theta=theta0, device="cpu",
                        inkernel_model=tm.inkernel_model, **common)
    ja, ta = js.train_on_batches(jb), ts.train_on_batches(tb)
    np.testing.assert_allclose(ta["median"].numpy(), np.asarray(ja["median"]),
                               rtol=5e-3)
    np.testing.assert_allclose(ta["log_p_mean"].numpy(),
                               np.asarray(ja["log_p_mean"]), rtol=1e-4)
    np.testing.assert_allclose(ts.samples, js.samples, rtol=2e-4, atol=1e-6)


def _logistic_problem():
    """tests/test_sampler.py:622's 2000 x 8 problem."""
    rng = np.random.default_rng(0)
    n_rows, d = 2000, 8
    X = rng.normal(size=(n_rows, d)).astype(np.float32)
    y = (X @ rng.normal(size=(d, 1)) > 0).astype(np.float32)
    return X, y, TL(d, n_train=n_rows, n_batch=32)


def _mb_sampler(model, **kw):
    return st.SVGDSampler(64, model.log_p, model.template(), st.Adam(1e-1),
                          generator=torch.Generator().manual_seed(1),
                          device="cpu", median="bisect", warm_median=True,
                          **kw)


def test_train_minibatched_converges_and_is_deterministic():
    """tests/test_sampler.py::test_train_minibatched on the port: the same
    key gives the same samples bitwise, they classify > 90% of the labels
    (particle-mean weights), and another key gives another trajectory."""
    X, y, model = _logistic_problem()
    data = {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}
    a, b, c = _mb_sampler(model), _mb_sampler(model), _mb_sampler(model)
    aux = a.train_minibatched(data, 300, 32, 3)
    b.train_minibatched(data, 300, 32, torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(a.samples, b.samples)
    assert aux["phi_norm"].shape == (300,) and np.isfinite(a.samples).all()
    w_mean = a.theta["w"].mean(dim=0).numpy()
    acc = np.mean((X @ w_mean > 0) == (y > 0.5))
    assert acc > 0.9, acc
    c.train_minibatched(data, 300, 32, 4)
    assert not np.array_equal(c.samples, a.samples)


@pytest.mark.parametrize("step_impl", ["xla", "fused_model"])
def test_train_minibatched_equals_train_on_batches(step_impl):
    """train_minibatched equals train_on_batches on the batches that
    minibatch_indices draws for the same key, bitwise (the fused_model
    step rebuilds its operands from every new batch)."""
    X, y, model = _logistic_problem()
    data = {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}
    kw = {} if step_impl == "xla" else dict(
        step_impl="fused_model", inkernel_model=model.inkernel_model)
    a, b = _mb_sampler(model, **kw), _mb_sampler(model, **kw)
    aux_a = a.train_minibatched(data, 25, 32, 7)
    idx = minibatch_indices(7, 25, 32, X.shape[0], "cpu")
    assert idx.shape == (25, 32) and idx.dtype == torch.int64
    assert int(idx.min()) >= 0 and int(idx.max()) < X.shape[0]
    aux_b = b.train_on_batches({k: v[idx] for k, v in data.items()})
    np.testing.assert_array_equal(a.samples, b.samples)
    for key in AUX_KEYS:
        assert torch.equal(aux_a[key], aux_b[key]), key


def test_train_minibatched_checks_its_data():
    X, y, model = _logistic_problem()
    s = _mb_sampler(model)
    with pytest.raises(ValueError, match="leading"):
        s.train_minibatched({"X": torch.from_numpy(X),
                             "y": torch.from_numpy(y[:10])}, 2, 4, 0)
    with pytest.raises(ValueError, match="n_steps"):
        s.train_minibatched({"X": torch.from_numpy(X)}, -1, 4, 0)


def test_minibatch_indices_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        minibatch_indices(0, 2, 3, 10)


ZERO_CALLS = {
    "run": lambda s, jb: s.run(jb, 0),
    "train_on_batches": lambda s, jb: s.train_on_batches(
        {k: v[None][:0] for k, v in jb.items()}),
    "train_minibatched": lambda s, jb: s.train_minibatched(
        jb, 0, 4, jax.random.PRNGKey(0) if isinstance(s, sj.SVGDSampler)
        else 0),
}


@pytest.mark.parametrize("call", list(ZERO_CALLS))
@pytest.mark.parametrize("cfg", [{}, WARM], ids=["cold", "warm"])
def test_zero_steps_match_jax(call, cfg):
    """C4: zero steps (run(batch, 0), a leading axis of 0, n_steps=0) leave
    the state as it was and return the four diagnostics with shape (0,),
    in the sampler's dtype, as the JAX sampler's scans of length 0 do; a
    negative count raises."""
    X, y, theta0 = _linreg()
    js, ts = _lr_pair(theta0, cfg)
    jb = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    tb = {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}
    ja, ta = ZERO_CALLS[call](js, jb), ZERO_CALLS[call](ts, tb)
    assert set(ta) == set(ja) == AUX_KEYS
    for key in AUX_KEYS:
        assert tuple(ta[key].shape) == np.asarray(ja[key]).shape == (0,)
        assert ta[key].numpy().dtype == np.asarray(ja[key]).dtype
        assert ta[key].device == ts.device
    assert int(ts.state.step) == int(js.state.step) == 0
    np.testing.assert_array_equal(ts.samples, theta0)
    np.testing.assert_array_equal(np.asarray(js.samples), theta0)
    assert int(ts.state.opt_state.count) == 0
    if call == "run":
        with pytest.raises(ValueError, match="n_steps"):
            ts.run(tb, -1)
    ts.run(tb, 1)   # the sampler still steps afterwards
    assert int(ts.state.step) == 1


def _f32_lr(seed=0):
    X, y, theta0 = _linreg(seed=seed)
    return (X, y, theta0, {"X": jnp.asarray(X), "y": jnp.asarray(y)},
            {"X": torch.from_numpy(X), "y": torch.from_numpy(y)})


@pytest.mark.parametrize("axis", [None, 0])
def test_function_posterior_matches_jax(axis):
    """function_posterior(model.predict, batch[, axis]) against JAX's (f32,
    the reference path's tolerance), and against theta0 @ X^T before any
    step; the result is a host numpy array, cached per func."""
    X, y, theta0, jb, tb = _f32_lr(seed=3)
    js, ts = _lr_pair(theta0)
    predict = TLR(3).predict
    got = ts.function_posterior(predict, tb, axis=axis)
    want = np.asarray(js.function_posterior(JLR(3).predict, jb, axis=axis))
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    expect = theta0.astype(np.float64) @ X.T.astype(np.float64)
    np.testing.assert_allclose(got, expect if axis is None
                               else expect.mean(axis=0), rtol=1e-5,
                               atol=1e-7)
    js.run(jb, 3)
    ts.run(tb, 3)
    np.testing.assert_allclose(
        ts.function_posterior(predict, tb, axis=axis),
        np.asarray(js.function_posterior(JLR(3).predict, jb, axis=axis)),
        **REF_TOL)
    assert len(ts._posterior_cache) == 1


@pytest.fixture(scope="module")
def mesh1():
    with one_process_mesh() as mesh:
        yield mesh


@pytest.mark.parametrize("axis", [None, 0])
def test_function_posterior_on_the_mesh(mesh1, axis):
    """On a one-process gloo mesh function_posterior works on the gathered
    particles and equals the single-device sampler's (and JAX's on its
    8-device mesh, tests/test_sharded.py:81's shape)."""
    X, y, theta0, jb, tb = _f32_lr()
    _, single = _lr_pair(theta0)
    _, meshed = _lr_pair(theta0, tkw=dict(mesh=mesh1))
    jmesh = sj.SVGDSampler(16, JLR(3).log_p, JLR(3).template(jnp.float32),
                           sj.Adam(1e-1), theta=jnp.asarray(theta0),
                           dtype=jnp.float32,
                           mesh=jax_mesh(jax.devices()[:8]))
    for s in (single, meshed):
        s.train_on_batch(tb)
    jmesh.train_on_batch(jb)
    got = meshed.function_posterior(TLR(3).predict, tb, axis=axis)
    np.testing.assert_array_equal(
        got, single.function_posterior(TLR(3).predict, tb, axis=axis))
    np.testing.assert_allclose(
        got, np.asarray(jmesh.function_posterior(JLR(3).predict, jb,
                                                 axis=axis)), **REF_TOL)
    assert got.shape == ((16, 40) if axis is None else (40,))


def test_train_minibatched_on_the_mesh(mesh1):
    """On a one-process gloo mesh (warm and fused_shard steps)
    train_minibatched equals the mesh sampler's own train_on_batches on
    minibatch_indices' batches bitwise, and the single-device warm
    sampler's run at the warm bisect class."""
    X, y, model = _logistic_problem()
    data = {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}
    idx = minibatch_indices(5, 10, 32, X.shape[0], "cpu")
    for extra in ({}, dict(step_impl="fused_shard")):
        a = _mb_sampler(model, mesh=mesh1, **extra)
        b = _mb_sampler(model, mesh=mesh1, **extra)
        aux = a.train_minibatched(data, 10, 32, 5)
        b.train_on_batches({k: v[idx] for k, v in data.items()})
        np.testing.assert_array_equal(a.samples, b.samples)
        assert aux["median"].shape == (10,)
    single = _mb_sampler(model)
    single.train_minibatched(data, 10, 32, 5)
    meshed = _mb_sampler(model, mesh=mesh1)
    meshed.train_minibatched(data, 10, 32, 5)
    np.testing.assert_allclose(meshed.samples, single.samples, rtol=2e-4,
                               atol=1e-6)


@pytest.mark.parametrize("model", ["lr", "nn"])
def test_remat_matches_plain_and_jax(model):
    """remat=True (the checkpointed forward) equals remat=False bitwise
    over 3 steps, and JAX's remat sampler at the golden tolerance (f64);
    custom_grads= with remat=True still raises."""
    if model == "lr":
        X, y, theta0 = _linreg(seed=21, dtype=np.float64)
        jm, tm = JLR(3), TLR(3)
    else:
        rng = np.random.default_rng(3)
        jm, tm = JNN(1, 8, 20, 20), TNN(1, 8, 20, 20)
        theta0 = rng.normal(size=(8, 27)) * 0.01
        X = rng.uniform(size=(20, 1))
        y = np.cos(10 * X) * (5 * X) + rng.normal(size=(20, 1)) * 0.1
    jb = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    tb = {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}
    n = theta0.shape[0]

    def port(remat):
        return st.SVGDSampler(n, tm.log_p, tm.template(torch.float64),
                              st.Adam(1e-1), theta=theta0,
                              dtype=torch.float64, device="cpu", remat=remat)
    a, b = port(False), port(True)
    j = sj.SVGDSampler(n, jm.log_p, jm.template(jnp.float64), sj.Adam(1e-1),
                       theta=jnp.asarray(theta0), dtype=jnp.float64,
                       remat=True)
    for _ in range(3):
        a.train_on_batch(tb)
        aux = b.train_on_batch(tb)
        j.train_on_batch(jb)
    np.testing.assert_array_equal(a.samples, b.samples)
    np.testing.assert_allclose(b.samples, np.asarray(j.samples),
                               **GOLDEN_TOL)
    assert not aux["log_p_mean"].requires_grad
    with pytest.raises(ValueError, match="remat"):
        st.SVGDSampler(n, tm.log_p, tm.template(), st.Adam(), theta=theta0,
                       device="cpu", remat=True,
                       custom_grads=lambda t, b: None)


def test_remat_on_the_mesh_and_warm_paths(mesh1):
    """remat reaches every gradient stage: the warm step, the fused_gram
    tail's and the mesh steps' equal their remat=False runs bitwise."""
    X, y, theta0, _, tb = _f32_lr(seed=4)
    for cfg in (WARM, dict(WARM, step_impl="fused_gram"), dict(mesh=mesh1),
                dict(WARM, mesh=mesh1)):
        runs = []
        for remat in (False, True):
            _, s = _lr_pair(theta0, tkw=dict(cfg, remat=remat))
            s.run(tb, 3)
            runs.append(s.samples)
        np.testing.assert_array_equal(*runs)


def _np_grad_log_p(X, y):
    def grad(theta_row, batch):
        w = theta_row.reshape(-1, 1)
        return (X.T @ (y - X @ w) - w).ravel()
    return grad


GOLDEN = [("Adam", 0), ("Adam", 7), ("Adam", 42), ("Adagrad", 3)]


@pytest.mark.parametrize("rule,seed", GOLDEN)
def test_golden_trajectory_against_numpy_oracle(rule, seed):
    """tests/test_sampler.py:35,58 on the port: the f64 sampler (the xla
    path, exact median) against the NumPy oracle elementwise for 10 steps,
    rtol 1e-8 / atol 1e-12 (Adam checked every step, as the JAX suite
    does)."""
    X, y, theta0 = _linreg(seed=seed, dtype=np.float64)
    gd = (NumpyAdam if rule == "Adam" else NumpyAdagrad)(learning_rate=1e-1)
    oracle = NumpySVGD(_np_grad_log_p(X, y), theta0, gd)
    _, s = _lr_pair(theta0, f64=True, rule=rule)
    tb = {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}
    for t in range(10):
        oracle.train_on_batch(None)
        s.train_on_batch(tb)
        if rule == "Adam" or t == 9:
            np.testing.assert_allclose(s.samples, oracle.samples,
                                       err_msg=f"step {t}", **GOLDEN_TOL)


def test_nn_golden_trajectory_against_numpy_oracle():
    """tests/test_models.py:148 on the port: the Bayesian NN's f64
    trajectory (torch.func gradients) against the oracle driven by the
    independent backprop gradients, rtol 1e-7 / atol 1e-11."""
    rng = np.random.default_rng(3)
    jmodel, model = JNN(1, 8, n_train=20, n_batch=20), TNN(1, 8, 20, 20)
    theta0 = rng.normal(size=(8, 27)) * 0.01
    X = rng.uniform(size=(20, 1))
    y = np.cos(10 * X) * (5 * X) + rng.normal(size=(20, 1)) * 0.1
    batch = {"X": X, "y": y}
    oracle = NumpySVGD(
        lambda row, b: _np_nn_log_p_and_grad(row, batch, jmodel)[1],
        theta0, NumpyAdam(learning_rate=1e-1, decay=0.999))
    s = st.SVGDSampler(8, model.log_p, model.template(torch.float64),
                       st.Adam(learning_rate=1e-1, decay=0.999),
                       theta=theta0, dtype=torch.float64, device="cpu")
    tb = {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}
    for t in range(10):
        oracle.train_on_batch(None)
        s.train_on_batch(tb)
        np.testing.assert_allclose(s.samples, oracle.samples, rtol=1e-7,
                                   atol=1e-11, err_msg=f"step {t}")
