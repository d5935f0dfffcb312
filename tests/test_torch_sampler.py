"""The port's sampler (stein_tpu_torch/api.py) against the JAX sampler from
the same theta0 and data (made with numpy, f32 in both)."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stein_tpu as sj
import stein_tpu_torch as st
from stein_tpu.models import BayesianNNModel as JNN
from stein_tpu.models import LinearRegressionModel as JModel
from stein_tpu_torch.api import _make_grad_all
from stein_tpu_torch.ops.fused_step import InKernelModel
from stein_tpu_torch.ops.model_grad import GlmGrad
from stein_tpu_torch.models import BayesianNNModel as TNN
from stein_tpu_torch.models import LinearRegressionModel as TModel
from stein_tpu_torch.utils.ravel import template_unraveler
from stein_tpu_torch.utils.convert import state_from_numpy
from stein_tpu_torch.parallel import Mesh2D, ParticleMesh, mesh_2d
from torch_mesh_runner import one_process_mesh


# The reference path's tolerance. rtol 1e-5: f32 matmul summation orders
# differ between XLA and torch. atol 1e-6: a step rule normalises each
# component of phi (Adagrad's first step is lr * sign(phi)), so a component
# of phi near zero carries its relative error into theta at the scale of
# lr * 1e-5, whatever the size of that particle coordinate.
REF_TOL = dict(rtol=1e-5, atol=1e-6)


def _problem(n=48, p=6, seed=0):
    """The JAX suite's fused-step problem (tests/test_pallas_step.py)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(80, p))
    y = X @ rng.normal(size=(p, 1))
    theta0 = (rng.normal(size=(n, p)) * 0.1).astype(np.float32)
    return X.astype(np.float32), y.astype(np.float32), theta0


def _pair(X, y, theta0, gd_kw, jcfg, tcfg, rule="Adam"):
    p = theta0.shape[1]
    jm, tm = JModel(p), TModel(p)
    js = sj.SVGDSampler(theta0.shape[0], jm.log_p, jm.template(),
                        getattr(sj, rule)(**gd_kw),
                        theta=jnp.asarray(theta0), **jcfg)
    ts = st.SVGDSampler(theta0.shape[0], tm.log_p, tm.template(),
                        getattr(st, rule)(**gd_kw), theta=theta0,
                        device="cpu", **tcfg)
    jb = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    tb = {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}
    return js, ts, jb, tb


@pytest.mark.parametrize("rule,gd_kw", [
    ("Adam", dict(learning_rate=1e-1, decay=0.999)),
    ("Adagrad", dict(learning_rate=5e-2)),
])
def test_reference_path_matches_jax(rule, gd_kw):
    """step_impl='xla', median='exact' (the defaults), 10 steps, at
    REF_TOL."""
    X, y, theta0 = _problem()
    js, ts, jb, tb = _pair(X, y, theta0, gd_kw, {}, {}, rule)
    ja, ta = js.run(jb, 10), ts.run(tb, 10)
    np.testing.assert_allclose(ts.samples, js.samples, **REF_TOL)
    for key in ("phi_norm", "log_p_mean", "h2", "median"):
        np.testing.assert_allclose(ta[key].numpy(), np.asarray(ja[key]),
                                   rtol=1e-5)
    aj = js.train_on_batch(jb)
    at = ts.train_on_batch(tb)
    np.testing.assert_allclose(at["median"].numpy(),
                               np.asarray(aj["median"]), rtol=1e-5)


def test_warm_bisect_path_matches_jax():
    """The plain warm median (step_impl='xla', warm_median=True)."""
    X, y, theta0 = _problem()
    cfg = dict(median="bisect", warm_median=True, warm_passes=6)
    js, ts, jb, tb = _pair(X, y, theta0, dict(learning_rate=1e-1), cfg, cfg)
    ja, ta = js.run(jb, 10), ts.run(tb, 10)
    np.testing.assert_allclose(ta["median"].numpy(), np.asarray(ja["median"]),
                               rtol=5e-3)
    np.testing.assert_allclose(ts.samples, js.samples, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("n", [50, 1000, 10240])
@pytest.mark.parametrize("p", [55, 128, 303])
def test_throughput_config_matches_jax(n, p):
    want = sj.throughput_config(n, p)
    got = st.throughput_config(n, p)
    assert got.pop("dtype") is torch.float32
    assert want.pop("dtype") == jnp.float32
    assert got == want


def _presence(cfg):
    """A config dict with its callables replaced by their presence."""
    return {k: (callable(v) if callable(v) else v) for k, v in cfg.items()}


@pytest.mark.parametrize("n", [20, 1000, 2829, 2830, 4096])
@pytest.mark.parametrize("p", [303, 640])
def test_throughput_config_with_model_matches_jax(n, p):
    want = sj.throughput_config(n, p, model=JNN(1, 100, 20, 20))
    got = st.throughput_config(n, p, model=TNN(1, 100, 20, 20))
    assert got.pop("dtype") is torch.float32
    assert want.pop("dtype") == jnp.float32
    assert _presence(got) == _presence(want)


def _nn_problem(n=1000):
    """bench.py's nn configuration: 20 observations from numpy seed 11,
    BayesianNNModel(1, 100, 20, 20, prior_beta=10), p=303; theta0 from the
    same generator."""
    rng = np.random.default_rng(11)
    X = rng.uniform(size=(20, 1))
    y = rng.normal(np.cos(10 * X) * (5 * X), 0.1)
    theta0 = (rng.normal(size=(n, 303)) * 0.01).astype(np.float32)
    return X.astype(np.float32), y.astype(np.float32), theta0


def adam_eps_regime(phi1, lr=0.1, b1=0.9, b2=0.999, eps=1e-8):
    """The coordinates where Adam's first step amplifies phi's roundings.
    The first step seeds mu = phi, nu = phi^2 and still divides by the
    bias corrections, so it is lr (phi / (1 - b1)) / (eps + |phi| /
    sqrt(1 - b2)), whose slope in phi, lr eps / ((1 - b1) (eps + |phi| /
    sqrt(1 - b2))^2), rises to lr / ((1 - b1) eps) = 1e8 at phi = 0 (lr
    0.1). Where it exceeds 10 (|phi| < ~1e-6; 22 of the 303 000
    coordinates at the NN shape) no bound on the samples follows from a
    bound on phi, so those are held through phi after step 1."""
    slope = lr / (1 - b1) * eps / (eps + np.abs(phi1) / np.sqrt(1 - b2)) ** 2
    return slope > 10


def test_nn_slice_matches_jax_interpret():
    """The Bayesian-NN path at full width: throughput_config(1000, 303,
    model=...) picks the tile (B3), the in-kernel-Gram median (B5) and
    the gradient kernel (B7); 5 steps of run and 3 of train_on_batch
    against the JAX package in interpret mode, at the fused_gram class
    (medians rtol 5e-3, phi_norm rtol 1e-4, the first clipped phi and the
    samples rtol 2e-4 / atol 1e-6), the samples outside Adam's eps regime
    (adam_eps_regime)."""
    n, p = 1000, 303
    X, y, theta0 = _nn_problem(n)
    jm, tm = JNN(1, 100, 20, 20, prior_beta=10.0), TNN(1, 100, 20, 20,
                                                       prior_beta=10.0)
    jcfg = sj.throughput_config(n, p, model=jm, pallas_interpret=True)
    tcfg = st.throughput_config(n, p, model=tm)
    assert tcfg["kernel_impl"] == "pallas"
    assert tcfg["median_impl"] == "fused_gram"
    gd = dict(learning_rate=0.1, decay=0.999)

    def port():
        return st.SVGDSampler(n, tm.log_p, tm.template(), st.Adam(**gd),
                              theta=theta0, device="cpu", **tcfg)

    def jax():
        return sj.SVGDSampler(n, jm.log_p, jm.template(), sj.Adam(**gd),
                              theta=jnp.asarray(theta0), **jcfg)

    jb = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    tb = {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}
    js, ts, jfirst, tfirst = jax(), port(), jax(), port()
    jfirst.run(jb, 1)
    tfirst.run(tb, 1)
    phi1 = np.asarray(jfirst.state.opt_state.mu)   # Adam's mu after step 1
    np.testing.assert_allclose(tfirst.state.opt_state.mu.numpy(), phi1,
                               rtol=2e-4, atol=1e-6)
    ill = adam_eps_regime(phi1)
    assert ill.mean() < 1e-4, f"{ill.sum()} coordinates near Adam's eps"
    ja, ta = js.run(jb, 5), ts.run(tb, 5)
    np.testing.assert_allclose(ta["median"].numpy(), np.asarray(ja["median"]),
                               rtol=5e-3)
    np.testing.assert_allclose(ta["phi_norm"].numpy(),
                               np.asarray(ja["phi_norm"]), rtol=1e-4)
    np.testing.assert_allclose(ts.samples[~ill], js.samples[~ill], rtol=2e-4,
                               atol=1e-6)
    for _ in range(3):
        aj, at = js.train_on_batch(jb), ts.train_on_batch(tb)
        np.testing.assert_allclose(at["median"].numpy(),
                                   np.asarray(aj["median"]), rtol=5e-3)
        np.testing.assert_allclose(at["phi_norm"].numpy(),
                                   np.asarray(aj["phi_norm"]), rtol=1e-4)
    np.testing.assert_allclose(ts.samples[~ill], js.samples[~ill], rtol=2e-4,
                               atol=1e-6)


def test_slice_matches_jax_interpret():
    """The main path: throughput_config(512, 16) picks fused_gram, and
    m*n = 256*512 > 100k routes init_med through kernel B2's plain version.
    Held to the JAX suite's fused_gram class (tests/test_pallas_step.py)."""
    n, p = 512, 16
    X, y, theta0 = _problem(n=n, p=p)
    jcfg = sj.throughput_config(n, p, pallas_interpret=True)
    tcfg = st.throughput_config(n, p)
    assert tcfg["step_impl"] == "fused_gram"
    js, ts, jb, tb = _pair(X, y, theta0, dict(learning_rate=1e-1),
                           jcfg, tcfg)
    ja, ta = js.run(jb, 10), ts.run(tb, 10)
    assert set(ta) == {"phi_norm", "log_p_mean", "h2", "median"}
    assert all(v.shape == (10,) for v in ta.values())
    np.testing.assert_allclose(ta["median"].numpy(), np.asarray(ja["median"]),
                               rtol=5e-3)
    np.testing.assert_allclose(ts.samples, js.samples, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(ta["phi_norm"].numpy(),
                               np.asarray(ja["phi_norm"]), rtol=1e-4)
    assert int(ts.state.step) == 10
    assert int(ts.state.opt_state.count) == 10


@pytest.mark.parametrize("rule,gd_kw", [
    ("Adam", dict(learning_rate=1e-1, decay=0.99)),
    ("Adagrad", dict(learning_rate=5e-2)),
])
def test_state_handoff_from_jax(rule, gd_kw):
    """JAX runs 5 steps; its state crosses over through state_from_numpy;
    both run 5 more (count > 0, a decayed lr) at the reference tolerance."""
    X, y, theta0 = _problem()
    js, ts, jb, tb = _pair(X, y, theta0, gd_kw, {}, {}, rule)
    js.run(jb, 5)
    s = js.state
    ts.load_state(state_from_numpy(
        np.asarray(s.particles),
        {k: np.asarray(v) for k, v in s.opt_state._asdict().items()},
        np.asarray(s.step), device="cpu"))
    assert int(ts.state.step) == 5
    js.run(jb, 5)
    ts.run(tb, 5)
    np.testing.assert_allclose(ts.samples, js.samples, **REF_TOL)
    np.testing.assert_allclose(float(ts.state.opt_state.learning_rate),
                               float(js.state.opt_state.learning_rate),
                               rtol=1e-6)


def test_load_state_rejects_mismatch():
    X, y, theta0 = _problem()
    _, ts, _, _ = _pair(X, y, theta0, {}, {}, {})
    bad = state_from_numpy(theta0[:10], {
        "mu": np.zeros((10, 6), np.float32),
        "nu": np.zeros((10, 6), np.float32),
        "count": 0, "learning_rate": np.float32(0.1)}, 0, device="cpu")
    with pytest.raises(ValueError, match="particles"):
        ts.load_state(bad)
    with pytest.raises(ValueError, match="Adam"):
        state_from_numpy(theta0, {"m": 0}, 0, device="cpu")


def _sampler(**kw):
    X, y, theta0 = _problem()
    m = TModel(6)
    kw.setdefault("device", "cpu")
    return st.SVGDSampler(48, m.log_p, m.template(), st.Adam(),
                          theta=theta0, **kw)


def _lr_grads():
    m = TModel(6)
    return _make_grad_all(m.log_p, template_unraveler(m.template())[1])


def _glm_inkernel_model(batch):
    """The linear model's quadratic form as a generic in-kernel model."""
    A_eff, b_eff, const = TModel(6).quadratic_form(batch)
    return InKernelModel((A_eff, b_eff.reshape(1, -1)), GlmGrad(), const)


@pytest.mark.parametrize("kw", [
    dict(median="bisect", kernel_impl="pallas"),
    dict(median="bisect", kernel_impl="pallas", median_impl="fused_gram",
         warm_median=True),
    dict(custom_grads="lr"),
    dict(median="bisect", warm_median=True, step_impl="fused"),
    dict(median="bisect", warm_median=True, step_impl="fused_glm",
         quadratic_form=TModel(6).quadratic_form),
    dict(median="bisect", warm_median=True, step_impl="fused_model",
         inkernel_model=_glm_inkernel_model),
    dict(median="bisect", warm_median=True, kernel_impl="pallas",
         step_impl="epilogue"),
    dict(median="bisect", kernel_impl="pallas", pallas_precision="bf16"),
    dict(donate=False, pallas_interpret=True),
    dict(kernel=st.InverseMultiquadricKernel()),
    dict(remat=True),
    dict(median="bisect", warm_median=True, remat=True),
])
def test_ported_options_construct_and_step(kw):
    """Options that raised before they were ported (the streaming tile,
    the in-kernel-Gram median, custom_grads, the step tails 'fused',
    'fused_glm', 'fused_model', 'epilogue', the tile's bf16 operands, a
    non-RBF kernel=, remat=) or were refused (the JAX keywords donate=,
    pallas_interpret=): each constructs and steps."""
    X, y, _ = _problem()
    if kw.get("custom_grads") == "lr":
        kw = dict(custom_grads=_lr_grads())
    s = _sampler(**kw)
    batch = {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}
    aux = s.train_on_batch(batch)
    assert all(torch.isfinite(v).all() for v in aux.values())
    aux = s.run(batch, 2)
    assert all(v.shape == (2,) for v in aux.values())
    assert int(s.state.step) == 3 and np.isfinite(s.samples).all()


@pytest.fixture(scope="module")
def mesh1():
    with one_process_mesh() as mesh:
        yield mesh


@pytest.mark.parametrize("kw", [
    lambda mesh: _sampler(mesh=mesh_2d(1, 1), model_axis="model"),
    dict(median="binned", binned_bins=1024),
    dict(median="binned", binned_block_rows=128),
    lambda mesh: st.throughput_config(48, 6, mesh=mesh_2d(1, 1),
                                      model_axis="model"),
    dict(median="subsample"),
    dict(median="binned"),
])
def test_unported_options_raise(kw, mesh1):
    """The options that raised NotImplementedError until ROADMAP A5 and A7
    were ported: the 2-D mesh (model_axis=), the other medians and
    their settings. Each now builds, and a sampler takes finite steps."""
    X, y, _ = _problem()
    got = kw(mesh1) if callable(kw) else _sampler(**kw)
    if isinstance(got, dict):
        assert got["model_axis"] == "model" and "mesh" in got
        return
    batch = {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}
    aux = got.run(batch, 2)
    assert all(torch.isfinite(v).all() for v in aux.values())
    assert np.isfinite(got.samples).all()


@pytest.mark.parametrize("make", [
    lambda: _sampler(mesh=object()),
    lambda: st.throughput_config(48, 6, mesh=object()),
])
def test_mesh_must_be_a_particle_mesh(make):
    with pytest.raises(TypeError, match="ParticleMesh"):
        make()


@pytest.mark.parametrize("kw,match", [
    (dict(n_particles=1), "n_particles"),
    (dict(median="bisect", step_impl="fused_gram"), "warm_median"),
    (dict(median="exact", warm_median=True, step_impl="fused_gram"),
     "warm_median"),
    (dict(median="bisect", warm_median=True, step_impl="fused_gram",
          n_particles=20000, theta=None), "gate"),
    (dict(median="bisect", warm_median=True, step_impl="fused_gram",
          dtype=torch.float64), "f32"),
    (dict(step_impl="bogus"), "unknown step_impl"),
    (dict(median_impl="fused"), "requires median='bisect'"),
    (dict(median="bogus"), "unknown median"),
    (dict(median="exact", kernel_impl="pallas"), "median='exact'"),
    (dict(kernel_impl="bogus"), "unknown kernel_impl"),
    (dict(median="bisect", median_impl="fused_gram"), "kernel_impl='pallas'"),
    (dict(custom_grads=lambda t, b: None, remat=True), "remat"),
    (dict(median="bisect", warm_median=True, step_impl="fused_gram",
          custom_grads=lambda t, b: None), "custom_grads"),
    (dict(median="bisect", warm_median=True, step_impl="fused_glm"),
     "quadratic_form"),
    (dict(median="bisect", step_impl="fused",
          quadratic_form=TModel(6).quadratic_form), "fused_glm"),
    (dict(median="bisect", warm_median=True, step_impl="fused_model"),
     "inkernel_model"),
    (dict(median="bisect", kernel_impl="pallas", step_impl="epilogue"),
     "warm_median"),
    (dict(median="bisect", warm_median=True, step_impl="epilogue"),
     "kernel_impl='pallas'"),
])
def test_jax_value_error_guards_hold(kw, match):
    n = kw.pop("n_particles", 48)
    theta = kw.pop("theta", _problem()[2])
    m = TModel(6)
    with pytest.raises(ValueError, match=match):
        st.SVGDSampler(n, m.log_p, m.template(), st.Adam(), theta=theta,
                       device="cpu", **kw)


def test_import_loads_no_jax():
    code = ("import sys, stein_tpu_torch, stein_tpu_torch.api, "
            "stein_tpu_torch.ops.fused_step, stein_tpu_torch._cuda, "
            "stein_tpu_torch.ops.svgd_tile, stein_tpu_torch.ops.model_grad, "
            "stein_tpu_torch.models.bayesian_nn, "
            "stein_tpu_torch.models.logistic_regression, "
            "stein_tpu_torch.parallel, stein_tpu_torch.parallel.mesh, "
            "stein_tpu_torch.parallel.collectives, "
            "stein_tpu_torch.parallel.sharded, "
            "stein_tpu_torch.parallel.sharded_fused; "
            "assert 'jax' not in sys.modules, 'jax imported'; print('ok')")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr


def _imported_roots(path):
    import ast

    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_nothing_of_the_jax_package():
    """No module of the port, nor chip_smoke.py, bench_torch.py, an example
    CLI of examples_torch/ or tests/test_torch_fidelity.py (which runs on
    the card without the JAX package's conftest), imports jax, anything of
    stein_tpu or the JAX package's benchmarks/, at any depth of the code (a
    lazy import inside a function included)."""
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    files = sorted((root / "stein_tpu_torch").rglob("*.py"))
    files += [root / "chip_smoke.py", root / "bench_torch.py",
              root / "tests" / "test_torch_fidelity.py"]
    examples = sorted((root / "examples_torch").glob("*.py"))
    assert len(examples) >= 6
    files += examples
    bad = {str(f.relative_to(root)):
           _imported_roots(f) & {"jax", "stein_tpu", "benchmarks"}
           for f in files}
    assert len(files) > 20
    assert not any(bad.values()), bad


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _sampler(device="cuda")


@pytest.mark.parametrize("make", [
    lambda: _sampler(device=None),
    lambda: state_from_numpy(_problem()[2], {
        "hist": np.zeros((48, 6), np.float32), "count": 0,
        "learning_rate": np.float32(0.1)}, 0),
])
def test_default_device_is_the_card(make):
    """With no device given, the sampler and state_from_numpy take the
    current card and, without one, raise (no fallback to the CPU); on the
    card, tests/test_torch_cuda.py checks that they resolve to cuda:0."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


def test_batch_on_another_device_raises():
    s = _sampler()
    with pytest.raises(ValueError, match="device"):
        s.run({"X": torch.zeros(2, 6, device="meta"),
               "y": torch.zeros(2, 1)}, 1)


GD_CASES = [("Adam", dict(learning_rate=1e-1, decay=0.999)),
            ("Adagrad", dict(learning_rate=5e-2))]
WARM = dict(median="bisect", warm_median=True, warm_passes=6)


def _run_both(js, ts, jb, tb, steps=15):
    ja, ta = js.run(jb, steps), ts.run(tb, steps)
    return ({k: np.asarray(v) for k, v in ja.items()},
            {k: v.numpy() for k, v in ta.items()})


@pytest.mark.parametrize("rule,gd_kw", GD_CASES)
def test_fused_glm_trajectory_matches_jax(rule, gd_kw):
    """step_impl='fused_glm' on the sufficient-statistics batch, 15 steps
    against the JAX sampler in interpret mode, at tests/test_pallas_step.py
    :245's class: medians rtol 5e-3, log_p_mean rtol 1e-4, samples rtol
    2e-4 / atol 1e-6."""
    X, y, theta0 = _problem()
    jm, tm = JModel(6), TModel(6)
    js, ts, jb, tb = _pair(
        X, y, theta0, gd_kw,
        dict(step_impl="fused_glm", quadratic_form=jm.quadratic_form,
             pallas_interpret=True, **WARM),
        dict(step_impl="fused_glm", quadratic_form=tm.quadratic_form,
             **WARM), rule)
    ja, ta = _run_both(js, ts, jm.sufficient_batch(jb),
                       tm.sufficient_batch(tb))
    np.testing.assert_allclose(ta["median"], ja["median"], rtol=5e-3)
    np.testing.assert_allclose(ta["log_p_mean"], ja["log_p_mean"], rtol=1e-4)
    np.testing.assert_allclose(ts.samples, js.samples, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("rule,gd_kw", GD_CASES)
def test_fused_d_given_trajectory_matches_jax(rule, gd_kw):
    """step_impl='fused' (D from pairwise_sq_dists, B1's D-given branch),
    15 steps at tests/test_pallas_step.py:48's class: the first median
    bitwise, medians rtol 5e-3, samples rtol 2e-4 / atol 1e-6, phi_norm
    rtol 1e-4."""
    X, y, theta0 = _problem()
    js, ts, jb, tb = _pair(
        X, y, theta0, gd_kw,
        dict(step_impl="fused", pallas_interpret=True, **WARM),
        dict(step_impl="fused", **WARM), rule)
    ja, ta = _run_both(js, ts, jb, tb)
    assert ta["median"][0] == ja["median"][0]
    np.testing.assert_allclose(ta["median"], ja["median"], rtol=5e-3)
    np.testing.assert_allclose(ts.samples, js.samples, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(ta["phi_norm"], ja["phi_norm"], rtol=1e-4)


@pytest.mark.parametrize("rule,gd_kw", GD_CASES)
def test_epilogue_trajectory_matches_jax(rule, gd_kw):
    """step_impl='epilogue' (the tile, then B6), 15 steps at
    tests/test_pallas_step.py:293's class: the first median bitwise,
    medians, samples and phi_norm rtol 1e-5 (samples atol 1e-7)."""
    X, y, theta0 = _problem()
    cfg = dict(step_impl="epilogue", kernel_impl="pallas", **WARM)
    js, ts, jb, tb = _pair(X, y, theta0, gd_kw,
                           dict(pallas_interpret=True, **cfg), cfg, rule)
    ja, ta = _run_both(js, ts, jb, tb)
    assert ta["median"][0] == ja["median"][0]
    np.testing.assert_allclose(ta["median"], ja["median"], rtol=1e-5)
    np.testing.assert_allclose(ts.samples, js.samples, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ta["phi_norm"], ja["phi_norm"], rtol=1e-5)


def test_glm_slice_matches_jax_interpret():
    """BASELINE config #1's route (bench.py:bench_adagrad50): n=50, p=128,
    Adagrad(0.1), throughput_config(model=LinearRegressionModel) picks
    fused_glm; 4 steps on the sufficient batch against the JAX package at
    the fused_glm class. Not 10: the recipe is chaotic (A = X^T X + I over
    1000 observations, Adagrad's near-sign step), and the JAX package's own
    xla and fused_glm paths leave that class from step 4 (by 1.9e-5 there,
    2.2e-3 at step 10, CPU), the port from step 5."""
    n, p = 50, 128
    rng = np.random.default_rng(0)
    X = rng.normal(size=(1000, p)).astype(np.float32)
    y = (X @ rng.normal(size=(p, 1))
         + rng.normal(size=(1000, 1)) * 0.3).astype(np.float32)
    theta0 = (np.random.default_rng(3).normal(size=(n, p)) * 0.01
              ).astype(np.float32)
    jm, tm = JModel(p), TModel(p)
    jcfg = sj.throughput_config(n, p, model=jm, pallas_interpret=True)
    tcfg = st.throughput_config(n, p, model=tm)
    assert tcfg["step_impl"] == "fused_glm"
    js, ts, jb, tb = _pair(X, y, theta0, dict(learning_rate=0.1), jcfg, tcfg,
                           "Adagrad")
    ja, ta = _run_both(js, ts, jm.sufficient_batch(jb),
                       tm.sufficient_batch(tb), 4)
    np.testing.assert_allclose(ta["median"], ja["median"], rtol=5e-3)
    np.testing.assert_allclose(ta["log_p_mean"], ja["log_p_mean"], rtol=1e-4)
    np.testing.assert_allclose(ts.samples, js.samples, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("n", [50, 1000, 1024, 10240])
@pytest.mark.parametrize("p", [16, 128, 303])
def test_throughput_config_with_linear_model_matches_jax(n, p):
    want = sj.throughput_config(n, p, model=JModel(p))
    got = st.throughput_config(n, p, model=TModel(p))
    assert got.pop("dtype") is torch.float32
    assert want.pop("dtype") == jnp.float32
    assert _presence(got) == _presence(want)


def _mesh_2d_shape(dp, mp):
    """A Mesh2D of rank 0's views, no process group (throughput_config
    reads its axes and sizes only)."""
    return Mesh2D(ParticleMesh(None, "particles", dp, 0, "cpu"),
                  ParticleMesh(None, "model", mp, 0, "cpu"))


@pytest.mark.parametrize("dp,mp", [(1, 1), (2, 1), (1, 2), (4, 2)])
@pytest.mark.parametrize("n,p,dtype", [
    (1000, 128, "f32"), (1000, 303, "f32"), (10240, 64, "f32"),
    (64, 8, "f64"), (4096, 16, "f64")])
def test_throughput_config_2d_matches_jax(dp, mp, n, p, dtype):
    """throughput_config(n, p, mesh=, model_axis=) on a dp x mp mesh equal
    to JAX's dict on as many fake devices (the mesh aside)."""
    import jax
    from jax.sharding import Mesh

    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.float64, torch.float64))
    jmesh = Mesh(np.asarray(jax.devices()[:dp * mp]).reshape(dp, mp),
                 ("particles", "model"))
    want = sj.throughput_config(n, p, mesh=jmesh, model_axis="model",
                                dtype=jdt)
    got = st.throughput_config(n, p, mesh=_mesh_2d_shape(dp, mp),
                               model_axis="model", dtype=tdt)
    assert isinstance(got.pop("mesh"), Mesh2D)
    want.pop("mesh")
    assert got.pop("dtype") is tdt and want.pop("dtype") == jdt
    assert got == want
