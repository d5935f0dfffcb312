"""bench_torch.py (the port's bench) against bench.py (the JAX package's),
and stein_tpu_torch.utils.enable_compilation_cache.

- The JSON line: bench_torch's keys equal bench.py's, read from bench.py's
  source with ``ast`` (``bench_torch.bench_py_keys``; bench.py is not
  run); with a tiny budget the line still prints and holds the primary
  keys.
- Each row's sampler, built by bench_torch's builder on the CPU (the plain
  versions), against the JAX sampler built with bench.py's keywords (its
  module-level builders where it has them: ``bench.make_data``,
  ``bench.make_sampler``, ``benchmarks/nn_bench.py``'s ``make_problem`` and
  ``make_sampler``, ``benchmarks/meshL_workload.make_meshL_sampler``;
  otherwise its keywords copied here with their lines) with its Pallas
  kernels in interpret mode, for 3 steps at the path's class. Where the
  port draws its particles from a torch generator (the JAX rows' PRNG
  keys), the JAX sampler takes the port's initial particles. The n10240
  and meshL rows run at n=1024 and the Covertype row for 3 iterations of
  its 6000; every other keyword is unchanged.

bench.py and benchmarks/nn_bench.py call the JAX package's
``enable_compilation_cache()`` (a persistent XLA cache under /tmp) when
imported; the ``jbench`` fixture imports them with it stubbed."""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import bench_torch as bt
import stein_tpu as sj
from stein_tpu.models import BayesianNNModel as JNN
from stein_tpu.models import LinearRegressionModel as JLR
from stein_tpu.models import LogisticRegressionModel as JLogit
from stein_tpu_torch import _cuda
from stein_tpu_torch.api import minibatch_indices
from stein_tpu_torch.parallel import mesh_2d, particle_mesh
from stein_tpu_torch.utils import enable_compilation_cache

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL_N = 1024
# The class of every row: the JAX suite's fused_gram class
# (tests/test_pallas_step.py; medians rtol 5e-3, phi_norm rtol 1e-4,
# samples rtol 2e-4 / atol 1e-6), ROADMAP's contract for the kernels that
# compute D in-kernel and for the warm mesh steps. The tighter classes of
# tests/test_torch_mesh.py (fused_shard: medians rtol 1e-6) and
# tests/test_torch_sharded2d.py hold at their small shapes; at the rows'
# full widths the two packages' D entries round apart (other dot orders),
# and a warm search then ends one final interval away (measured 3.1e-5
# relative on the mesh rows, 1.8e-6 on the 2-D row).
TOL, MED_RTOL = dict(rtol=2e-4, atol=1e-6), 5e-3
# The mesh1 rows' samples and first moment: JAX's tile sums K @ u in
# 256-wide blocks (pallas_block), the port's plain version in one product,
# and this recipe's phi cancels (gradients ~40 against a clipped phi); the
# JAX suite holds fused_shard against another in-kernel-Gram path at rtol
# 2e-2 / atol 1e-4 ("same class, different tile/center fp order",
# tests_tpu/test_tpu_fidelity.py:776-777). Measured: rtol 4e-4. The NN and
# meshL mesh rows hold TOL.
SHARD_TOL = dict(rtol=2e-2, atol=1e-4)
# The sign-ambiguity mask's threshold for the in-kernel-Gram paths and the
# bound of two Adam sign flips (tests_tpu/test_tpu_fidelity.py:43-71).
AMB_TOL, FLIP_BOUND, AMB_FRAC = 3e-3, 2 * 2 * 0.1 * 0.3163, 0.1


@pytest.fixture(scope="module")
def jbench():
    """(bench, nn_bench, meshL_workload), imported with the JAX package's
    enable_compilation_cache stubbed for the import."""
    import stein_tpu.utils.cache as cache

    saved = cache.enable_compilation_cache
    cache.enable_compilation_cache = lambda *a, **k: None
    try:
        import bench
        from benchmarks import meshL_workload, nn_bench
    finally:
        cache.enable_compilation_cache = saved
    return bench, nn_bench, meshL_workload


@pytest.fixture
def meshes():
    """A one-process gloo group: the port's 1-D mesh and its 1 x 1 2-D
    mesh."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield particle_mesh(), mesh_2d(1, 1)
    finally:
        dist.destroy_process_group()


def _jax_mesh(two_d=False):
    devs = np.asarray(jax.devices()[:1])
    if two_d:
        return Mesh(devs.reshape(1, 1), ("particles", "model"))
    return Mesh(devs, ("particles",))


# ------------------------------------------------------------ the JSON line
def _shrink(monkeypatch):
    """bench_torch at a CPU test's size: one short slope a row, one oracle
    step, n=1024 for the n10240 and meshL rows, 3 Covertype iterations."""
    monkeypatch.setattr(bt, "SLOPES", {k: (2, 2, 1, 1) for k in bt.SLOPES})
    monkeypatch.setattr(bt, "NP_STEPS", 1)
    monkeypatch.setattr(bt, "N2", SMALL_N)
    monkeypatch.setattr(bt, "MESHL_N", SMALL_N)
    monkeypatch.setattr(bt, "COVERTYPE_ITERS", 3)
    monkeypatch.setattr(bt, "COVERTYPE_REPS", 1)


def test_json_keys_equal_bench_py(monkeypatch, capsys):
    """Every row runs (on the CPU, shrunk) and the printed line has
    bench.py's keys exactly, with positive numbers."""
    top, extra = bt.bench_py_keys()
    assert len(extra) == 21, sorted(extra)
    _shrink(monkeypatch)
    assert bt.main([], device="cpu") == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert set(line) == top
    assert set(line["extra"]) == extra, set(line["extra"]) ^ extra
    assert line["metric"] == "particle-updates/s/chip (n=1000, p=128)"
    assert line["unit"] == "particle-updates/s"
    # Numbers (a CPU slope of a few steps may round to 0; the card run
    # holds them positive).
    assert all(v >= 0 for v in line["extra"].values())
    assert line["value"] > 0 and line["vs_baseline"] > 0
    assert "skipped" not in out.err and "failed" not in out.err


def test_tiny_budget_still_prints_the_primary(monkeypatch, capsys):
    _shrink(monkeypatch)
    assert bt.main(["--budget-s", "0"], device="cpu") == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert set(line["extra"]) == {"n1000_step_us"}
    for name in ("glm", "covertype_e2e", "mesh2d", "n10240"):
        assert f"row {name!r} skipped" in out.err


def test_bench_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bt.main([])


# ------------------------------------------------------------ the samplers
def _compare(ts, js, tb, jb, tol=TOL, steps=3):
    """``steps`` steps of both samplers (one, then the rest: the carry is
    seeded once per call in both packages): medians at MED_RTOL, phi_norm
    and log_p_mean at rtol 1e-4, Adam's first moment and the samples at
    ``tol``.

    Adam's first steps are sign-like, so where a coordinate's phi is near
    zero an f32 rounding difference moves that coordinate's sample by up
    to a whole step. Those coordinates (the JAX suite's sign-ambiguity
    mask, tests_tpu/test_tpu_fidelity.py:63-71: Adam's first moment within
    AMB_TOL of zero relative to its largest entry, after the first step or
    the last) are held through the first moment at the class, and their
    samples within FLIP_BOUND; at most AMB_FRAC of the coordinates (the
    measured share is 0.07-7.6%: whole columns of the LR rows, whose
    gradients nearly cancel, sit near zero)."""
    amb = np.zeros(ts.samples.shape, bool)
    for k in (1, steps - 1):
        ja, ta = js.run(jb, k), ts.run(tb, k)
        np.testing.assert_allclose(ta["median"].numpy(),
                                   np.asarray(ja["median"]), rtol=MED_RTOL)
        np.testing.assert_allclose(ta["phi_norm"].numpy(),
                                   np.asarray(ja["phi_norm"]), rtol=1e-4)
        np.testing.assert_allclose(ta["log_p_mean"].numpy(),
                                   np.asarray(ja["log_p_mean"]), rtol=1e-4)
        if hasattr(js.state.opt_state, "mu"):   # Adam (Adagrad: no moment)
            mu = np.asarray(js.state.opt_state.mu)
            amb |= np.abs(mu) < AMB_TOL * np.abs(mu).max()
            np.testing.assert_allclose(ts.state.opt_state.mu.numpy()[~amb],
                                       mu[~amb], **tol)
    assert amb.mean() <= AMB_FRAC, amb.mean()
    got, want = ts.samples, np.asarray(js.samples)
    np.testing.assert_allclose(got[~amb], want[~amb], **tol)
    assert np.all(np.abs(got - want) < FLIP_BOUND)


def _jax_batch(X, y):
    return {"X": jnp.asarray(X, jnp.float32), "y": jnp.asarray(y, jnp.float32)}


@pytest.mark.parametrize("row", ["n1000", "glm", "n10240"])
def test_linear_rows_match_jax(row, jbench):
    """The primary row (bench.py:366-400), the GLM row (:420-425) and the
    n10240 row (:577-594, at n=1024), through bench.make_data and
    bench.make_sampler."""
    bench = jbench[0]
    n, seed, kw = {
        "n1000": (1000, 0, dict(
            median="bisect", median_passes=16, warm_median=True,
            warm_passes=6, median_impl="fused", median_max_rows=256,
            step_impl="fused_gram")),
        "glm": (1000, 0, dict(
            glm=True, median="bisect", median_passes=16, warm_median=True,
            warm_passes=6, median_impl="fused", median_max_rows=128)),
        "n10240": (SMALL_N, 1, dict(
            kernel_impl="pallas", median="bisect", median_passes=16,
            warm_median=True, warm_passes=8, pallas_block=1024,
            median_max_rows=128, median_impl="fused")),
    }[row]
    port_kw = {"n1000": bt.PRIMARY_KW, "glm": bt.GLM_KW,
               "n10240": bt.N10240_KW}[row]
    X, y, theta0 = bench.make_data(n, seed=seed)
    js, jb = bench.make_sampler(X, y, theta0, pallas_interpret=True, **kw)
    ts, tb = bt.make_sampler(X, y, theta0, device="cpu", **port_kw)
    _compare(ts, js, tb, jb)


def test_adagrad50_row_matches_jax(jbench):
    """BASELINE #1 (bench.py:321-352): n=50, Adagrad(0.1),
    throughput_config(model=) on the sufficient batch."""
    bench = jbench[0]
    X, y, _ = bench.make_data(1000)
    model = JLR(bench.N_PARAMS)
    theta0 = np.random.default_rng(3).normal(size=(50, bench.N_PARAMS)) * 0.01
    js = sj.SVGDSampler(
        n_particles=50, log_p=model.log_p, param_template=model.template(),
        gd=sj.Adagrad(learning_rate=1e-1),
        theta=jnp.asarray(theta0, jnp.float32),
        **sj.throughput_config(50, bench.N_PARAMS, model=model,
                               pallas_interpret=True))
    jb = model.sufficient_batch(_jax_batch(X, y))
    ts, tb = bt.make_adagrad50(X, y, device="cpu")
    _compare(ts, js, tb, jb)


def test_logreg_row_matches_jax():
    """BASELINE #2's shape (bench.py:176-210), its keywords at :197-206."""
    rng = np.random.default_rng(7)
    n, d, n_obs = 1000, 54, 50
    Xl = rng.normal(size=(n_obs, d))
    yl = (Xl @ rng.normal(size=(d, 1)) > 0).astype(np.float64)
    model = JLogit(d, n_train=581012, n_batch=n_obs)
    theta0 = jnp.asarray(rng.normal(size=(n, d + 1)) * 0.1, jnp.float32)
    js = sj.SVGDSampler(
        n_particles=n, log_p=model.log_p, param_template=model.template(),
        gd=sj.Adam(learning_rate=1e-1), theta=theta0,
        median="bisect", median_passes=16, warm_median=True,
        warm_passes=6, step_impl="fused_model",
        inkernel_model=model.inkernel_model, median_max_rows=128,
        pallas_interpret=True)
    ts, tb = bt.make_logreg(device="cpu")
    _compare(ts, js, tb, _jax_batch(Xl, yl))


def test_covertype_row_matches_jax():
    """The full Covertype run (bench.py:213-281; the sampler at :262-268)
    for 3 of its 6000 iterations: the port's train_minibatched(data, 3, 50,
    key=7) against the JAX sampler's train_on_batches on the rows that
    minibatch_indices(7, ...) draws (the two PRNGs draw other indices)."""
    X, y = bt.covertype_data()
    assert X.shape == (464809, 54)
    ts, data = bt.make_covertype(X, y, device="cpu")
    model = JLogit(54, n_train=X.shape[0], n_batch=50)
    js = sj.SVGDSampler(
        n_particles=100, log_p=model.log_p, param_template=model.template(),
        gd=sj.Adam(learning_rate=1e-1), theta=jnp.asarray(ts.samples),
        median="bisect", median_passes=16, warm_median=True,
        warm_passes=6, median_impl="fused", step_impl="fused_model",
        inkernel_model=model.inkernel_model, pallas_interpret=True)
    ta = ts.train_minibatched(data, 3, 50, 7)
    idx = minibatch_indices(7, 3, 50, X.shape[0], torch.device("cpu"))
    ja = js.train_on_batches({"X": jnp.asarray(X[idx.numpy()]),
                              "y": jnp.asarray(y[idx.numpy()])})
    np.testing.assert_allclose(ta["median"].numpy(), np.asarray(ja["median"]),
                               rtol=MED_RTOL)
    np.testing.assert_allclose(ta["log_p_mean"].numpy(),
                               np.asarray(ja["log_p_mean"]), rtol=1e-4)
    np.testing.assert_allclose(ts.samples, js.samples, **TOL)


def test_nn_row_matches_jax():
    """BASELINE #3 (bench.py:284-318): the NN at n=1000 through
    throughput_config(model=), the JAX sampler from the port's particles."""
    rng = np.random.default_rng(11)
    Xn = rng.uniform(size=(20, 1))
    yn = rng.normal(np.cos(10 * Xn) * (5 * Xn), 0.1)
    model = JNN(1, 100, 20, 20, prior_beta=10.0)
    ts, tb = bt.make_nn(device="cpu")
    js = sj.SVGDSampler(
        n_particles=1000, log_p=model.log_p, param_template=model.template(),
        gd=sj.Adam(learning_rate=1e-1, decay=0.999),
        theta=jnp.asarray(ts.samples),
        **sj.throughput_config(1000, 303, model=model, pallas_interpret=True))
    _compare(ts, js, tb, _jax_batch(Xn, yn))


@pytest.mark.parametrize("name", list(bt.MESH1_ARMS))
def test_mesh1_rows_match_jax(name, jbench, meshes):
    """The 1-D mesh rows (bench.py:470-505): fused_shard on the sufficient
    batch with the quadratic form, rounds / grid / ring; the port on a
    one-process gloo group, JAX on a 1-device mesh."""
    bench = jbench[0]
    arm = {"mesh1_fused_shard": dict(median_collectives="rounds"),
           "mesh1_fused_shard_grid": dict(median_collectives="grid",
                                          median_grid_g1=8),
           "mesh1_fused_shard_ring": dict(median_collectives="grid",
                                          median_grid_g1=8,
                                          comm="ring")}[name]
    X, y, theta0 = bench.make_data(1000)
    js, jb = bench.make_sampler(
        X, y, theta0, suff_stats=True, mesh=_jax_mesh(),
        step_impl="fused_shard", pallas_block=256, median="bisect",
        median_passes=16, warm_median=True, warm_passes=6,
        quadratic_form=JLR(bench.N_PARAMS).quadratic_form,
        median_max_rows=256, pallas_interpret=True, **arm)
    ts, tb = bt.make_mesh1(X, y, theta0, meshes[0], device="cpu",
                           **bt.MESH1_ARMS[name])
    _compare(ts, js, tb, jb, SHARD_TOL)


def test_nn_mesh_row_matches_jax(jbench, meshes):
    """The NN on the mesh (bench.py:512-531) through nn_bench's
    make_problem and make_sampler (the port's particles as theta)."""
    _, nn_bench, _ = jbench
    model, jb = nn_bench.make_problem(1000)
    ts, tb = bt.make_nn_mesh(meshes[0], device="cpu")
    js = nn_bench.make_sampler(
        model, 1000, mesh=_jax_mesh(), median="bisect", warm_median=True,
        step_impl="fused_shard", pallas_block=256, median_max_rows=128,
        median_collectives="rounds",
        custom_grads=model.pallas_grads(interpret=True),
        theta=jnp.asarray(ts.samples), pallas_interpret=True)
    _compare(ts, js, tb, jb)


def test_mesh2d_row_matches_jax(jbench, meshes):
    """The tuned 2-D selection on a 1 x 1 mesh (bench.py:538-550)."""
    bench = jbench[0]
    X, y, theta0 = bench.make_data(1000)
    cfg = sj.throughput_config(1000, bench.N_PARAMS, mesh=_jax_mesh(True),
                               model_axis="model", pallas_interpret=True)
    js, jb = bench.make_sampler(X, y, theta0, warm_passes=6, **cfg)
    ts, tb = bt.make_mesh2d(X, y, theta0, meshes[1], device="cpu")
    _compare(ts, js, tb, jb)


@pytest.mark.parametrize("name", list(bt.MESHL_ARMS))
def test_meshL_rows_match_jax(name, jbench, meshes, monkeypatch):
    """The large-n mesh rows (bench.py:555-572) through
    benchmarks/meshL_workload.make_meshL_sampler, at n=1024 (p=64 and the
    rest unchanged)."""
    meshL = jbench[2]
    monkeypatch.setattr(meshL, "N_PARTICLES", SMALL_N)
    monkeypatch.setattr(bt, "MESHL_N", SMALL_N)
    arm = {"meshL_fused_shard": dict(median_collectives="rounds"),
           "meshL_fused_shard_grid": dict(median_collectives="grid",
                                          median_grid_g1=8)}[name]
    js, jb = meshL.make_meshL_sampler(_jax_mesh(), n_obs=1000,
                                      pallas_interpret=True, **arm)
    ts, tb = bt.make_meshL_sampler(meshes[0], n_obs=1000, device="cpu",
                                   **bt.MESHL_ARMS[name])
    _compare(ts, js, tb, jb)


# ------------------------------------------------------------- the cache
def test_enable_compilation_cache_moves_the_build_root(tmp_path,
                                                       monkeypatch):
    """It makes and returns its path and points _cuda's build root there,
    without building (library() is not called: no nvcc here)."""
    monkeypatch.setattr(_cuda, "BUILD_ROOT", _cuda.BUILD_ROOT)
    built = []
    monkeypatch.setattr(_cuda, "_build", lambda *a: built.append(a))
    path = str(tmp_path / "kernels")
    assert enable_compilation_cache(path) == path
    assert pathlib.Path(path).is_dir()
    assert _cuda.BUILD_ROOT == pathlib.Path(path)
    assert enable_compilation_cache(path, min_compile_secs=0.0) == path
    assert not built and not any(pathlib.Path(path).iterdir())
    default = enable_compilation_cache()
    assert pathlib.Path(default) == ROOT / "build" / "stein_tpu_torch"
    assert _cuda.BUILD_ROOT == pathlib.Path(default)
