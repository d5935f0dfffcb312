"""The port's 1-D particle mesh (stein_tpu_torch/parallel) against the JAX
package's mesh sampler: the same numpy data and theta0, the port on a
one-process gloo group, JAX on a 1-device mesh with its Pallas kernels in
interpret mode; the mesh guards, throughput_config(mesh=) and
state_from_numpy(mesh=). tests/test_torch_mesh_ranks.py runs the same
scenarios in 4 processes; the 2-process runs are here (the two files run
on two test workers)."""

import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stein_tpu as sj
import stein_tpu_torch as st
import torch_mesh_runner as R
from stein_tpu.models import BayesianNNModel as JNN
from stein_tpu.models import LinearRegressionModel as JLR
from stein_tpu.parallel import particle_mesh as jax_mesh
from stein_tpu_torch.models import BayesianNNModel as TNN
from stein_tpu_torch.models import LinearRegressionModel as TLR
from stein_tpu_torch.parallel.mesh import ParticleMesh
from stein_tpu_torch.utils.convert import state_from_numpy

# Port against JAX, the same configuration on the same mesh size. The
# fused_shard paths are held to tests/test_sharded.py:625-634's class of the
# fused mesh step against the all-f32 XLA step (samples rtol 5e-5 / atol
# 1e-7) with medians at its fused-comparator bound (rtol 1e-6); the
# plain mesh steps to the port's reference-path tolerance
# (tests/test_torch_sampler.py, REF_TOL) and the warm ones to its warm
# bisect class (medians 5e-3, samples 2e-4 / 1e-6).
TOL = {"fs": (dict(rtol=5e-5, atol=1e-7), 1e-6),
       "cold": (dict(rtol=1e-5, atol=1e-6), 1e-5),
       "warm": (dict(rtol=2e-4, atol=1e-6), 5e-3),
       # median='binned': tests/test_sharded.py:64's mesh class for the
       # samples; the medians rtol 1e-4 (the f32 samples drift by the
       # tile's rounding, and a median moves a whole final bin, range /
       # n_bins^2, when an entry crosses a bin edge).
       "binned": (dict(rtol=1e-3, atol=1e-8), 1e-4)}
ALL = list(R.SCENARIOS)


@pytest.fixture(scope="module")
def mesh1():
    with R.one_process_mesh() as mesh:
        yield mesh


def _jax_problem(kind):
    if kind == "nn":
        X, y, theta0 = R.nn_data()
        model = JNN(1, 8, 20, 20)
    else:
        X, y, theta0 = R.linreg_data()
        model = JLR(3)
    batch = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    if kind == "glm":
        batch = model.sufficient_batch(batch)
    return model, batch, jnp.asarray(theta0)


@functools.lru_cache(maxsize=None)
def jax_scenario(name, world):
    """The JAX mesh sampler's run of a scenario on ``world`` devices."""
    kind, rule, steps, how, cfg, hook = R.SCENARIOS[name]
    model, batch, theta0 = _jax_problem(kind)
    kw = dict(cfg)
    if hook == "quadratic_form":
        kw["quadratic_form"] = model.quadratic_form
    elif hook == "custom_grads":
        kw["custom_grads"] = model.pallas_grads(interpret=True)
    s = sj.SVGDSampler(theta0.shape[0], model.log_p, model.template(),
                       getattr(sj, rule)(learning_rate=R.LR[kind]),
                       theta=theta0, mesh=jax_mesh(jax.devices()[:world]),
                       pallas_interpret=True, **kw)
    if how == "run":
        aux = s.run(batch, steps)
    else:
        auxes = [s.train_on_batch(batch) for _ in range(steps)]
        aux = {k: jnp.stack([a[k] for a in auxes]) for k in auxes[0]}
    out = {k: np.asarray(v) for k, v in aux.items()}
    out["samples"] = np.asarray(s.samples)
    return out


def _check_against_jax(name, got, want):
    tol, med_rtol = TOL[name.split("_")[0]]
    np.testing.assert_allclose(got["samples"], want["samples"], **tol)
    np.testing.assert_allclose(got["median"], want["median"], rtol=med_rtol)
    np.testing.assert_allclose(got["phi_norm"], want["phi_norm"], rtol=1e-4)
    np.testing.assert_allclose(got["log_p_mean"], want["log_p_mean"],
                               rtol=1e-5)


# The subprocess runs: every scenario at 4 processes, the main ones at 2.
AT_2 = ["fs_rounds", "fs_grid", "fs_ring", "fs_glm", "fs_nn", "warm_xla",
        "cold_bisect", "cold_exact", "binned_gather", "binned_ring",
        "binned_pallas"]


@functools.lru_cache(maxsize=None)
def port_runs(world):
    """Every scenario of the port in ``world`` gloo processes."""
    names = ALL + list(R.EPILOGUES) if world == 4 else AT_2
    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/out.npz"
        ok, outs = R.launch(world, names, out)
        assert ok, "\n".join(outs)
        with np.load(out) as f:
            data = {k: f[k] for k in f.files}
    res = {}
    for key, v in data.items():
        name, field = key.split("/")
        res.setdefault(name, {})[field] = v
    return res


def check_multi_process(world, name):
    """A scenario in `world` gloo processes against JAX's `world`-device
    mesh; the ranks agree bitwise on every aux scalar."""
    got = port_runs(world)[name]
    assert bool(got["agree"]), "ranks disagree on an aux scalar"
    _check_against_jax(name, got, jax_scenario(name, world))


def check_collectives(world):
    """all_gather, ppermute_ring, psum, pmax, pmin, pmean, axis_index and
    axis_size on rank-dependent values, on rank 0 of `world` processes."""
    c = port_runs(world)["coll"]
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    np.testing.assert_array_equal(
        c["gather"], np.concatenate([x + 10 * r for r in range(world)]))
    np.testing.assert_array_equal(c["gather_untiled"],
                                  [1.5 * r - 1.0 for r in range(world)])
    np.testing.assert_array_equal(c["ring"], x + 10 * (world - 1))
    np.testing.assert_array_equal(
        c["psum_i32"], [sum(r + 1 for r in range(world)),
                        sum(2 * r for r in range(world))])
    assert c["psum_i32"].dtype == np.int32
    np.testing.assert_allclose(c["psum_f32"],
                               sum(1.5 * r - 1.0 for r in range(world)))
    np.testing.assert_array_equal(c["pmax"], [world, 2 * (world - 1)])
    assert float(c["pmin"]) == -1.0
    np.testing.assert_allclose(
        c["pmean"], sum(1.5 * r - 1.0 for r in range(world)) / world)
    np.testing.assert_array_equal(c["index_size"], [0, world])
    assert bool(c["input_kept"])


@pytest.mark.parametrize("name", ALL)
def test_one_process_mesh_matches_jax(name, mesh1):
    """Each scenario on a one-process gloo group against JAX's 1-device
    mesh."""
    _check_against_jax(name, R.port_scenario(name, mesh1),
                       jax_scenario(name, 1))


@pytest.mark.parametrize("name", AT_2)
def test_two_process_mesh_matches_jax(name):
    check_multi_process(2, name)


def test_collectives_two_processes():
    check_collectives(2)


@pytest.mark.parametrize("world", [1, 4])
@pytest.mark.parametrize("model", [None, "lr", "nn"])
@pytest.mark.parametrize("n,p", [(16, 3), (1000, 128), (1000, 303),
                                 (8192, 64), (20000, 512)])
def test_throughput_config_mesh_matches_jax(world, model, n, p):
    """throughput_config(n, p, mesh=) equal to JAX's dict, the mesh and the
    hooks (callables) aside."""
    jm = {"lr": JLR(p), "nn": JNN(1, 100, 20, 20), None: None}[model]
    tm = {"lr": TLR(p), "nn": TNN(1, 100, 20, 20), None: None}[model]
    want = sj.throughput_config(n, p, mesh=jax_mesh(jax.devices()[:world]),
                                model=jm)
    got = st.throughput_config(n, p, mesh=ParticleMesh(None, "particles",
                                                       world, 0, "cpu"),
                               model=tm)
    assert isinstance(got.pop("mesh"), ParticleMesh)
    want.pop("mesh")
    assert got.pop("dtype") is torch.float32
    assert want.pop("dtype") == jnp.float32
    assert ({k: callable(v) or v for k, v in got.items()}
            == {k: callable(v) or v for k, v in want.items()})


@pytest.mark.parametrize("world", [2, 4])
def test_state_from_numpy_matches_jax_shard_state(world):
    """state_from_numpy(..., mesh=) on every rank of `world` against the
    shards of JAX's shard_state of the same full state."""
    from stein_tpu.parallel.sharded import shard_state

    rng = np.random.default_rng(7)
    n, p = 16, 3
    full = sj.api.SVGDState(
        jnp.asarray(rng.normal(size=(n, p)), jnp.float32),
        sj.Adam(learning_rate=0.1).init((n, p), jnp.float32)._replace(
            mu=jnp.asarray(rng.normal(size=(n, p)), jnp.float32),
            count=jnp.asarray(3, jnp.int32)),
        jnp.asarray(3, jnp.int32))
    sharded = shard_state(full, jax_mesh(jax.devices()[:world]), "particles")
    for rank in range(world):
        got = state_from_numpy(
            np.asarray(full.particles),
            {k: np.asarray(v) for k, v in full.opt_state._asdict().items()},
            np.asarray(full.step), device="cpu",
            mesh=ParticleMesh(None, "particles", world, rank, "cpu"))
        want_p = np.asarray(sharded.particles.addressable_shards[rank].data)
        np.testing.assert_array_equal(got.particles.numpy(), want_p)
        np.testing.assert_array_equal(
            got.opt_state.mu.numpy(),
            np.asarray(sharded.opt_state.mu.addressable_shards[rank].data))
        assert int(got.opt_state.count) == 3 and int(got.step) == 3
        assert float(got.opt_state.learning_rate) == pytest.approx(0.1)


def _mesh_sampler(mesh, **kw):
    X, y, theta0 = R.linreg_data()
    model = TLR(3)
    base = dict(theta=theta0, device="cpu", mesh=mesh, median="bisect",
                warm_median=True, step_impl="fused_shard")
    base.update(kw)
    return st.SVGDSampler(16, model.log_p, model.template(), st.Adam(0.1),
                          **base)


@pytest.mark.parametrize("kw,match", [
    # tests/test_sharded.py:test_fused_shard_guards
    (dict(dtype=torch.float64), "f32-only"),
    (dict(warm_median=False), "warm-median"),
    (dict(kernel_impl="pallas"), "kernel_impl='xla'"),
    (dict(model_axis="model"), "1-D particle"),
    # test_ring_fused_shard_guards, test_fused_shard_grid_matches_rounds
    (dict(comm="ring", median_collectives="rounds"), "grid"),
    (dict(median_collectives="bogus"), "median_collectives"),
    # test_fused_shard_glm_matches_autodiff_grads,
    # test_mesh_custom_grads_matches_single
    (dict(step_impl="xla", quadratic_form=TLR(3).quadratic_form),
     "fused_shard"),
    (dict(custom_grads=lambda t, b: (t[:, 0], t),
          quadratic_form=TLR(3).quadratic_form), "both replace"),
    (dict(step_impl="xla", model_axis="model",
          custom_grads=lambda t, b: (t[:, 0], t)), "1-D particle"),
    # the other mesh guards of stein_tpu/api.py:1503-1588
    (dict(median_impl="fused"), "single-device only"),
    (dict(step_impl="fused_gram"), "single-device only"),
    (dict(step_impl="xla", warm_median=True, median="exact"),
     "warm_median=True requires"),
    (dict(step_impl="xla", inkernel_model=object()), "inkernel_model"),
    (dict(step_impl="xla", warm_median=False, comm="ring", median="exact"),
     "comm='ring' supports"),
    (dict(step_impl="xla", warm_median=False, kernel_impl="pallas",
          median="exact"), "gather-free"),
    (dict(comm="bogus", median_collectives="grid"), "unknown comm"),
    # the port's own: the mesh's device kind and axis name
    (dict(device="meta"), "mesh of cpu tensors"),
    (dict(particle_axis="other"), "axis"),
])
def test_mesh_guards(kw, match, mesh1):
    with pytest.raises(ValueError, match=match):
        _mesh_sampler(mesh1, **kw)


def test_single_device_fused_shard_raises():
    """tests/test_sharded.py:720: fused_shard without a mesh."""
    with pytest.raises(ValueError, match="unknown step_impl|single-device"):
        _mesh_sampler(None)


def test_mesh_state_handoff_from_jax(mesh1):
    """A JAX mesh sampler runs 3 steps of fused_shard; its state crosses
    over through state_from_numpy(mesh=) and load_state; both run 3 more,
    at the fused_shard tolerance."""
    X, y, theta0 = R.linreg_data()
    jm = JLR(3)
    cfg = dict(median="bisect", warm_median=True, step_impl="fused_shard",
               median_collectives="rounds")
    js = sj.SVGDSampler(16, jm.log_p, jm.template(),
                        sj.Adam(learning_rate=0.1), theta=jnp.asarray(theta0),
                        pallas_interpret=True,
                        mesh=jax_mesh(jax.devices()[:1]), **cfg)
    ts = _mesh_sampler(mesh1, median_collectives="rounds")
    jb = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    js.run(jb, 3)
    s = js.state
    ts.load_state(state_from_numpy(
        np.asarray(s.particles),
        {k: np.asarray(v) for k, v in s.opt_state._asdict().items()},
        np.asarray(s.step), device="cpu", mesh=mesh1))
    assert int(ts.state.step) == 3
    js.run(jb, 3)
    ts.run({"X": torch.from_numpy(X), "y": torch.from_numpy(y)}, 3)
    np.testing.assert_allclose(ts.samples, np.asarray(js.samples),
                               **TOL["fs"][0])


def test_replicate_batch_puts_every_leaf_on_the_mesh_device(mesh1):
    from stein_tpu_torch.parallel.sharded import replicate_batch

    batch = {"X": torch.ones(2, 3), "rest": [torch.zeros(1), 5]}
    out = replicate_batch(batch, mesh1)
    assert out["X"].device == mesh1.device == torch.device("cpu")
    assert torch.equal(out["rest"][0], torch.zeros(1))
    assert out["rest"][1] == 5
