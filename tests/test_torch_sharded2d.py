"""The port's 2-D (particles x model) mesh (stein_tpu_torch/parallel/
sharded2d.py) against the JAX package's 2-D sampler on as many fake CPU
devices: tests/test_sharded2d.py case by case, on gloo meshes of 1x1 (in
this process), 1x2 and 2x1 (two processes) and 2x2 (four), each running
tests/torch_mesh_runner.py's 2-D scenarios (f64, the JAX tests' recipe).

Classes (port against JAX on the same layout): the exact median (and the
IMQ kernel) rtol 1e-9 / atol 1e-12; bisect and the warm searches rtol 1e-6
/ atol 1e-10 (the aux scalars rtol 1e-6: 100 off the origin D cancels to
~1e-8 relative); kernel_impl='pallas' (its tile computes in f32) rtol
1e-5 / atol 1e-8. Within the port: 'pallas'
against 'xla' rtol 1e-5 / atol 1e-8 with bitwise equal step-1 medians, and
'grid' against 'rounds' the JAX test's 3e-3 and 2e-2. Every rank of every
layout holds bitwise the same median, h2, phi_norm and log_p_mean."""

import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import stein_tpu as sj
import stein_tpu_torch as st
import torch_mesh_runner as R
from stein_tpu.kernels import InverseMultiquadricKernel as JIMQ
from stein_tpu.models import LinearRegressionModel as JLR
from stein_tpu_torch.models import LinearRegressionModel as TLR
from stein_tpu_torch.parallel import Mesh2D, ParticleMesh, mesh_2d
from stein_tpu_torch.parallel.sharded2d import make_sharded2d_step
from stein_tpu_torch.utils.ravel import template_unraveler

LAYOUTS = [(1, 1), (1, 2), (2, 1), (2, 2)]
NAMES = list(R.SCENARIOS_2D)
EXACT = dict(rtol=1e-9, atol=1e-12)
BISECT = dict(rtol=1e-6, atol=1e-10)
PALLAS = dict(rtol=1e-5, atol=1e-8)
# (samples, aux scalars' rtol) by scenario; the rest BISECT.
CLASS = {"exact": (EXACT, 1e-9), "imq": (EXACT, 1e-9),
         "pallas": (PALLAS, 1e-5), "warm_pallas": (PALLAS, 1e-5)}


@pytest.fixture(scope="module")
def mesh11():
    with R.one_process_mesh():
        yield mesh_2d(1, 1)


@functools.lru_cache(maxsize=None)
def port_runs_2d(world):
    """Every 2-D scenario of the port on the layouts of ``world`` gloo
    processes: {(dp, mp): {name: {field: array}}}."""
    names = [f"2d:{n}" for n in NAMES + [R.CHECKPOINT_2D, R.DIAGNOSTICS_2D]]
    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/out.npz"
        ok, outs = R.launch(world, names, out)
        assert ok, "\n".join(outs)
        with np.load(out) as f:
            data = {k: f[k] for k in f.files if k.startswith("2d:")}
    res = {}
    for key, v in data.items():
        head, field = key.split("/")
        name, lay = head[3:].split("@")
        dp, mp = map(int, lay.split("x"))
        res.setdefault((dp, mp), {}).setdefault(name, {})[field] = v
    return res


_LOCAL = {}


def port_2d(name, layout, mesh11):
    """A 2-D scenario of the port on ``layout`` (1x1 in this process)."""
    if layout != (1, 1):
        return port_runs_2d(layout[0] * layout[1])[layout][name]
    if name == "layout":
        return {k: v for k, v in R.check_layout_2d(mesh11).items()}
    if name not in _LOCAL:
        with tempfile.TemporaryDirectory() as tmp:
            _LOCAL[name] = R.scenario_2d(name, mesh11, tmp)
    return _LOCAL[name]


def _jax_mesh(dp, mp):
    return Mesh(np.asarray(jax.devices()[:dp * mp]).reshape(dp, mp),
                ("particles", "model"))


def _jax_sampler(layout, theta0, cfg):
    model = JLR(theta0.shape[1])
    kw = dict(cfg)
    if kw.get("kernel") == "imq":
        kw["kernel"] = JIMQ(c=1.0, beta=-0.5)
    return sj.SVGDSampler(
        n_particles=theta0.shape[0], log_p=model.log_p,
        param_template=model.template(jnp.float64),
        gd=sj.Adam(learning_rate=1e-1), theta=jnp.asarray(theta0),
        dtype=jnp.float64, mesh=_jax_mesh(*layout), model_axis="model",
        pallas_interpret=True, **kw)


def _batch():
    X, y, _ = R.linreg2d_data()
    return {"X": jnp.asarray(X), "y": jnp.asarray(y)}


@functools.lru_cache(maxsize=None)
def jax_2d(name, layout):
    """The JAX 2-D sampler's run of a scenario on ``layout`` fake
    devices."""
    _, _, theta0 = R.linreg2d_data()
    cfg, how, steps, offset = R.SCENARIOS_2D[name]
    s = _jax_sampler(layout, theta0 + offset, cfg)
    batch = _batch()
    if how == "run":
        aux = s.run(batch, steps)
    else:
        auxes = [s.train_on_batch(batch) for _ in range(steps)]
        aux = {k: jnp.stack([a[k] for a in auxes]) for k in auxes[0]}
    out = {k: np.asarray(v) for k, v in aux.items()}
    out["samples"] = np.asarray(s.samples)
    return out


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: "%dx%d" % l)
@pytest.mark.parametrize("name", NAMES)
def test_2d_matches_jax(name, layout, mesh11):
    """Each scenario against the JAX 2-D sampler on the same layout."""
    got, want = port_2d(name, layout, mesh11), jax_2d(name, layout)
    tol, rtol = CLASS.get(name, (BISECT, 1e-6))
    np.testing.assert_allclose(got["samples"], want["samples"], **tol)
    for key in ("median", "h2", "phi_norm", "log_p_mean"):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                   err_msg=key)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: "%dx%d" % l)
def test_2d_ranks_agree_bitwise(layout, mesh11):
    """Every rank holds bitwise the same median, h2, phi_norm and
    log_p_mean after every scenario (the D rows are psum'd, never
    recomputed after the reduce)."""
    for name in NAMES + [R.CHECKPOINT_2D, R.DIAGNOSTICS_2D]:
        assert bool(port_2d(name, layout, mesh11)["agree"]), name


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: "%dx%d" % l)
def test_2d_pallas_matches_xla(layout, mesh11):
    """tests/test_sharded2d.py:test_sharded2d_pallas_matches_xla: B10's
    plain version on the psum'd D rows tracks the XLA tile (3 steps of the
    same bisect search), with bitwise equal step-1 medians; and the warm
    path with either tile (test_sharded2d_warm_pallas_runs)."""
    a = port_2d("bisect", layout, mesh11)
    b = port_2d("pallas", layout, mesh11)
    assert b["median"][0] == a["median"][0]
    np.testing.assert_allclose(b["samples"], a["path"][len(b["path"]) - 1],
                               **PALLAS)
    np.testing.assert_allclose(port_2d("warm_pallas", layout, mesh11)
                               ["samples"],
                               port_2d("warm_xla", layout, mesh11)["samples"],
                               **PALLAS)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: "%dx%d" % l)
def test_2d_grid_matches_rounds(layout, mesh11):
    """median_collectives='grid' subdivides the rounds search's verified
    bracket: the step-1 medians agree to rtol 3e-3, the samples to the
    bandwidth-perturbation class (tests/test_sharded2d.py's)."""
    g = port_2d("grid", layout, mesh11)
    r = port_2d("rounds", layout, mesh11)
    np.testing.assert_allclose(g["median"][0], r["median"][0], rtol=3e-3)
    np.testing.assert_allclose(g["samples"], r["samples"], rtol=2e-2,
                               atol=2e-4)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: "%dx%d" % l)
def test_2d_grid_off_origin_bound_is_centered(layout, mesh11):
    """A cloud 100 away from the origin: the grid's fallback range comes
    from CENTRED column norms, so its medians stay in the rounds class."""
    g = port_2d("grid_off", layout, mesh11)
    r = port_2d("rounds_off", layout, mesh11)
    assert np.isfinite(g["median"]).all()
    np.testing.assert_allclose(g["median"], r["median"], rtol=5e-2)
    np.testing.assert_allclose(g["samples"], r["samples"], rtol=2e-2,
                               atol=2e-4)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: "%dx%d" % l)
def test_2d_save_restore(layout, mesh11):
    """save on the 2-D mesh (rank 0 writes the gathered state), restore
    into a fresh 2-D sampler (every rank its block): the same 3 steps,
    bitwise."""
    c = port_2d(R.CHECKPOINT_2D, layout, mesh11)
    assert int(c["step"]) == 3
    np.testing.assert_array_equal(c["restored"], c["samples"])


@functools.lru_cache(maxsize=None)
def _jax_diagnostics(layout):
    _, _, theta0 = R.linreg2d_data()
    s = _jax_sampler(layout, theta0, {})
    batch = _batch()
    s.train_on_batch(batch)
    model = JLR(theta0.shape[1])
    return {"samples": np.asarray(s.samples),
            "posterior": np.asarray(s.function_posterior(model.predict,
                                                         batch)),
            "ksd": float(s.ksd(batch)),
            "theta_w": np.asarray(s.theta["w"])}


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: "%dx%d" % l)
def test_2d_aux_posterior_and_ksd(layout, mesh11):
    """samples, theta, function_posterior (and its mean) and ksd on a 2-D
    sampler gather the blocks of both axes: against the JAX 2-D sampler
    after one step, at the exact class."""
    got, want = port_2d(R.DIAGNOSTICS_2D, layout, mesh11), \
        _jax_diagnostics(layout)
    assert got["samples"].shape == (16, 8)
    assert got["posterior"].shape == (16, 40)
    for key in ("samples", "posterior", "theta_w"):
        np.testing.assert_allclose(got[key], want[key], **EXACT)
    np.testing.assert_allclose(got["posterior_mean"],
                               want["posterior"].mean(0), **EXACT)
    np.testing.assert_allclose(float(got["ksd"]), want["ksd"], rtol=1e-9)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: "%dx%d" % l)
def test_mesh_2d_layout(layout, mesh11):
    """mesh_2d puts global rank r at (r // mp, r % mp), as JAX's row-major
    reshape does; the model-axis gather concatenates along dim 1, the
    two-axis gather assembles [n, p] blocks, and psum covers every
    rank."""
    dp, mp = layout
    got = (R.check_layout_2d(mesh11) if layout == (1, 1)
           else port_runs_2d(dp * mp)[layout]["layout"])
    pos = got["pos"].reshape(dp * mp, 3)
    want = [[r, r // mp, r % mp] for r in range(dp * mp)]
    np.testing.assert_array_equal(pos[np.argsort(pos[:, 0])], want)
    x = np.arange(2.0).reshape(2, 1)
    np.testing.assert_array_equal(got["gather_dim1"],
                                  np.concatenate([x + j for j in range(mp)],
                                                 axis=1))
    np.testing.assert_array_equal(
        got["gather_2d"],
        np.concatenate([np.concatenate([x + i * mp + j for j in range(mp)],
                                       axis=1) for i in range(dp)]))
    assert float(got["psum_2d"]) == sum(range(1, dp * mp + 1))
    assert int(got["rank"]) == 0


def _count_all_reduce(monkeypatch):
    calls = []
    real = dist.all_reduce
    monkeypatch.setattr(dist, "all_reduce",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    return calls


@pytest.mark.parametrize("mode,want", [("grid", 7), ("rounds", 11)])
def test_2d_warm_step_all_reduce_count(mode, want, mesh11, monkeypatch):
    """tests/test_sharded2d.py:test_2d_grid_matches_rounds's collective
    budget, counted as calls here: two model-axis psums for the D rows
    (the three norm partials in one), the two-axis clip (2) and the
    log_p pmean (1); the grid search adds its 2 psums, the rounds chain
    a pmax, the endpoint psum and one psum for each of its 4 rounds."""
    X, y, theta0 = R.linreg2d_data()
    s = R._sampler_2d(mesh11, theta0,
                      dict(R._W2, median_collectives=mode))
    batch = {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}
    carry = (s.state, s._warm_init_med(s.state.particles))
    calls = _count_all_reduce(monkeypatch)
    s._warm_step_fn(carry, batch)
    assert len(calls) == want


def _theta(n, p):
    return np.random.default_rng(0).normal(size=(n, p)) * 0.01


def test_2d_exact_median_gather_guard(mesh11):
    """median='exact' on a 2-D mesh refuses the n^2 all-gather beyond the
    per-device limit, pointing at 'bisect' (8192^2 f64 = 512 MB)."""
    model = TLR(8)
    with pytest.raises(ValueError, match="bisect"):
        st.SVGDSampler(8192, model.log_p, model.template(), st.Adam(),
                       theta=_theta(8192, 8), dtype=torch.float64,
                       device="cpu", mesh=mesh11, model_axis="model",
                       median="exact")


@pytest.mark.parametrize("median", ["binned", "subsample"])
def test_2d_unsupported_median_raises(median, mesh11):
    model = TLR(8)
    with pytest.raises(ValueError, match="2-D sharded median"):
        st.SVGDSampler(16, model.log_p, model.template(), st.Adam(),
                       theta=_theta(16, 8), dtype=torch.float64,
                       device="cpu", mesh=mesh11, model_axis="model",
                       median=median)


@pytest.mark.parametrize("n,p", [(16, 7), (18, 8)])
def test_2d_sharded_divisibility_errors(n, p):
    """n_params % mp and n_particles % dp on a 4x2 mesh
    (make_sharded2d_step checks them before any collective)."""
    from stein_tpu_torch.api import SVGDState

    mesh = Mesh2D(ParticleMesh(None, "particles", 4, 0, "cpu"),
                  ParticleMesh(None, "model", 2, 0, "cpu"))
    model = TLR(p)
    gd = st.Adam()
    theta = torch.zeros(n, p, dtype=torch.float64)
    state = SVGDState(theta, gd.init((n, p), torch.float64, "cpu"),
                      torch.zeros((), dtype=torch.int32))
    _, unravel = template_unraveler(model.template())
    with pytest.raises(ValueError, match="divisible"):
        make_sharded2d_step(model.log_p, unravel, gd, n, p, state, mesh)


def test_grid_warm_passes_unroll_guard(mesh11):
    """median_collectives='grid' counts 2**(warm_passes - log2(g1))
    thresholds a step; warm_passes=25 raises a readable error."""
    X, y, theta0 = R.linreg2d_data()
    s = R._sampler_2d(mesh11, theta0, dict(R._W2, warm_passes=25,
                                           median_collectives="grid"))
    with pytest.raises(ValueError, match="warm_passes"):
        s.run({"X": torch.from_numpy(X), "y": torch.from_numpy(y)}, 1)


@pytest.mark.parametrize("kw,err,match", [
    (dict(mesh="1d"), TypeError, "Mesh2D"),
    (dict(model_axis="other"), ValueError, "axes"),
    (dict(particle_axis="other"), ValueError, "particle axis"),
    (dict(custom_grads=lambda t, b: (t[:, 0], t)), ValueError,
     "1-D particle"),
    (dict(step_impl="fused_shard", median="bisect", warm_median=True),
     ValueError, "1-D particle"),
])
def test_2d_guards(kw, err, match, mesh11):
    """The JAX sampler's 2-D guards, and the port's: a model axis needs a
    Mesh2D that has it."""
    model = TLR(8)
    kw = dict(kw)
    if kw.get("mesh") == "1d":
        kw["mesh"] = mesh11.particles
    base = dict(theta=_theta(16, 8), device="cpu", mesh=mesh11,
                model_axis="model")
    base.update(kw)
    with pytest.raises(err, match=match):
        st.SVGDSampler(16, model.log_p, model.template(), st.Adam(), **base)
