"""The port's checkpoints (stein_tpu_torch/utils/checkpoint.py,
SVGDSampler.save/restore), crash recovery (utils/recovery.py), metrics,
host reads and profiling hooks, against the JAX package's: the same npz
format both ways across the packages, every rejection of
restore_checkpoint, and a 2-process gloo mesh save/restore
(tests/torch_mesh_runner.py's checkpoint scenario)."""

import collections
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stein_tpu as sj
import stein_tpu_torch as st
import torch_mesh_runner as R
from stein_tpu.models import LinearRegressionModel as JLR
from stein_tpu.models import LogisticRegressionModel as JL
from stein_tpu.utils import checkpoint as jc
from stein_tpu_torch.models import LinearRegressionModel as TLR
from stein_tpu_torch.models import LogisticRegressionModel as TL
from stein_tpu_torch.utils import checkpoint as tc
from stein_tpu_torch.utils import hostio, profiling
from stein_tpu_torch.utils.metrics import MetricsLogger
from stein_tpu_torch.utils.recovery import train_with_recovery

REF_TOL = dict(rtol=1e-5, atol=1e-6)
SIGNATURES = {
    "Adam": ".particles|.opt_state.mu|.opt_state.nu|.opt_state.count|"
            ".opt_state.learning_rate|.step",
    "Adagrad": ".particles|.opt_state.hist|.opt_state.count|"
               ".opt_state.learning_rate|.step",
}


def _data(seed=0, n_particles=16, dtype=np.float64):
    """tests/test_checkpoint.py's _setup data."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(30, 3))
    y = X @ rng.normal(size=(3, 1)) + rng.normal(size=(30, 1)) * 0.3
    theta0 = rng.normal(size=(n_particles, 3)) * 0.01
    return X.astype(dtype), y.astype(dtype), theta0.astype(dtype)


def _port(theta0, rule="Adam", mesh=None, **kw):
    tdt = torch.float64 if theta0.dtype == np.float64 else torch.float32
    gd = (st.Adam(learning_rate=1e-1, decay=0.99) if rule == "Adam"
          else st.Adagrad(learning_rate=5e-2))
    return st.SVGDSampler(theta0.shape[0], TLR(3).log_p, TLR(3).template(tdt),
                          gd, theta=theta0, dtype=tdt, device="cpu",
                          mesh=mesh, **kw)


def _jax(theta0, rule="Adam", **kw):
    jdt = jnp.float64 if theta0.dtype == np.float64 else jnp.float32
    gd = (sj.Adam(learning_rate=1e-1, decay=0.99) if rule == "Adam"
          else sj.Adagrad(learning_rate=5e-2))
    return sj.SVGDSampler(theta0.shape[0], JLR(3).log_p,
                          JLR(3).template(jdt), gd,
                          theta=jnp.asarray(theta0), dtype=jdt, **kw)


def _tb(X, y):
    return {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}


def test_save_restore_resumes_identically(tmp_path):
    """tests/test_checkpoint.py::test_save_restore_resumes_identically on
    the port: a fresh sampler restored at step 3 continues bitwise, with
    the decayed learning rate and the step count."""
    ckpt = str(tmp_path / "state.npz")
    X, y, theta0 = _data()
    tb = _tb(X, y)
    a = _port(theta0)
    for _ in range(3):
        a.train_on_batch(tb)
    a.save(ckpt)
    for _ in range(4):
        a.train_on_batch(tb)
    b = _port(theta0)
    b.restore(ckpt)
    assert int(b.state.step) == 3
    np.testing.assert_allclose(float(b.state.opt_state.learning_rate),
                               0.1 * 0.99 ** 3)
    for _ in range(4):
        b.train_on_batch(tb)
    np.testing.assert_array_equal(a.samples, b.samples)
    assert int(b.state.step) == 7
    assert sorted(os.listdir(tmp_path)) == ["state.npz"]


@pytest.mark.parametrize("step_impl", ["fused", "fused_gram", "fused_glm",
                                       "fused_model"])
def test_save_restore_fused_step_sampler(tmp_path, step_impl):
    """tests/test_checkpoint.py::test_save_restore_fused_step_sampler on
    the port (the fused tails' plain versions): chunked run() calls resume
    bitwise from the restored particles and Adam moments."""
    rng = np.random.default_rng(2)
    n, p = 48, 4
    X = rng.normal(size=(30, p))
    if step_impl == "fused_model":
        model = TL(p, n_train=100, n_batch=30)
        y = (X @ rng.normal(size=(p, 1)) > 0).astype(np.float64)
        n_params = p + 1
    else:
        model = TLR(p)
        y = X @ rng.normal(size=(p, 1))
        n_params = p
    batch = {"X": torch.tensor(X, dtype=torch.float32),
             "y": torch.tensor(y, dtype=torch.float32)}
    kw = {}
    if step_impl == "fused_glm":
        batch = model.sufficient_batch(batch)
        kw["quadratic_form"] = model.quadratic_form
    if step_impl == "fused_model":
        kw["inkernel_model"] = model.inkernel_model
    theta0 = (rng.normal(size=(n, n_params)) * 0.01).astype(np.float32)

    def make():
        return st.SVGDSampler(n, model.log_p, model.template(),
                              st.Adam(learning_rate=1e-1, decay=0.99),
                              theta=theta0, device="cpu", median="bisect",
                              warm_median=True, warm_passes=6,
                              step_impl=step_impl, **kw)
    ckpt = str(tmp_path / f"{step_impl}.npz")
    a = make()
    a.run(batch, 5)
    a.save(ckpt)
    a.run(batch, 5)
    b = make()
    b.restore(ckpt)
    assert int(b.state.step) == 5
    b.run(batch, 5)
    np.testing.assert_array_equal(a.samples, b.samples)
    assert torch.equal(a.state.opt_state.mu, b.state.opt_state.mu)


@pytest.mark.parametrize("rule", ["Adam", "Adagrad"])
def test_file_layout_is_the_jax_packages(tmp_path, rule):
    """The port's file has the JAX package's layout: leaf_0..leaf_k in the
    same order, dtypes and shapes, and __meta__ = ["2", signature] with
    the JAX signature string."""
    X, y, theta0 = _data(dtype=np.float32)
    t, j = _port(theta0, rule), _jax(theta0, rule)
    t.train_on_batch(_tb(X, y))
    j.train_on_batch({"X": jnp.asarray(X), "y": jnp.asarray(y)})
    t.save(tmp_path / "t.npz")
    j.save(str(tmp_path / "j.npz"))
    assert tc._state_signature(t.state) == SIGNATURES[rule] == \
        jc._state_signature(j.state)
    with np.load(tmp_path / "t.npz") as ft, np.load(tmp_path / "j.npz") as fj:
        assert sorted(ft.files) == sorted(fj.files)
        assert list(ft["__meta__"]) == list(fj["__meta__"]) == [
            "2", SIGNATURES[rule]]
        for name in fj.files:
            assert ft[name].dtype == fj[name].dtype, name
            assert ft[name].shape == fj[name].shape, name


@pytest.mark.parametrize("rule", ["Adam", "Adagrad"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_packages(tmp_path, rule, direction):
    """A checkpoint written by either package restores into the other: the
    restored leaves are bitwise the writer's, then 10 more steps of both
    samplers agree at the reference-semantics class."""
    X, y, theta0 = _data(seed=4, dtype=np.float32)
    tb, jb = _tb(X, y), {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    ckpt = str(tmp_path / "cross.npz")
    t, j = _port(theta0, rule), _jax(theta0, rule)
    if direction == "jax_to_port":
        j.run(jb, 4)
        j.save(ckpt)
        t.restore(ckpt)
    else:
        t.run(tb, 4)
        t.save(ckpt)
        j.restore(ckpt)
    t_leaves = [leaf.numpy() for _, leaf in tc._flatten_with_path(t.state)]
    j_leaves = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(
        j.state)]
    assert len(t_leaves) == len(j_leaves) == len(SIGNATURES[rule].split("|"))
    for a, b in zip(t_leaves, j_leaves):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert int(t.state.step) == int(j.state.step) == 4
    t.run(tb, 10)
    j.run(jb, 10)
    np.testing.assert_allclose(t.samples, np.asarray(j.samples), **REF_TOL)


def test_logistic_checkpoint_crosses_packages(tmp_path):
    """The fused_model sampler's state (the logistic model's p = d + 1
    columns, log_alpha first) crosses from the JAX package (interpret mode)
    to the port bitwise, and both continue at the fused_model class."""
    rng = np.random.default_rng(1)
    d, n = 6, 48
    X = rng.normal(size=(20, d)).astype(np.float32)
    y = (X @ rng.normal(size=(d, 1)) > 0).astype(np.float32)
    theta0 = (rng.normal(size=(n, d + 1)) * 0.1).astype(np.float32)
    jm, tm = JL(d, 200, 20), TL(d, 200, 20)
    common = dict(median="bisect", warm_median=True, warm_passes=6,
                  step_impl="fused_model")
    j = sj.SVGDSampler(n, jm.log_p, jm.template(), sj.Adam(1e-1),
                       theta=jnp.asarray(theta0), pallas_interpret=True,
                       inkernel_model=jm.inkernel_model, **common)
    t = st.SVGDSampler(n, tm.log_p, tm.template(), st.Adam(1e-1),
                       theta=theta0, device="cpu",
                       inkernel_model=tm.inkernel_model, **common)
    jb = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    tb = _tb(X, y)
    j.run(jb, 4)
    j.save(str(tmp_path / "lr.npz"))
    t.restore(tmp_path / "lr.npz")
    np.testing.assert_array_equal(t.samples, np.asarray(j.samples))
    j.run(jb, 4)
    t.run(tb, 4)
    np.testing.assert_allclose(t.samples, np.asarray(j.samples), rtol=2e-4,
                               atol=1e-6)


def _rejections(tmp_path):
    """name -> (make the file, the template, the match)."""
    X, y, theta0 = _data()
    a = _port(theta0)
    a.train_on_batch(_tb(X, y))
    leaves = [leaf.numpy() for _, leaf in tc._flatten_with_path(a.state)]
    sig = tc._state_signature(a.state)
    path = str(tmp_path / "bad.npz")

    def write(meta=("2", sig), drop=False):
        arrays = {f"leaf_{i}": v for i, v in enumerate(leaves)}
        if drop:
            arrays.pop(f"leaf_{len(leaves) - 1}")
        if meta is not None:
            arrays["__meta__"] = np.array(list(meta))
        np.savez(path, **arrays)
    A = collections.namedtuple("A", ["mu", "nu", "step"])
    B = collections.namedtuple("B", ["nu", "mu", "step"])
    pair = A(torch.ones(4, 2), torch.full((4, 2), 2.0),
             torch.zeros((), dtype=torch.int32))
    swapped = B(torch.zeros(4, 2), torch.zeros(4, 2),
                torch.zeros((), dtype=torch.int32))
    return {
        "no_meta": (lambda: write(meta=None), a.state, "__meta__"),
        "version": (lambda: write(meta=("1", sig)), a.state, "version"),
        "leaf_swap": (lambda: tc.save_checkpoint(path, pair), swapped,
                      "structure"),
        "leaf_count": (lambda: write(drop=True), a.state, "leaves"),
        "shape": (lambda: a.save(path), _port(_data(n_particles=8)[2]).state,
                  "shape"),
    }, path


@pytest.mark.parametrize("name", ["no_meta", "version", "leaf_swap",
                                  "leaf_count", "shape"])
def test_restore_rejects_like_jax(tmp_path, name):
    """Every ValueError of restore_checkpoint (tests/test_checkpoint.py:
    no __meta__, another version, a reordered structure, another leaf
    count, another shape), from the port's and from the JAX package's
    restore on the same file."""
    cases, path = _rejections(tmp_path)
    make, like, match = cases[name]
    make()
    with pytest.raises(ValueError, match=match):
        tc.restore_checkpoint(path, like)
    jlike = jax.tree_util.tree_map(lambda l: jnp.asarray(l.numpy()), like)
    if name == "leaf_swap":
        jlike = type(like)(*[jnp.asarray(l.numpy()) for l in like])
    with pytest.raises(ValueError, match=match):
        jc.restore_checkpoint(path, jlike)


def test_leaf_swap_restores_the_same_structure(tmp_path):
    """The same named-tuple structure restores (its leaves cast to the
    template's dtype and device)."""
    A = collections.namedtuple("A", ["mu", "nu", "step"])
    state = A(torch.ones(4, 2), torch.full((4, 2), 2.0),
              torch.zeros((), dtype=torch.int32))
    path = str(tmp_path / "sig.npz")
    tc.save_checkpoint(path, state)
    restored = tc.restore_checkpoint(path, state)
    assert torch.equal(restored.nu, state.nu) and type(restored) is A
    assert restored.step.dtype == torch.int32


@pytest.fixture(scope="module")
def mesh1():
    with R.one_process_mesh() as mesh:
        yield mesh


def test_mesh_checkpoint_one_process(mesh1, tmp_path):
    """The checkpoint scenario on a one-process gloo mesh: the restored
    sampler continues bitwise; the file restores into a single-device
    sampler (port and JAX) with the mesh sampler's state."""
    out = R.port_scenario(R.CHECKPOINT, mesh1, str(tmp_path))
    np.testing.assert_array_equal(out["restored"], out["samples"])
    assert int(out["step"]) == 3 and bool(out["agree"])
    _check_mesh_file(str(tmp_path / "mesh_ckpt.npz"))


def _check_mesh_file(path):
    """The mesh's file restores into a port and a JAX single-device
    sampler alike, bitwise."""
    _, _, theta0 = R.linreg_data()
    t = _port(theta0)
    t.restore(path)
    j = _jax(theta0)
    j.restore(path)
    np.testing.assert_array_equal(t.samples, np.asarray(j.samples))
    assert int(t.state.step) == int(j.state.step) == 3
    np.testing.assert_array_equal(t.state.opt_state.nu.numpy(),
                                  np.asarray(j.state.opt_state.nu))


def test_mesh_checkpoint_two_processes():
    """The checkpoint scenario in 2 gloo processes: rank 0 writes the
    gathered state, each rank restores its block and continues bitwise as
    the saving sampler did; the file then restores into single-device
    samplers of both packages."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.npz")
        ok, outs = R.launch(2, [R.CHECKPOINT], out)
        assert ok, "\n".join(outs)
        with np.load(out) as f:
            np.testing.assert_array_equal(f["checkpoint/restored"],
                                          f["checkpoint/samples"])
            assert int(f["checkpoint/step"]) == 3
            assert bool(f["checkpoint/agree"])
        _check_mesh_file(os.path.join(tmp, "mesh_ckpt.npz"))


# ------------------------------------------------------------ recovery

def _make_batches(X, y, stride=7):
    def make_batches(start, k):
        idx = (np.arange(k)[:, None] * stride + start
               + np.arange(10)) % X.shape[0]
        return {"X": torch.from_numpy(X[idx]), "y": torch.from_numpy(y[idx])}
    return make_batches


def test_train_with_recovery_resumes_after_crash(tmp_path):
    """tests/test_checkpoint.py:151 on the port: the loop killed after its
    second checkpoint resumes in a fresh sampler and ends bitwise on the
    uninterrupted trajectory."""
    ckpt = str(tmp_path / "recov.npz")
    X, y, theta0 = _data(seed=9)
    make_batches = _make_batches(X, y)
    ref = _port(theta0)
    for s in range(0, 12, 3):
        ref.train_on_batches(make_batches(s, 3))
    calls = {"n": 0}

    def crash_hook(step, aux):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated crash")
    a = _port(theta0)
    with pytest.raises(RuntimeError, match="simulated"):
        train_with_recovery(a, 12, make_batches, ckpt, ckpt_every=3,
                            on_checkpoint=crash_hook)
    assert int(a.state.step) == 6
    b = _port(theta0)
    assert train_with_recovery(b, 12, make_batches, ckpt, ckpt_every=3) == 6
    assert int(b.state.step) == 12
    np.testing.assert_array_equal(b.samples, ref.samples)


def _poisoned(X, y, from_step):
    def make_batches(start, k):
        if start >= from_step:
            return {"X": torch.full((k, 5, 3), float("nan"),
                                    dtype=torch.float64),
                    "y": torch.zeros((k, 5, 1), dtype=torch.float64)}
        return _make_batches(X, y, 1)(start, k)
    return make_batches


def test_recovery_divergence_detection(tmp_path):
    """tests/test_checkpoint.py:193 on the port: a NaN state does not
    overwrite the last good checkpoint, which holds step 3."""
    ckpt = str(tmp_path / "div.npz")
    X, y, theta0 = _data(seed=11)
    a = _port(theta0)
    with pytest.raises(FloatingPointError, match="last good checkpoint"):
        train_with_recovery(a, 9, _poisoned(X, y, 3), ckpt, ckpt_every=3)
    b = _port(theta0)
    b.restore(ckpt)
    assert int(b.state.step) == 3 and np.isfinite(b.samples).all()


def test_recovery_first_chunk_divergence_names_no_checkpoint(tmp_path):
    """tests/test_checkpoint.py:218 on the port: divergence in the first
    chunk of a fresh run names no checkpoint and writes none."""
    ckpt = str(tmp_path / "fresh.npz")
    X, y, theta0 = _data(seed=12)
    with pytest.raises(FloatingPointError,
                       match="no checkpoint was written yet"):
        train_with_recovery(_port(theta0), 9, _poisoned(X, y, 0), ckpt,
                            ckpt_every=3)
    assert not os.path.exists(ckpt)


def test_recovery_on_the_mesh(mesh1, tmp_path):
    """train_with_recovery on a one-process gloo mesh sampler resumes from
    its checkpoint and ends bitwise on the single-device run."""
    ckpt = str(tmp_path / "mesh.npz")
    X, y, theta0 = _data(seed=9)
    make_batches = _make_batches(X, y)
    single = _port(theta0)
    train_with_recovery(single, 6, make_batches, str(tmp_path / "s.npz"),
                        ckpt_every=3)
    a = _port(theta0, mesh=mesh1)
    train_with_recovery(a, 3, make_batches, ckpt, ckpt_every=3)
    b = _port(theta0, mesh=mesh1)
    assert train_with_recovery(b, 6, make_batches, ckpt, ckpt_every=3) == 3
    np.testing.assert_array_equal(b.samples, single.samples)


# ------------------------------------------------------------ utilities

def test_metrics_logger(tmp_path):
    """tests/test_checkpoint.py:129 on the port: three rows, the interval
    and per-step average columns, a header and three CSV lines."""
    X, y, theta0 = _data()
    a = _port(theta0)
    csv_path = str(tmp_path / "metrics.csv")
    m = MetricsLogger(log_every=1, csv_path=csv_path)
    for step in range(3):
        m.record(step, a.train_on_batch(_tb(X, y)))
    m.close()
    assert len(m.history) == 3
    assert m.history[1]["interval_s"] is not None
    assert m.history[1]["avg_step_time_s"] == pytest.approx(
        m.history[1]["interval_s"])
    assert m.history[0]["avg_step_time_s"] is None
    with open(csv_path) as f:
        lines = f.read().strip().splitlines()
    assert len(lines) == 4
    assert lines[0] == "step,interval_s,avg_step_time_s,phi_norm,h2,log_p_mean"


def test_metrics_resume_appends(tmp_path):
    """tests/test_checkpoint.py:106 on the port: resume=True appends across
    a restart; a file with other columns is refused."""
    X, y, theta0 = _data()
    a = _port(theta0)
    csv_path = str(tmp_path / "metrics.csv")
    m1 = MetricsLogger(log_every=0, csv_path=csv_path, resume=True)
    for step in range(3):
        m1.record(step, a.train_on_batch(_tb(X, y)))
    m1.close()
    m2 = MetricsLogger(log_every=0, csv_path=csv_path, resume=True)
    for step in range(3, 5):
        m2.record(step, a.train_on_batch(_tb(X, y)))
    m2.close()
    with open(csv_path) as f:
        lines = f.read().strip().splitlines()
    assert len(lines) == 6
    assert [ln.split(",")[0] for ln in lines[1:]] == ["0", "1", "2", "3", "4"]
    other = str(tmp_path / "other.csv")
    with open(other, "w") as f:
        f.write("a,b\n1,2\n")
    m3 = MetricsLogger(log_every=0, csv_path=other, resume=True)
    with pytest.raises(ValueError, match="cannot resume"):
        m3.record(0, a.train_on_batch(_tb(X, y)))


def test_hostio_and_profiling(tmp_path, mesh1):
    """host_array (gathered on a mesh) and host_scalar; profiling.trace
    writes a Chrome trace holding the annotate() span."""
    x = torch.arange(6.0).reshape(3, 2)
    np.testing.assert_array_equal(hostio.host_array(x), x.numpy())
    np.testing.assert_array_equal(hostio.host_array(x, mesh1), x.numpy())
    assert hostio.host_scalar(torch.tensor(2.5)) == 2.5
    X, y, theta0 = _data()
    a = _port(theta0)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("svgd_step"):
            a.train_on_batch(_tb(X, y))
    path = tmp_path / "trace" / "trace.json"
    assert path.exists() and "svgd_step" in path.read_text()
    assert any(e.key == "svgd_step" for e in prof.key_averages())
