"""The sampler's step graphs (stein_tpu_torch/utils/graphs.py) on the CPU.

The bookkeeping of ``StepGraphs`` (static buffers, chunks, the remainder
graph, the feeds of each entry point, the launch counters, the keys that
call for a new capture) sits behind one injected capture function. Here a
recorder (``cuda_graph_ranks.recorder``) stands in for
``torch.cuda.CUDAGraph``: it runs the warm-up and the body once, as a
capture runs the body's Python once, and replays by calling the body again
on the static buffers, leaving the launch counters as a graph's replay
leaves them. Every entry point through the graphs must equal the eager
loop bitwise; one case is held to the JAX sampler at the reference path's
tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stein_tpu as sj
import stein_tpu_torch as st
from stein_tpu.models import LinearRegressionModel as JLR
from stein_tpu_torch.api import minibatch_indices
from stein_tpu_torch.models import BayesianNNModel as TNN
from stein_tpu_torch.models import LinearRegressionModel as TLR
from stein_tpu_torch.models import LogisticRegressionModel as TL
from stein_tpu_torch.utils import graphs
from cuda_graph_ranks import recorder
from torch_mesh_runner import one_process_mesh

C = graphs.CHUNK
# The reference path's tolerance (tests/test_torch_sampler.py, REF_TOL).
REF_TOL = dict(rtol=1e-5, atol=1e-6)
N, D, N_OBS = 24, 4, 40


class Launches:
    """A launch counter in the registry, ticked once per log_p call."""
    launches = 0


@pytest.fixture
def counted(monkeypatch):
    registry = graphs.launch_counters
    monkeypatch.setattr(graphs, "launch_counters", lambda: {
        **registry(), "log_p": (Launches, "launches")})
    Launches.launches = 0
    return Launches


def _data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N_OBS, D)).astype(np.float32)
    y = (X @ rng.normal(size=(D, 1)) + 0.3 * rng.normal(size=(N_OBS, 1))
         ).astype(np.float32)
    theta0 = (rng.normal(size=(N, D)) * 0.1).astype(np.float32)
    return X, y, theta0


def _counting(log_p):
    def counted_log_p(params, batch):
        Launches.launches += 1
        return log_p(params, batch)
    return counted_log_p


WARM = dict(median="bisect", warm_median=True, warm_passes=6)
FUSED = dict(WARM, median_impl="fused", median_max_rows=16)
TILE = dict(WARM, kernel_impl="pallas", median_impl="fused_gram",
            median_max_rows=16)
# 24 particles in row blocks of 10: two blocks and a remainder of 4.
BINNED = dict(median="binned", kernel_impl="pallas", binned_block_rows=10)


def _sampler(cfg, theta0=None, graph=True):
    """(sampler, batch) of configuration ``cfg`` on the CPU, its steps
    through the graphs (``graph``) or the eager loop."""
    X, y, t0 = _data()
    theta0 = t0 if theta0 is None else theta0
    batch = {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}
    kw, model, p = {}, TLR(D), D
    if cfg == "cold":
        pass
    elif cfg == "remat":
        kw = dict(remat=True)
    elif cfg == "warm":
        kw = WARM
    elif cfg == "fused_gram":
        kw = dict(FUSED, step_impl="fused_gram")
    elif cfg == "fused":
        kw = dict(FUSED, step_impl="fused")
    elif cfg == "fused_glm":
        kw = dict(FUSED, step_impl="fused_glm",
                  quadratic_form=model.quadratic_form)
    elif cfg == "fused_model":
        model, p = TL(D, 1000, N_OBS), D + 1
        batch["y"] = (batch["y"] > 0).to(torch.float32)
        kw = dict(FUSED, step_impl="fused_model",
                  inkernel_model=model.inkernel_model)
    elif cfg == "tile":
        kw = TILE
    elif cfg == "epilogue":
        kw = dict(TILE, median_impl="fused", step_impl="epilogue")
    elif cfg == "custom_grads":
        model = TNN(D, 3, N_OBS, N_OBS, prior_beta=10.0)
        kw = dict(TILE, custom_grads=model.pallas_grads())
        p = None
    elif cfg == "subsample":
        kw = dict(median="subsample", median_max_rows=16)
    elif cfg == "binned":
        kw = BINNED
    else:
        raise ValueError(cfg)
    if p is None:
        theta0 = None
    elif theta0.shape[1] != p:
        theta0 = np.concatenate([theta0, theta0[:, :p - theta0.shape[1]]],
                                axis=1)
    s = st.SVGDSampler(N, _counting(model.log_p), model.template(),
                       st.Adam(1e-1), theta=theta0,
                       generator=torch.Generator().manual_seed(3),
                       device="cpu", **kw)
    if graph:
        s._graphs = graphs.StepGraphs(capture=recorder)
    return s, batch


def _stacked(batch, k, m=8, seed=0):
    idx = np.random.default_rng(seed).integers(0, N_OBS, size=(k, m))
    return {key: v[torch.from_numpy(idx)] for key, v in batch.items()}


def _drive(entry, s, batch, k):
    if entry == "run":
        return s.run(batch, k)
    if entry == "train_on_batches":
        return s.train_on_batches(_stacked(batch, k))
    return s.train_minibatched(batch, k, 8, key=5)


def _assert_same(a, b):
    """Two samplers' states and two aux dicts, bitwise."""
    (sa, aux_a), (sb, aux_b) = a, b
    for x, y in zip(graphs.tensor_leaves(sa.state),
                    graphs.tensor_leaves(sb.state)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert set(aux_a) == set(aux_b)
    for key in aux_a:
        assert aux_a[key].shape == aux_b[key].shape
        assert torch.equal(aux_a[key], aux_b[key]), key


def _both(cfg, entry, k, counted):
    """The entry point through the graphs and through the eager loop from
    the same state: bitwise equal, with equal launch counts."""
    out = []
    for graph in (True, False):
        s, batch = _sampler(cfg, graph=graph)
        counted.launches = 0
        aux = _drive(entry, s, batch, k)
        out.append((s, aux, counted.launches))
    (sg, ag, ng), (se, ae, ne) = out
    _assert_same((sg, ag), (se, ae))
    assert ng == ne
    return sg


KS = [1, C - 1, C, C + 1, 2 * C + 3]


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("entry", ["run", "train_on_batches",
                                   "train_minibatched"])
@pytest.mark.parametrize("cfg", ["cold", "warm"])
def test_entry_points_equal_the_eager_loop(cfg, entry, k, counted):
    """run, train_on_batches and train_minibatched through the graphs equal
    the eager loop bitwise on the cold and the warm sampler, in whole
    chunks, a remainder or both; the launch counts are the eager loop's."""
    s = _both(cfg, entry, k, counted)
    assert int(s.state.step) == k
    assert ((C, ) in [(key[1],) for key in s._graphs.graphs]) == (k >= C)


@pytest.mark.parametrize("entry", ["run", "train_on_batches",
                                   "train_minibatched"])
@pytest.mark.parametrize("cfg", ["remat", "fused_gram", "fused",
                                 "fused_glm", "fused_model", "tile",
                                 "epilogue", "custom_grads", "subsample",
                                 "binned"])
def test_every_path_equals_the_eager_loop(cfg, entry, counted):
    """Every single-device step path through the graphs (a chunk and a
    remainder) equals the eager loop bitwise, with its launch counts."""
    _both(cfg, entry, C + 3, counted)


@pytest.mark.parametrize("cfg", ["cold", "warm", "fused_glm", "binned"])
def test_train_on_batch_equals_the_eager_step(cfg, counted):
    """train_on_batch through the one-step graph (the cold step) equals the
    eager step bitwise, three calls on three batches; 0-d aux."""
    out = []
    for graph in (True, False):
        s, batch = _sampler(cfg, graph=graph)
        counted.launches = 0
        stacked = _stacked(batch, 3)
        auxes = [s.train_on_batch({k: v[i] for k, v in stacked.items()})
                 for i in range(3)]
        out.append((s, auxes, counted.launches))
    (sg, ag, ng), (se, ae, ne) = out
    for a, b in zip(ag, ae):
        _assert_same((sg, a), (se, b))
        assert all(v.shape == () for v in a.values())
    assert ng == ne == 3 and sg._graphs.captures == 1


@pytest.mark.parametrize("cfg", ["cold", "warm"])
def test_zero_steps_through_the_graphs(cfg):
    """C4's zero-step calls keep their (0,)-shaped returns and the state."""
    s, batch = _sampler(cfg)
    before = [t.clone() for t in graphs.tensor_leaves(s.state)]
    for aux in (s.run(batch, 0), s.train_on_batches(_stacked(batch, 0)),
                s.train_minibatched(batch, 0, 8, key=1)):
        assert set(aux) == {"h2", "log_p_mean", "median", "phi_norm"}
        assert all(v.shape == (0,) for v in aux.values())
    for a, b in zip(before, graphs.tensor_leaves(s.state)):
        assert torch.equal(a, b)
    assert s._graphs.captures == 0


def test_kept_state_handle_does_not_change():
    """A state handle the caller kept is never a graph buffer: a later call
    leaves it as it was."""
    s, batch = _sampler("warm")
    s.run(batch, C + 1)
    kept = s.state
    values = [t.clone() for t in graphs.tensor_leaves(kept)]
    s.run(batch, C + 1)
    s.train_on_batches(_stacked(batch, C + 2))
    for a, b in zip(values, graphs.tensor_leaves(kept)):
        assert torch.equal(a, b)
    for g in s._graphs.graphs.values():
        for a, b in zip(graphs.tensor_leaves(g.carry),
                        graphs.tensor_leaves(s.state)):
            assert a.data_ptr() != b.data_ptr()


def test_new_batch_address_captures_again():
    """run's graph reads its batch in place, keyed by the leaves'
    addresses: the same batch replays, another batch of the same shapes
    (or an operand-building step's new operands) is captured again, and
    the results stay the eager loop's."""
    s, batch = _sampler("warm")
    e, _ = _sampler("warm", graph=False)
    other = {k: v + 1.0 for k, v in batch.items()}
    for b, captures in ((batch, 2), (batch, 2), (other, 4), (batch, 6)):
        _assert_same((s, s.run(b, C + 1)), (e, e.run(b, C + 1)))
        assert s._graphs.captures == captures
    # train_on_batches copies its slices: a new address is no new capture.
    for seed in (1, 2):
        stacked = _stacked(batch, C, seed=seed)
        _assert_same((s, s.train_on_batches(stacked)),
                     (e, e.train_on_batches(stacked)))
    assert s._graphs.captures == 7


def test_run_builds_operands_once_per_call(monkeypatch):
    """fused_glm's run builds the quadratic form once per call (its
    operands then come from static copies); train_on_batches builds it in
    every step."""
    calls = []
    model = TLR(D)

    def quadratic_form(batch):
        calls.append(1)
        return model.quadratic_form(batch)

    X, y, theta0 = _data()
    batch = {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}
    s = st.SVGDSampler(N, model.log_p, model.template(), st.Adam(1e-1),
                       theta=theta0, device="cpu", step_impl="fused_glm",
                       quadratic_form=quadratic_form, **FUSED)
    s._graphs = graphs.StepGraphs(capture=recorder)
    s.run(batch, C + 1)
    assert len(calls) == 1
    s.run(batch, 2)
    assert len(calls) == 2
    calls.clear()
    s.train_on_batches(_stacked(batch, 2))
    # The one-step graph's warm-up and capture, then each of the two
    # replays (the recorder's replays run the step's Python).
    assert len(calls) == 4


def test_graphs_match_jax_run():
    """One case through the graphs against the JAX sampler's run on the same
    numpy inputs (theta= given): the reference path (the exact median), a
    chunk and a remainder, at its tolerance."""
    X, y, theta0 = _data(seed=4)
    jm = JLR(D)
    js = sj.SVGDSampler(N, jm.log_p, jm.template(), sj.Adam(1e-1),
                        theta=jnp.asarray(theta0))
    s, batch = _sampler("cold", theta0=theta0)
    batch = {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}
    ja = js.run({"X": jnp.asarray(X), "y": jnp.asarray(y)}, C + 3)
    ta = s.run(batch, C + 3)
    np.testing.assert_allclose(s.samples, np.asarray(js.samples), **REF_TOL)
    for key in ta:
        np.testing.assert_allclose(ta[key].numpy(), np.asarray(ja[key]),
                                   **REF_TOL)
    assert s._graphs.captures == 2


def test_eager_rule():
    """The eager rule names exactly a mesh that is not NCCL: median='binned'
    is captured on one device and on NCCL meshes of one rank or of many
    (1-D or 2-D), and stays eager only on a gloo mesh, as every median
    does."""
    from stein_tpu_torch.parallel.mesh import Mesh2D, ParticleMesh

    model = TLR(D)
    for median in ("exact", "subsample", "bisect", "binned"):
        s = st.SVGDSampler(N, model.log_p, model.template(), st.Adam(1e-1),
                           device="cpu", median=median)
        assert s._eager_reason is None
    assert graphs.eager_reason(None) is None
    with one_process_mesh() as mesh:
        assert "gloo" in graphs.eager_reason(mesh)
        s = st.SVGDSampler(N, model.log_p, model.template(), st.Adam(1e-1),
                           device="cpu", mesh=mesh, **BINNED)
        assert "gloo" in s._eager_reason

    def nccl(size, name="particles"):
        return ParticleMesh(None, name, size, 0, "cuda")
    for mesh in (nccl(1), Mesh2D(nccl(1), nccl(1, "model")), nccl(2),
                 Mesh2D(nccl(1), nccl(2, "model")),
                 Mesh2D(nccl(4), nccl(1, "model"))):
        assert graphs.eager_reason(mesh) is None
    assert [graphs.mesh_ranks(m) for m in (
        None, nccl(4), Mesh2D(nccl(2), nccl(2, "model")))] == [1, 4, 4]


@pytest.mark.parametrize("entry", ["run", "train_on_batches",
                                   "train_minibatched"])
def test_binned_graph_counts(entry, monkeypatch):
    """The binned sampler's bookkeeping: a chunk graph and a remainder
    graph, each step's histogram counts (the plain count on the CPU,
    counted in the registry as a kernel wrapper's launches are) replayed
    as many times as the eager loop runs them: three row blocks (10, 10
    and the remainder 4) and two levels a step, both middle ranks' windows
    in one count a block."""
    from stein_tpu_torch.ops import median

    class Counts:   # the counter of the plain count's calls
        launches = 0
    plain = median._gram_bin_counts

    def counting(*args):
        Counts.launches += 1
        return plain(*args)
    monkeypatch.setattr(median, "_gram_bin_counts", counting)
    registry = graphs.launch_counters
    monkeypatch.setattr(graphs, "launch_counters", lambda: {
        **registry(), "bin_counts": (Counts, "launches")})
    k, out = C + 3, []
    for graph in (True, False):
        s, batch = _sampler("binned", graph=graph)
        Counts.launches = 0
        aux = _drive(entry, s, batch, k)
        out.append((s, aux, Counts.launches))
    (sg, ag, ng), (se, ae, ne) = out
    _assert_same((sg, ag), (se, ae))
    assert ng == ne == k * 3 * 2
    assert sorted(steps for _, steps in sg._graphs.graphs) == [1, C]
    assert sg._graphs.captures == 2


def test_cpu_sampler_runs_eagerly():
    """On the CPU the sampler has no graphs; _eager runs the loop on any
    device and gives the graphs back."""
    s, batch = _sampler("warm", graph=False)
    assert s._graphs is None
    g, _ = _sampler("warm")
    drv = g._graphs
    aux = g._eager("run", batch, 3)
    assert g._graphs is drv and drv.captures == 0
    assert aux["median"].shape == (3,)


def test_minibatch_indices_feed_the_graph():
    """train_minibatched's chunks gather the indices of their own steps:
    the graphs equal train_on_batches on the same rows."""
    s, batch = _sampler("warm")
    e, _ = _sampler("warm", graph=False)
    k = 2 * C + 3
    idx = minibatch_indices(5, k, 8, N_OBS, "cpu")
    rows = {key: v[idx] for key, v in batch.items()}
    _assert_same((s, s.train_minibatched(batch, k, 8, key=5)),
                 (e, e.train_on_batches(rows)))


def test_launch_counters_registry():
    """The registry names every kernel wrapper's count once, as (wrapper,
    attribute) pairs that read an int."""
    reg = graphs.launch_counters()
    assert {"B%d" % i for i in range(1, 13)} <= set(reg)
    assert {"B3-bf16", "glm", "logistic", "bin_count"} <= set(reg)
    assert all(isinstance(getattr(*c), int) for c in reg.values())
