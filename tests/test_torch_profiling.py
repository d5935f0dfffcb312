"""The program's spans and counters (stein_tpu_torch/utils/profiling.py).

On the CPU: with no profiler running, ``annotate`` is one shared no-op and
nothing is recorded; under a CPU ``torch.profiler`` a sampler's ``run``
records its per-call spans (the graphs recorded by
``cuda_graph_ranks.recorder``, whose replays run the step's Python, so the
stage spans show under ``svgd.launch``), with their parents, calls, steps
and self time; ``summary()`` reads the program's own counters; a span
inside a stream capture records no event. On a card (marked ``cuda``, it
skips here): the call's device time is its three phases', and a capture
made while profiling succeeds. This file imports no JAX."""

import contextlib
import gc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import stein_tpu_torch as st
from cuda_graph_ranks import recorder
from stein_tpu_torch.models import LinearRegressionModel
from stein_tpu_torch.utils import graphs, profiling
from torch_mesh_runner import one_process_mesh

N, D, N_OBS = 24, 4, 40
K = 2 * graphs.CHUNK
STAGES = ("svgd.grad", "svgd.median", "svgd.phi", "svgd.update")


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


# The streaming tile's warm step (the n10240 and NN cells' path).
TILE = dict(median="bisect", warm_median=True, warm_passes=6,
            kernel_impl="pallas", median_impl="fused_gram",
            median_max_rows=16)


def _sampler(graph=True, n=N, p=D, device="cpu", cfg=TILE, mesh=None,
             sufficient=False):
    """A linear regression sampler and its batch (the sufficient batch and
    the model's quadratic_form with ``sufficient``); its steps through
    recorded graphs (``graph``) or the eager loop."""
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.normal(size=(N_OBS, p)).astype(np.float32))
    y = X @ torch.from_numpy(rng.normal(size=(p, 1)).astype(np.float32))
    model = LinearRegressionModel(p)
    batch = {"X": X.to(device), "y": y.to(device)}
    kw = dict(cfg)
    if sufficient:
        batch = model.sufficient_batch(batch)
        kw["quadratic_form"] = model.quadratic_form
    s = st.SVGDSampler(n, model.log_p, model.template(), st.Adam(1e-1),
                       theta=rng.normal(size=(n, p)) * 0.1, device=device,
                       mesh=mesh, **kw)
    if graph:
        s._graphs = graphs.StepGraphs(capture=recorder, mesh=mesh)
    return s, batch


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_is_the_shared_no_op_and_records_nothing(monkeypatch):
    """No profiler: annotate returns one shared object whatever it is
    given, and a run makes no record_function, no event, no memory_stats
    read and no span."""
    a = profiling.annotate("svgd.run", torch.device("cuda"), steps=3)
    assert a is profiling.annotate("svgd.grad") is profiling._OFF
    made = []
    monkeypatch.setattr(profiling, "record_function",
                        lambda name: made.append(name))
    monkeypatch.setattr(profiling, "_device_allocs",
                        lambda device: made.append(device))
    monkeypatch.setattr(torch.cuda, "Event", lambda **kw: made.append(kw))
    for graph in (True, False):
        s, batch = _sampler(graph)
        s.run(batch, K)
        s.run(batch, K)
    assert made == []
    assert profiling.summary()["spans"] == {}


def test_warm_run_records_its_call_spans():
    """A warm run(batch, 64) under a CPU profiler: one svgd.run of 64
    steps, its seed, prep and replays, two launches of the 32-step graph,
    no capture; host clock only."""
    s, batch = _sampler()
    s.run(batch, K)
    with _cpu_profile():
        s.run(batch, K)
    spans = profiling.summary()["spans"]
    run = spans["svgd.run"]
    assert (run["count"], run["steps"], run["calls"]) == (1, K, 1)
    for name in ("svgd.seed", "svgd.prep", "svgd.replays"):
        assert spans[name]["count"] == 1
        assert spans[name]["parents"] == {"svgd.run": 1}
    assert spans["svgd.launch"]["count"] == 2
    assert spans["svgd.launch"]["parents"] == {"svgd.replays": 2}
    assert "svgd.capture" not in spans and "svgd.agree" not in spans
    # The recorder's replays run the step's Python: 64 of each stage.
    for name in STAGES:
        assert spans[name]["count"] == K, name
    assert spans["svgd.grad"]["parents"] == {"svgd.launch": K}
    assert all(v["device_s"] is None and v["timed"] == 0
               for v in spans.values())
    assert profiling.summary()["counters"]["device_allocs"] is None


def test_parents_calls_and_self_time():
    """Two calls, the first capturing: each span's calls and parents, and
    self time = duration less the children's; reset() clears."""
    s, batch = _sampler()
    with _cpu_profile():
        s.run(batch, K + 1)     # a 32-step and a 1-step graph, captured
        s.run(batch, K + 1)
    spans = profiling.summary()["spans"]
    assert spans["svgd.run"]["count"] == spans["svgd.run"]["calls"] == 2
    assert spans["svgd.run"]["parents"] == {None: 2}
    assert spans["svgd.run"]["steps"] == 2 * (K + 1)
    # The first graph is captured in prep, the remainder's in replays.
    assert spans["svgd.capture"]["count"] == 2
    assert spans["svgd.capture"]["calls"] == 1
    assert spans["svgd.capture"]["parents"] == {"svgd.prep": 1,
                                                "svgd.replays": 1}
    assert spans["svgd.launch"]["count"] == 6
    assert spans["svgd.launch"]["calls"] == 2
    run = spans["svgd.run"]
    children = sum(spans[n]["host_s"]
                   for n in ("svgd.seed", "svgd.prep", "svgd.replays"))
    assert run["self_s"] == pytest.approx(run["host_s"] - children,
                                          abs=1e-8)
    assert 0 < run["self_s"] < run["host_s"]
    for v in spans.values():
        assert 0 <= v["self_s"] <= v["host_s"]
    # Each call's own record: its steps and spans, summing to the totals.
    calls = profiling.summary()["calls"]
    assert [c["steps"] for c in calls] == [K + 1, K + 1]
    assert calls[1]["call"] == calls[0]["call"] + 1
    assert "svgd.capture" in calls[0]["spans"]
    assert "svgd.capture" not in calls[1]["spans"]
    for name, v in spans.items():
        assert sum(c["spans"][name]["host_s"] for c in calls
                   if name in c["spans"]) == pytest.approx(v["host_s"])
    profiling.reset()
    assert profiling.summary()["spans"] == {}
    assert profiling.summary()["calls"] == []


def test_eager_loop_records_run_seed_and_prep():
    """The eager loop (the CPU, a gloo mesh): svgd.run, svgd.seed and
    svgd.prep on the host clock; the stages directly under the call."""
    s, batch = _sampler(graph=False)
    with _cpu_profile():
        s.run(batch, 5)
    spans = profiling.summary()["spans"]
    for name in ("svgd.run", "svgd.seed", "svgd.prep"):
        assert spans[name]["count"] == 1
    assert "svgd.replays" not in spans and "svgd.launch" not in spans
    assert spans["svgd.grad"]["parents"] == {"svgd.run": 5}
    assert spans["svgd.median"]["count"] == 5


@pytest.mark.parametrize("path", ["tile", "fused_gram", "fused_shard"])
def test_stage_spans_of_the_cells_paths(path):
    """The benchmark cells' step paths each record the four stages once a
    step: the streaming tile's warm step, the fused_gram chain and the
    mesh's fused_shard step (on a one-process gloo mesh)."""
    cfg = {"tile": TILE,
           "fused_gram": dict(TILE, kernel_impl="xla", median_impl="fused",
                              step_impl="fused_gram"),
           "fused_shard": dict(TILE, kernel_impl="xla", median_impl="xla",
                               step_impl="fused_shard",
                               median_collectives="grid",
                               median_grid_g1=8)}[path]
    with contextlib.ExitStack() as stack:
        mesh = (stack.enter_context(one_process_mesh())
                if path == "fused_shard" else None)
        s, batch = _sampler(graph=False, cfg=cfg, mesh=mesh,
                            sufficient=mesh is not None)
        with _cpu_profile():
            s.run(batch, 3)
    spans = profiling.summary()["spans"]
    assert [spans[n]["count"] for n in STAGES] == [3, 3, 3, 3]
    assert spans["svgd.run"]["steps"] == 3


def test_summary_reads_the_programs_counters():
    """launches are graphs.read_counts(); captures count every live
    sampler's graphs (StepGraphs.captures)."""
    gc.collect()
    before = profiling.summary()["counters"]["captures"]
    s, batch = _sampler()
    s.run(batch, K + 1)
    counters = profiling.summary()["counters"]
    assert counters["launches"] == graphs.read_counts()
    assert s._graphs.captures == 2
    assert counters["captures"] - before == s._graphs.captures


class _Event:
    """A stand-in for torch.cuda.Event: 2 ms between any two."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1

    def record(self, stream=None):
        pass

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 2.0


def test_no_event_while_the_stream_captures(monkeypatch):
    """A span given a card records an event at each edge, except while the
    stream is capturing; a stage span (no device) never records one."""
    capturing = [True]
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    monkeypatch.setattr(profiling, "_device_allocs", lambda device: 7)
    _Event.made = 0
    card = torch.device("cuda", 0)
    with _cpu_profile():
        with profiling.annotate("svgd.replays", card):
            with profiling.annotate("svgd.grad"):
                pass
        assert _Event.made == 0
        capturing[0] = False
        with profiling.annotate("svgd.grad"):
            pass
        assert _Event.made == 0
        with profiling.annotate("svgd.run", card, steps=4):
            pass
        assert _Event.made == 2
    got = profiling.summary()
    spans = got["spans"]
    assert spans["svgd.replays"]["device_s"] is None
    assert spans["svgd.run"]["device_s"] == pytest.approx(2e-3)
    assert spans["svgd.run"]["timed"] == 1
    assert spans["svgd.grad"]["timed"] == 0
    assert got["counters"]["device_allocs"] == 0
    (call,) = got["calls"]
    assert call["steps"] == 4 and call["device_allocs"] == 0
    assert call["spans"]["svgd.run"]["device_s"] == pytest.approx(2e-3)


@pytest.mark.cuda
def test_call_spans_tile_the_device_wall_on_the_card(tmp_path):
    """On the card: the first call captures its graphs while profiled; then
    seed + prep + replays device seconds equal svgd.run's within 1%, every
    call timed, the allocations counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    s, batch = _sampler(graph=False, n=1000, p=128, device="cuda",
                        cfg=st.throughput_config(1000, 128))
    assert s._graphs is not None
    with profiling.trace(str(tmp_path)):
        s.run(batch, 128)["phi_norm"][-1].item()
        assert profiling.summary()["spans"]["svgd.capture"]["count"] == 1
        profiling.reset()
        for _ in range(4):
            s.run(batch, 128)["phi_norm"][-1].item()
    assert (tmp_path / "trace.json").exists()
    got = profiling.summary()
    spans = got["spans"]
    run = spans["svgd.run"]
    assert run["count"] == run["timed"] == 4
    parts = sum(spans[n]["device_s"]
                for n in ("svgd.seed", "svgd.prep", "svgd.replays"))
    assert abs(parts - run["device_s"]) <= 0.01 * run["device_s"], (
        parts, run["device_s"])
    assert spans["svgd.launch"]["count"] == 16
    assert got["counters"]["device_allocs"] is not None
