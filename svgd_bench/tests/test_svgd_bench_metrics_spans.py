"""The span metrics' readers (metrics/call_*.py, graph_launch_us_per_step,
device_allocs_per_call) on a filled summary, an empty one, one rank's, a
port without the recorder, and the recorder's own summary of a CPU run,
where the device metrics read None (no device clock there). A reader takes
the window's own calls, the latest that hold ``ctx.steps``."""

import importlib.util
import json
import sys
from pathlib import Path

from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from stein_tpu_torch.utils import profiling  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = ["call_seed_us_per_step", "call_prep_us_per_step",
           "call_agree_us_per_step", "call_replay_us_per_step",
           "graph_launch_us_per_step", "device_allocs_per_call"]


def reader(name):
    path = ROOT / "svgd_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"span_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def call(i, slow=1.0, agree=True):
    """A 128-step call's record on a card (``slow`` scales its times)."""
    spans = {"svgd.run": (1, 0.05, 0.06), "svgd.seed": (1, 0.001, 0.000256),
             "svgd.prep": (1, 0.002, 0.000512),
             "svgd.agree": (1, 0.000128, None),
             "svgd.replays": (1, 0.04, 0.029),
             "svgd.launch": (4, 0.000064, None)}
    if not agree:
        del spans["svgd.agree"]
    return {"call": i, "steps": 128, "device_allocs": 3 if i == 1 else 1,
            "spans": {k: {"count": n, "host_s": h * slow,
                          "device_s": None if d is None else d * slow}
                      for k, (n, h, d) in spans.items()}}


# The run's earlier profiled call (twice as slow), then a window of two.
FILLED = {"spans": {}, "calls": [call(1, 2.0), call(2), call(3)],
          "counters": {"device_allocs": 5, "captures": 1, "launches": {}}}
WINDOW = SimpleNamespace(steps=256)
WANT = {"call_seed_us_per_step": 2.0, "call_prep_us_per_step": 4.0,
        "call_agree_us_per_step": 1.0,
        "call_replay_us_per_step": 0.029e6 / 128,
        "graph_launch_us_per_step": 0.5, "device_allocs_per_call": 1.0}
EMPTY = {"spans": {}, "calls": [],
         "counters": {"device_allocs": None, "captures": 0, "launches": {}}}


def test_every_reader_has_its_entry():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert m["layer"] == "sampler loop and graphs"
        assert m["moves"] == "updates_per_s" and m["better"] == "lower"
    assert entries["call_agree_us_per_step"]["workloads"] == [
        "linreg-p64-suff.n8192-mesh4"]


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_filled_and_an_empty_summary(name, monkeypatch):
    got = {}
    monkeypatch.setattr(profiling, "summary", lambda: got["summary"])
    read = reader(name)
    got["summary"] = FILLED
    assert read(WINDOW) == pytest.approx(WANT[name])
    got["summary"] = EMPTY
    assert read(WINDOW) is None


def test_agree_is_none_on_one_rank(monkeypatch):
    one = dict(FILLED, calls=[call(i, agree=False) for i in (1, 2, 3)])
    monkeypatch.setattr(profiling, "summary", lambda: one)
    assert reader("call_agree_us_per_step")(WINDOW) is None
    assert reader("call_seed_us_per_step")(WINDOW) == pytest.approx(2.0)


def test_readers_take_all_calls_where_the_window_holds_more(monkeypatch):
    """A window of more steps than recorded (a summary cleared inside it)
    reads every recorded call."""
    monkeypatch.setattr(profiling, "summary", lambda: FILLED)
    seed = reader("call_seed_us_per_step")(SimpleNamespace(steps=10 ** 6))
    assert seed == pytest.approx((0.000512 + 2 * 0.000256) * 1e6 / 384)


@pytest.mark.parametrize("name", READERS)
def test_reader_without_the_recorder(name, monkeypatch):
    """A port whose profiling module has no summary (the parent of the
    recorder) reads None and does not raise."""
    monkeypatch.delattr(profiling, "summary")
    assert reader(name)(WINDOW) is None


def test_readers_on_a_cpu_recorder():
    """The recorder's own summary of two calls of the CPU's eager loop:
    svgd.run counts their steps, and every reader reads None (no device
    clock, no replays or launches, one rank)."""
    import stein_tpu_torch as st
    from stein_tpu_torch.models import LinearRegressionModel

    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.normal(size=(40, 3)).astype(np.float32))
    batch = {"X": X, "y": X[:, :1] * 2.0}
    model = LinearRegressionModel(3)
    s = st.SVGDSampler(16, model.log_p, model.template(), st.Adam(0.1),
                       device="cpu", median="bisect", warm_median=True)
    profiling.reset()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            s.run(batch, 3)
            s.run(batch, 3)
        for name in READERS:
            assert reader(name)(SimpleNamespace(steps=3)) is None, name
        assert profiling.summary()["spans"]["svgd.run"]["steps"] == 6
        assert [c["steps"] for c in profiling.summary()["calls"]] == [3, 3]
    finally:
        profiling.reset()
