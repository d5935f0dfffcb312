"""The benchmark's harness on the CPU at tiny sizes: BENCHMARK.json's
rules, files found by name, the trace's reduction, the result line, the
4-rank launch on gloo, and a run without a card. The port's plain
versions stand in for its kernels here; no number from these runs is a
device metric."""

import json
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from svgd_bench import run, spec, trace  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = ["command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"]


def check_names(bench):
    """The names, units and one-line fields of BENCHMARK.json that break
    the benchmark's rules, as a list of messages (empty: none)."""
    bad = []

    def name(v, where):
        if not isinstance(v, str) or not NAME.match(v):
            bad.append(f"{where}: bad name {v!r}")

    def line(v, where):
        if (not isinstance(v, str) or not 1 <= len(v) <= 200
                or "\n" in v or "\t" in v):
            bad.append(f"{where}: bad text {v!r}")

    for c in bench["configs"]:
        name(c["name"], "config")
        line(c["source"], f"config {c['name']} source")
        line(c["why"], f"config {c['name']} why")
        for k in c["reduced"]:
            name(k, f"config {c['name']} reduced")
    for w in bench["workloads"]:
        for key in ("name", "config", "traffic"):
            name(w[key], f"workload {key}")
        line(w["why"], f"workload {w['name']} why")
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            name(m["name"], group)
            if not UNIT.match(m["unit"]):
                bad.append(f"{group} {m['name']}: bad unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                bad.append(f"{group} {m['name']}: better {m['better']!r}")
            if "layer" in m:
                line(m["layer"], f"{m['name']} layer")
    for word in bench["command"]:
        line(word, "command")
    return bad


def tiny(name, n=None, k=32):
    """The cell with fewer particles and steps a call (CPU-sized)."""
    cell = spec.Cell(name)
    cell.traffic["n"] = n or (256 if cell.chips > 1 else 96)
    cell.traffic["k"] = k
    return cell


def args(name, seed=5, seconds=0.5, trace_=0):
    return run.parse(["--workload", name, "--seed", str(seed), "--seconds",
                      str(seconds), "--trace", str(trace_)])


def test_benchmark_json_keeps_its_rules():
    assert list(BENCH) == KEYS
    assert check_names(BENCH) == []
    assert BENCH["paths"] == ["svgd_bench"]
    assert all("svgd_bench" not in w and w.startswith("/") is False
               for w in BENCH["command"][2:])
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("svgd_bench/")
        assert (ROOT / c["file"]).is_file()
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(cells) // 4)
    # A full check with 24 cells fits its budget at this run length.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(name):
    cell = spec.Cell(name)
    assert cell.limits["limits"]["steps_gap"] == 0
    for m in cell.metrics(trace=False) + cell.metrics(trace=True):
        if m in BENCH["per_layer"]:
            assert (ROOT / "svgd_bench" / "metrics"
                    / f"{m['name']}.py").is_file()
    names = {m["name"] for m in cell.metrics(trace=False)}
    assert "setup_s" in names and len(names) >= 2
    assert cell.metrics(trace=True)
    assert (ROOT / "svgd_bench" / "kinds"
            / f"{cell.config['kind']}.py").is_file()


def test_added_files_are_found_by_name(tmp_path):
    """A later PR adds a configuration, a traffic mix, a layer pattern file
    and a per-layer metric as files, and an entry each in BENCHMARK.json;
    no file of the harness changes."""
    bench_dir = tmp_path / "svgd_bench"
    shutil.copytree(ROOT / "svgd_bench", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((bench_dir / "configs" / "linreg-p128.json").read_text())
    cfg["model"]["n_feats"] = 32
    (bench_dir / "configs" / "linreg-p32.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "n512.k64.json").write_text(json.dumps(
        {"n": 512, "k": 64, "chips": 1, "pick": "throughput_config",
         "keywords": {"median_passes": 30, "warm_passes": 8}}))
    (bench_dir / "limits" / "linreg-p32.n512.json").write_text(
        (bench_dir / "limits" / "linreg-p128.n1000.json").read_text())
    (bench_dir / "layers" / "phi.later.json").write_text(json.dumps(
        {"layer": "phi", "patterns": ["\\bnew_phi_kernel\\b"]}))
    (bench_dir / "metrics" / "new_metric.py").write_text(
        "def read(ctx):\n    return ctx.layer_s.get('phi', 0) * 2\n")
    b["configs"].append({"name": "linreg-p32", "source": "x",
                         "file": "svgd_bench/configs/linreg-p32.json",
                         "reduced": [], "why": "w"})
    b["workloads"].append({"name": "linreg-p32.n512", "config": "linreg-p32",
                           "traffic": "n512.k64", "chips": 1, "why": "w"})
    b["per_layer"].append({"name": "new_metric", "unit": "us", "better":
                           "lower", "source": "device_trace", "layer": "phi",
                           "moves": "updates_per_s",
                           "workloads": ["linreg-p32.n512"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.Cell("linreg-p32.n512", root=tmp_path, bench_dir=bench_dir)
    assert cell.config["model"]["n_feats"] == 32
    assert cell.traffic["n"] == 512
    assert "new_metric" in [m["name"] for m in cell.metrics(trace=True)]
    pats = trace.layer_patterns(bench_dir)
    secs, _, unmatched = trace.classify(
        [("void new_phi_kernel<4>(float*)", 2e-6, 1),
         ("svgd_tile_kernel(TileArgs, Geom, PrepPtrs)", 1e-6, 1),
         ("mystery", 5e-6, 1)], pats)
    assert secs["phi"] == pytest.approx(3e-6)
    assert unmatched == [("mystery", 5e-6)]
    fake = SimpleNamespace(kernels=[("svgd_tile_kernel", 4e-6, 2)],
                           busy_s=1.0, window_s=2.0, steps=2)
    out = run.layer_metrics(cell, fake, 512, 32,
                            {"median_max_rows": 256}, __import__(
                                "svgd_bench.kinds.linreg",
                                fromlist=["x"]), bench_dir=bench_dir)
    assert out["new_metric"]["value"] == pytest.approx(8e-6)


def _event(name, start, end, cuda):
    from torch.autograd import DeviceType
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if cuda else DeviceType.CPU)


def test_trace_reduction():
    ev = [_event(trace.WINDOW, 0, 100, False),
          _event("cudaGraphLaunch", 5, 15, False),
          _event("aten::item", 40, 70, False),
          _event("svgd_tile_kernel(A)", 10, 30, True),
          _event("median_kernel(G, M)", 25, 40, True),
          _event("ncclDevKernel_AllReduce", 80, 90, True),
          _event("svgd_tile_kernel(A)", 120, 130, True)]
    note = _event("nccl:all_reduce", 0, 95, True)
    note.is_user_annotation = True
    t = trace.Trace(ev + [note], steps=4)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(40e-6)
    assert dict((k, s) for k, s, _ in t.kernels) == pytest.approx(
        {"svgd_tile_kernel(A)": 20e-6, "median_kernel(G, M)": 15e-6,
         "ncclDevKernel_AllReduce": 10e-6})
    assert t.idle == pytest.approx({"cudaGraphLaunch": 10e-6,
                                    "aten::item": 40e-6, "python": 10e-6})
    b = t.breakdown()
    assert set(b) == {"device_ops", "idle_gaps"}
    assert b["device_ops"][0] == ["svgd_tile_kernel(A)", pytest.approx(2e-5)]
    secs, counts, un = trace.classify(t.kernels,
                                      trace.layer_patterns(ROOT / "svgd_bench"))
    assert secs == pytest.approx({"phi": 20e-6, "median": 15e-6,
                                  "nccl": 10e-6})
    assert un == []


@pytest.mark.parametrize("name", ["linreg-p128.n1000", "bnn-1x100x1.n1000"])
def test_the_result_line_on_the_cpu(name):
    torch.set_num_threads(2)
    cell = tiny(name)
    out = run.run_cell(cell, args(name), torch.device("cpu"))
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["metrics"]) == {"updates_per_s", "setup_s"}
    assert out["device"]["platform"] == "cpu"
    assert set(out["checks"]) == set(cell.limits["limits"])
    json.dumps(out)


def test_no_card_exits_without_a_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, str(ROOT / "svgd_bench" / "run.py"), "--workload",
         "linreg-p128.n1000", "--seed", "2147483653", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def _rank(rank, port, queue):
    torch.set_num_threads(1)
    name = "linreg-p64-suff.n8192-mesh4"
    out = run.run_cell(tiny(name), args(name, seconds=0.5),
                       torch.device("cpu"), rank, port)
    queue.put((rank, out))


def test_four_ranks_on_gloo():
    """The 4-card cell's launch rehearsed: 4 processes, one gloo group,
    rank 0 judges every rank's shard gathered."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = run.free_port()
    procs = [ctx.Process(target=_rank, args=(r, port, queue))
             for r in range(4)]
    for p in procs:
        p.start()
    got = dict(queue.get(timeout=600) for _ in procs)
    for p in procs:
        p.join(timeout=120)
        assert not p.is_alive() and p.exitcode == 0
    assert all(got[r] is None for r in (1, 2, 3))
    out = got[0]
    assert out["correct"] is True, out["checks"]
    assert out["device"]["count"] == 4
