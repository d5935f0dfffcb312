"""The Year cell's files on the CPU: the kind's draw and gradient
operations, the wide route's kernel in the phi layer, its two metrics on a
fabricated trace (and on one without the kernel, as the parent's reads),
and the result line at tiny sizes through the port's plain versions. No
number from these runs is a device metric."""

import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from svgd_bench import flops, problem, run, spec, trace  # noqa: E402

CELL = "bnn-year-90x100x1.n2048"
GRAM = "void stein::(anonymous namespace)::phi_gram_kernel(stein::GramArgs, float*)"
ON_D = "void stein::(anonymous namespace)::svgd_on_d_kernel(stein::OnDArgs)"


def reader(name):
    path = ROOT / "svgd_bench" / "metrics" / f"{name}.py"
    s = importlib.util.spec_from_file_location(f"year_metric_{name}", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def test_the_draw():
    cell = spec.Cell(CELL)
    kind = problem.kind_module(cell.config)
    a = kind.make(cell.config, problem.generator(2 ** 31 + 11, "cpu"), "cpu")
    b = kind.make(cell.config, problem.generator(2 ** 31 + 11, "cpu"), "cpu")
    model, batch, data, p = a
    assert p == 9203
    assert (model.n_feats, model.n_hidden, model.n_train, model.n_batch) == (
        90, 100, 463715, 100)
    assert (model.prior_alpha, model.prior_beta) == (1.0, 0.1)
    assert batch["X"].shape == (100, 90) and batch["y"].shape == (100, 1)
    assert float(batch["y"].mean()) == pytest.approx(0.0, abs=1e-5)
    assert float(batch["y"].std()) == pytest.approx(1.0, abs=1e-5)
    assert all(torch.equal(batch[k], b[1][k]) for k in batch)
    c = kind.make(cell.config, problem.generator(12, "cpu"), "cpu")
    assert not torch.equal(batch["X"], c[1]["X"])
    assert data.keys() == batch.keys()


def test_grad_ops():
    cell = spec.Cell(CELL)
    kind = problem.kind_module(cell.config)
    # 3 B (2 f H + 4 H) a particle: 11.3 GFLOP a step at n = 2048.
    assert kind.grad_ops(cell.config, 1) == 100 * 3 * (2 * 90 * 100 + 400)
    assert kind.grad_ops(cell.config, 2048) == pytest.approx(1.1305e10,
                                                             rel=1e-3)


def test_the_reference_takes_the_minibatch_scale():
    cell = spec.Cell(CELL)
    kind = problem.kind_module(cell.config)
    _, batch, data, p = kind.make(cell.config, problem.generator(3, "cpu"),
                                  "cpu")
    theta = 0.1 * torch.randn(3, p, generator=torch.Generator().manual_seed(1),
                              dtype=torch.float64)
    lp, g = kind.reference(cell.config, {k: v.double()
                                         for k, v in data.items()})(theta)
    assert lp.shape == (3,) and g.shape == (3, p)
    assert torch.isfinite(lp).all() and torch.isfinite(g).all()


def test_the_gram_kernel_lands_in_the_phi_layer():
    pats = trace.layer_patterns(ROOT / "svgd_bench")
    secs, _, unmatched = trace.classify([(GRAM, 2.0, 1), (ON_D, 1.0, 1)],
                                        pats)
    assert secs == {"phi": 3.0} and unmatched == []


def _ctx(kernels, steps=64, n=2048, p=9203):
    return SimpleNamespace(trace=SimpleNamespace(kernels=kernels),
                           steps=steps, n=n, p=p, rows=n, chips=1,
                           flops=flops)


def test_both_metrics_on_a_fabricated_trace():
    # 64 steps, the Gram kernel 3 ms a step, beside B10's tile.
    ctx = _ctx([(GRAM, 64 * 3e-3, 64), (ON_D, 64 * 4e-3, 64),
                ("void at::native::vectorized_elementwise_kernel", 0.1, 9)])
    assert reader("phi_gram_us_per_step")(ctx) == pytest.approx(3000.0)
    ops = 2 * 2048 * 2048 * 9203 + 3 * 2048 * 2048
    want = 100.0 * (ops / flops.PEAK_FLOPS) / 3e-3
    assert reader("phi_gram_roofline")(ctx) == pytest.approx(want)
    assert 0 < want < 100


@pytest.mark.parametrize("name", ["phi_gram_us_per_step",
                                  "phi_gram_roofline"])
def test_both_metrics_read_none_without_the_kernel(name):
    """The parent, which has no wide route: no such kernel, no reading."""
    ctx = _ctx([("void stein::svgd_tile_kernel<20, false>(...)", 1.0, 64)])
    assert reader(name)(ctx) is None


def test_the_cell_in_benchmark_json():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "bnn-year-90x100x1", "n2048.k32", 1)
    per = {m["name"]: m for m in bench["per_layer"]}
    for name in ("phi_gram_us_per_step", "phi_gram_roofline"):
        assert per[name]["workloads"] == [CELL]
        assert per[name]["layer"] == "phi"
    names = {m["name"] for m in spec.Cell(CELL).metrics(trace=True)}
    assert {"phi_us_per_step", "phi_roofline", "step_mfu",
            "grad_kernel_us_per_step", "phi_gram_us_per_step"} <= names
    assert "tail_us_per_step" not in names and "nccl_share" not in names


def test_the_result_line_on_the_cpu():
    """The cell at 24 particles and 4 steps a call through the plain
    versions on the CPU (the wide route's plain stages at p = 9203)."""
    torch.set_num_threads(2)
    cell = spec.Cell(CELL)
    cell.traffic["n"], cell.traffic["k"] = 24, 4
    out = run.run_cell(cell, run.parse(
        ["--workload", CELL, "--seed", "2147483659", "--seconds", "0.5",
         "--trace", "0"]), torch.device("cpu"))
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["checks"]) == set(cell.limits["limits"])
    json.dumps(out)
