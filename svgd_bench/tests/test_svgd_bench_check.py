"""The check that decides ``correct``, and the import guard.

On the CPU at tiny sizes: a run whose timed path is broken underneath
comes out not correct, once for each fault a cell can have (a step that
returns its state unchanged; half of the batch left out, the mean taken
over the rest; the exchange between ranks left out; a particle altered
where the step produces it). On a card (skipped without one): the control,
the reference in float32 with TF32 matmuls put in the program's place,
fails a limit on three seeds at each one-card cell's own size, and the
program passes them."""

import ast
import json
import multiprocessing
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from svgd_bench import guard, run, spec  # noqa: E402
from svgd_bench.tests.test_svgd_bench_harness import args, tiny  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("names,want", [
    (["stein_tpu_torch", "stein_tpu_torch.api", "torch"], []),
    (["jax.numpy", "stein_tpu_torch"], ["jax"]),
    (["stein_tpu.ops.median", "jaxlib", "flax.linen"],
     ["flax", "jaxlib", "stein_tpu"]),
    (["stein_tpuX", "jax_like", "numpy"], [])])
def test_guard_compares_whole_top_level_names(names, want):
    assert guard.banned_modules(names) == want


def test_a_run_loads_no_jax():
    code = (
        "import sys, torch; sys.path.insert(0, %r)\n"
        "from svgd_bench import guard, run\n"
        "from svgd_bench.tests.test_svgd_bench_harness import args, tiny\n"
        "torch.set_num_threads(2)\n"
        "run.run_cell(tiny('linreg-p128.n1000'), args('linreg-p128.n1000'),"
        " torch.device('cpu'))\n"
        "print(guard.banned_modules())\n" % str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_file_reads_the_jax_package_or_its_bench():
    """No module under svgd_bench/ imports JAX, the JAX package,
    benchmarks/ or bench_torch.py, or names those files in its code."""
    for path in (ROOT / "svgd_bench").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "stein_tpu",
                           "benchmarks", "bench_torch", "bench"}, path
        tree = ast.parse(path.read_text())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
                and n.body and isinstance(n.body[0], ast.Expr)}
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs and path.parent.name != "tests"):
                assert "benchmarks/" not in node.value, path
                assert "bench_torch" not in node.value, path


# ----------------------------------------------------------------- faults

def _unchanged_state(monkeypatch):
    from stein_tpu_torch.utils import graphs
    orig = graphs.eager_steps

    def eager_steps(step, carry, n, feed):
        def same(c, *a):
            new, aux = step(c, *a)
            return (c[0], new[1]) if isinstance(c, tuple) else c, aux
        return orig(same, carry, n, feed)
    monkeypatch.setattr(graphs, "eager_steps", eager_steps)


def _half_batch(monkeypatch):
    from stein_tpu_torch.models import BayesianNNModel, LinearRegressionModel
    for cls in (LinearRegressionModel, BayesianNNModel):
        orig = cls.log_p

        def log_p(self, params, batch, orig=orig):
            if "X" in batch:
                h = batch["X"].shape[0] // 2
                batch = {k: torch.cat([v[:h], v[:h]]) for k, v in
                         batch.items()}
            return orig(self, params, batch)
        monkeypatch.setattr(cls, "log_p", log_p)
    orig_nn = BayesianNNModel.pallas_grads

    def pallas_grads(self):
        fn = orig_nn(self)

        def grads(theta, batch):
            h = batch["X"].shape[0] // 2
            return fn(theta, {k: torch.cat([v[:h], v[:h]])
                              for k, v in batch.items()})
        return grads
    monkeypatch.setattr(BayesianNNModel, "pallas_grads", pallas_grads)


def _altered_particle(monkeypatch):
    from stein_tpu_torch.utils import graphs
    orig = graphs.eager_steps

    def eager_steps(step, carry, n, feed):
        def altered(c, *a):
            new, aux = step(c, *a)
            st = new[0] if isinstance(new, tuple) else new
            theta = st.particles.clone()
            theta[0] = -theta[0]
            st = st._replace(particles=theta)
            return ((st, new[1]) if isinstance(new, tuple) else st), aux
        return orig(altered, carry, n, feed)
    monkeypatch.setattr(graphs, "eager_steps", eager_steps)


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "altered_particle": _altered_particle}
ONE_CARD = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", ONE_CARD)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    torch.set_num_threads(2)
    FAULTS[fault](monkeypatch)
    out = run.run_cell(tiny(name), args(name), torch.device("cpu"))
    assert out["correct"] is False, out["checks"]
    assert out["failed"] >= 1


def _mesh_rank(rank, port, fault, queue):
    torch.set_num_threads(1)
    if fault == "no_exchange":
        from stein_tpu_torch.parallel import collectives

        def all_gather(x, mesh, tiled=True, dim=0):
            parts = [x] * mesh.size
            return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)
        collectives.all_gather = all_gather
    else:
        FAULTS[fault](pytest.MonkeyPatch())
    name = "linreg-p64-suff.n8192-mesh4"
    out = run.run_cell(tiny(name), args(name), torch.device("cpu"), rank,
                       port)
    queue.put((rank, out))


@pytest.mark.parametrize("fault", ["no_exchange", "unchanged_state",
                                   "altered_particle"])
def test_a_broken_mesh_is_not_correct(fault):
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = run.free_port()
    procs = [ctx.Process(target=_mesh_rank, args=(r, port, fault, queue))
             for r in range(4)]
    for p in procs:
        p.start()
    got = dict(queue.get(timeout=600) for _ in procs)
    for p in procs:
        p.join(timeout=120)
        assert not p.is_alive()
    assert got[0]["correct"] is False, got[0]["checks"]


# ---------------------------------------------------------------- control

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control's TF32 runs there")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ONE_CARD)
def test_the_control_fails_and_the_program_passes(card, name, tmp_path):
    out = tmp_path / "r.jsonl"
    p = subprocess.run(
        [sys.executable, str(ROOT / "svgd_bench" / "readings.py"),
         "--workload", name, "--seeds", "7001,7002,7003", "--seconds", "1",
         "--out", str(out)], capture_output=True, text=True, timeout=900,
        cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    limits = spec.Cell(name).limits["limits"]
    for line in map(json.loads, out.read_text().splitlines()):
        assert all(line["program"][k] <= v for k, v in limits.items()), line
        assert any(line["control"][k] > v for k, v in limits.items()), line
