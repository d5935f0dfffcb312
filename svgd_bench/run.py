"""One run of one cell of the port's benchmark (stein_tpu_torch on NVIDIA
cards).

    python3 svgd_bench/run.py --workload CELL --seed N --seconds S --trace 0|1

The cell is a workload of BENCHMARK.json; its configuration, traffic mix
and limits are files under svgd_bench/ found by their names. The run
builds the port's sampler over data and particles drawn from the seed on
the card, warms up the cell's own K-step graphs, then measures a closed
loop of ``SVGDSampler.run(batch, K)`` calls for S seconds (see window.py).
With ``--trace 1`` a shorter window runs under torch.profiler and the
per-layer metrics are read from it (trace.py, metrics/). Every run ends by
judging the calls it kept against the plain reference (check.py) and
prints, as the last line of standard output, one JSON object:
correct, attempted, failed, metrics, device[, breakdown], checks.

A cell on more than one card starts its other ranks itself, one process
a card (NCCL), and rank 0 prints the line. Without the cards the cell
asks for, the run exits with code 3 and prints no result."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Every cache a run may write lives at a fixed path inside the checkout.
_CACHE = ROOT / "build" / "svgd_bench"
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = str(_CACHE / _sub)
sys.path.insert(0, str(ROOT))

from svgd_bench import check, guard, spec, window  # noqa: E402

# Seconds of the traced window: per-layer metrics carry no bound, and the
# profiler's record of a second of replays takes tens of seconds to read.
TRACE_SECONDS = 1.0


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def log(msg):
    print(f"svgd_bench: {msg}", file=sys.stderr, flush=True)


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def gather_call(call, mesh, start=None):
    """A kept call as the judge reads it: the whole state it started from
    (every rank's block gathered on a mesh), or ``start``'s for the run's
    first call, and its aux as numbers."""
    import torch

    def whole(t):
        if mesh is None:
            return t
        import torch.distributed as dist

        out = torch.empty((t.shape[0] * mesh.size,) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t.contiguous(), group=mesh.group)
        return out

    st = call.before
    if start is None:
        rec = {"theta": whole(st.particles), "mu": whole(st.opt_state.mu),
               "nu": whole(st.opt_state.nu),
               "count": int(st.opt_state.count),
               "lr": float(st.opt_state.learning_rate)}
    else:
        rec = dict(start)
    rec["steps_done"] = int(call.count_after) - rec["count"]
    for name in ("median", "phi_norm", "log_p_mean"):
        rec[name] = [float(v) for v in call.aux[name].double().cpu()]
    return rec


def run_cell(cell, args, device, rank=0, port=None, mesh=None,
             kept_out=None):
    """Build, warm up, measure, judge. Returns the result dict on rank 0
    (None on the others). ``device`` is the card, or the CPU in the tests,
    which run the port's plain versions there. A cell on more than one
    card joins the group at ``port``, or uses ``mesh`` and leaves its group
    standing. ``kept_out`` (a dict) receives what the judge read, for
    readings.py's control."""
    import torch

    from svgd_bench import problem, trace as tr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        from stein_tpu_torch.utils.cache import enable_compilation_cache
        enable_compilation_cache(str(ROOT / "build" / "stein_tpu_torch"))
    own_group = cell.chips > 1 and mesh is None
    if own_group:
        from stein_tpu_torch.parallel import particle_mesh, setup_distributed
        setup_distributed("nccl" if cuda else "gloo",
                          init_method=f"tcp://localhost:{port}",
                          world_size=cell.chips, rank=rank,
                          device_id=device if cuda else None)
        mesh = particle_mesh()
    k = int(cell.traffic["k"])
    prob = problem.build(cell, args.seed, device, mesh)
    sampler, batch = prob.sampler, prob.batch

    # The run's first call, from the seed's particles: the start of the
    # check. A second call replays the graphs the first captured.
    before = sampler.state
    aux = sampler.run(batch, k)
    aux["phi_norm"][-1].item()
    first = window.keep_call(before, aux, sampler.state, check.FOLLOW)
    sampler.run(batch, k)["phi_norm"][-1].item()
    banned = guard.banned_modules()
    if banned:
        raise RuntimeError(f"modules of JAX or the JAX package loaded: "
                           f"{banned}")
    if args.trace and cuda:
        tr.profile(lambda: sampler.run(batch, k)["phi_norm"][-1].item())

    def agree(done):
        if mesh is None:
            return done
        import torch.distributed as dist
        flag = torch.tensor([int(done)], device=device)
        dist.broadcast(flag, 0, group=mesh.group)
        return bool(flag.item())

    def barrier():
        if mesh is not None:
            import torch.distributed as dist
            dist.barrier(group=mesh.group)
        if cuda:
            torch.cuda.synchronize(device)

    barrier()
    setup_s = time.perf_counter() - T_START
    traced = None
    if args.trace:
        box = {}

        def traced_window():
            box["out"] = window.closed_loop(
                sampler, batch, k, min(TRACE_SECONDS, args.seconds),
                args.seed, check.FOLLOW, check.KEEP, agree)
            return box["out"][0] * k

        if cuda and rank == 0:
            traced = tr.profile(traced_window)
        else:
            traced_window()
        calls, window_s, kept = box["out"]
    else:
        calls, window_s, kept = window.closed_loop(
            sampler, batch, k, args.seconds, args.seed, check.FOLLOW,
            check.KEEP, agree)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if mesh is not None:
        import torch.distributed as dist
        t = torch.tensor([peak], dtype=torch.int64, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
        peak = int(t.item())

    start = {"theta": prob.theta0, "mu": torch.zeros_like(prob.theta0),
             "nu": torch.zeros_like(prob.theta0), "count": 0,
             "lr": float(cell.config["optimizer"]["learning_rate"])}
    records = [gather_call(first, mesh, start)]
    records += [gather_call(c, mesh) for c in kept]
    n = int(cell.traffic["n"])
    p = int(prob.theta0.shape[1])
    kw = prob.keywords
    del sampler, prob.sampler, before, aux, first, kept
    if mesh is not None:
        from stein_tpu_torch.utils import graphs
        import torch.distributed as dist
        graphs.release()
        dist.barrier(group=mesh.group)
        if own_group:
            dist.destroy_process_group()
    if rank != 0:
        return None
    if cuda:
        torch.cuda.empty_cache()

    result = judge(cell, prob, records, kw, n)
    if kept_out is not None:
        kept_out.update(records=records, prob=prob, keywords=kw, n=n)
    metrics = {}
    if traced is not None:
        metrics = layer_metrics(cell, traced, n, p, kw, prob.kind)
    elif not args.trace:
        metrics = {"updates_per_s": {"value": n * k * calls / window_s,
                                     "unit": "updates/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": result["correct"], "attempted": calls,
           "failed": result["failed"], "metrics": metrics, "device": dev}
    if traced is not None:
        dev.update(busy_s=traced.busy_s, window_s=traced.window_s)
        out["breakdown"] = traced.breakdown()
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in result["rows"]}
    return out


def judge(cell, prob, records, kw, n):
    """The reference's verdict on the kept calls: {correct, failed, rows,
    readings}."""
    per_call = check.read_calls(cell, prob, records, kw, n)
    worst = {name: max((g[name] for g in per_call),
                       key=lambda v: (v != v, v)) for name in per_call[0]}
    limits = cell.limits["limits"]
    failed = sum(not check.verdict(g, limits)[0] for g in per_call)
    correct, rows_out = check.verdict(worst, limits)
    return {"correct": correct, "failed": failed, "rows": rows_out,
            "readings": worst}


def layer_metrics(cell, traced, n, p, kw, kind, bench_dir=BENCH_DIR):
    """The cell's per-layer metrics from the trace, each by its reader
    metrics/<name>.py; a reader that finds nothing returns None and its
    metric is left out."""
    import importlib.util

    from svgd_bench import flops, trace as tr

    pats = tr.layer_patterns(bench_dir)
    layer_s, layer_n, unmatched = tr.classify(traced.kernels, pats)
    for name, s in unmatched:
        log(f"kernel in no layer: {name[:160]} {s * 1e6:.1f} us")
    chips = cell.chips
    rows = n // chips
    med_rows = len(check.median_rows(n, kw["median_max_rows"], chips)) // chips
    ctx = SimpleNamespace(
        trace=traced, steps=traced.steps, layer_s=layer_s, layer_n=layer_n,
        n=n, p=p, rows=rows, chips=chips, flops=flops,
        phi_ops=flops.phi_ops(rows, n, p), phi_bytes=flops.phi_bytes(rows, n, p),
        step_ops=(flops.phi_ops(rows, n, p) + flops.median_ops(med_rows, n, p)
                  + kind.grad_ops(cell.config, rows)))
    out = {}
    for m in cell.metrics(trace=True):
        path = Path(bench_dir) / "metrics" / f"{m['name']}.py"
        s = importlib.util.spec_from_file_location(
            f"svgd_bench_metric_{m['name']}", path)
        mod = importlib.util.module_from_spec(s)
        s.loader.exec_module(mod)
        v = mod.read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def power_limit():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def launch_ranks(args, chips, port):
    """Ranks 1.. as child processes of this one (rank 0)."""
    procs = []
    for r in range(1, chips):
        cmd = [sys.executable, str(Path(__file__).resolve()),
               "--workload", args.workload, "--seed", str(args.seed),
               "--seconds", str(args.seconds), "--trace", str(args.trace),
               "--rank", str(r), "--port", str(port)]
        procs.append(subprocess.Popen(cmd, stdout=sys.stderr))
    return procs


def main(argv=None):
    args = parse(argv)
    cell = spec.Cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs on the card")
        return 3
    if torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} asks for {cell.chips} cards, "
            f"{torch.cuda.device_count()} present")
        return 3
    rank = args.rank or 0
    procs = []
    port = args.port
    if cell.chips > 1 and args.rank is None:
        from stein_tpu_torch import _cuda
        _cuda.library()    # built once, before the ranks start
        port = free_port()
        procs = launch_ranks(args, cell.chips, port)
    try:
        out = run_cell(cell, args, torch.device("cuda", rank), rank, port)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    finally:
        codes = [p.wait(timeout=300) for p in procs]
    if rank != 0:
        return 0
    if any(codes):
        log(f"a rank failed: exit codes {codes}")
        return 1
    banned = guard.banned_modules()
    if banned:
        log(f"modules of JAX or the JAX package loaded: {banned}")
        return 1
    log(f"card: {power_limit()}; peak TF32 495 TFLOP/s (rooflines)")
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
