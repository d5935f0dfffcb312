"""The per-call account of one benchmark cell on the card, from the port's
own spans (stein_tpu_torch/utils/profiling.py), rank by rank.

    python3 tests/cuda_call_spans.py --cell CELL [--seed N] [--calls 10]
        [--out DIR]

The cell's sampler is built as ``svgd_bench/run.py`` builds it
(``svgd_bench.problem``) and its graphs warmed by two calls. Then, on every
rank (a cell on more than one card starts ranks 1.. itself, one NCCL
process a card):

0. plain: ``--calls`` calls (each a ``run(batch, K)`` and its read) with
   no profiler running, on the host clock: the wall, the lead-in to the
   first replay, the launches and the drain, us a step;
1. cost: host us a call of the spans a call makes (an empty nest of them,
   the events and the memory_stats read included), under torch.profiler
   and without it;
2. one traced call: ``profiling.trace(DIR/CELL)`` around one
   ``run(batch, K)`` and its read (each rank its own trace file), then
   ``summary()``: the call's seed, prep, agree, replays and launches;
3. ``--calls`` calls under torch.profiler (no trace written): the same
   account over more calls, us a step, beside the host wall a step of the
   loop (the calls' reads included);
4. the stages: one call of the eager loop (``sampler._eager``) under
   torch.profiler, each kernel's device time by the stage span that
   launched it (svgd.grad, svgd.median, svgd.phi, svgd.update; "other"
   outside them) and by its layer (``svgd_bench/layers``), us a step.

Each rank prints one line "[spans] {json}" and writes it to
DIR/CELL.rank<r>.json. Run on a card; without one it exits 3."""

import argparse
import bisect
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from stein_tpu_torch.utils import profiling  # noqa: E402
from svgd_bench import problem, spec, trace  # noqa: E402

STAGES = ("svgd.grad", "svgd.median", "svgd.phi", "svgd.update")
PARTS = ("svgd.seed", "svgd.prep", "svgd.agree", "svgd.replays",
         "svgd.launch", "svgd.capture")


def nest(dev, k, launches, mesh):
    """The spans one graph call makes, around no work."""
    with profiling.annotate("svgd.run", dev, steps=k):
        with profiling.annotate("svgd.seed", dev):
            pass
        with profiling.annotate("svgd.prep", dev):
            if mesh:
                with profiling.annotate("svgd.agree"):
                    pass
        with profiling.annotate("svgd.replays", dev):
            for _ in range(launches):
                with profiling.annotate("svgd.launch"):
                    pass


def span_cost(dev, k, mesh, reps=2000):
    """Host us a call of the spans, with the profiler on and off; with it
    on, the us of each part a span may make: a record_function, a timing
    event, the allocator's count."""
    from torch.profiler import record_function

    launches = -(-k // 32)
    ev = torch.cuda.Event(enable_timing=True)
    stream = torch.cuda.current_stream(dev)

    def rf():
        with record_function("svgd.cost"):
            pass

    parts = {"nest": lambda: nest(dev, k, launches, mesh),
             "record_function": rf, "event": lambda: ev.record(stream),
             "allocs": lambda: profiling._device_allocs(dev)}
    out = {}
    for on in (False, True):
        torch.cuda.synchronize()
        if on:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
        for name, fn in parts.items():
            if name != "nest" and not on:
                continue
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            out[f"{name}_{'on' if on else 'off'}_us"] = (
                (time.perf_counter() - t0) / reps * 1e6)
        if on:
            prof.stop()
    profiling.reset()
    return out


def account(summary, steps):
    """us a step of each call span (device, and host), allocations a
    call."""
    spans = summary["spans"]
    run = spans["svgd.run"]
    out = {"calls": run["count"], "steps": run["steps"],
           "device_allocs_per_call": (
               None if summary["counters"]["device_allocs"] is None
               else summary["counters"]["device_allocs"] / run["count"])}
    for name in ("svgd.run",) + PARTS:
        s = spans.get(name)
        if s is None:
            continue
        out[name] = {"count": s["count"],
                     "host_us_per_step": s["host_s"] * 1e6 / steps,
                     "self_us_per_step": s["self_s"] * 1e6 / steps,
                     "device_us_per_step": (
                         None if s["device_s"] is None
                         else s["device_s"] * 1e6 / steps)}
    return out


def stage_of(event, by_id, ranges):
    """The stage span that launched a kernel: its launching op's
    enclosing spans, innermost first, else the stage's device range (the
    profiler's annotation of it on the card) that holds the kernel's
    start; "other" outside every stage."""
    op = by_id.get(getattr(event, "linked_correlation_id", 0))
    while op is not None:
        if op.name in STAGES:
            return op.name
        op = op.cpu_parent
    t = event.time_range.start
    i = bisect.bisect_right(ranges, (t, float("inf"))) - 1
    if i >= 0 and ranges[i][1] > t:
        return ranges[i][2]
    return "other"


def stage_split(events, steps):
    """{stage: {layer: device us a step}} of the kernels in ``events``."""
    from torch.autograd import DeviceType

    pats = trace.layer_patterns(ROOT / "svgd_bench")
    by_id = {e.id: e for e in events if e.device_type == DeviceType.CPU}
    ranges = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in events if e.device_type == DeviceType.CUDA
                    and e.name in STAGES)
    split = defaultdict(lambda: defaultdict(float))
    for e in events:
        if e.device_type != DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False) or e.name in STAGES:
            continue
        secs, _, _ = trace.classify([(e.name, 1.0, 1)], pats)
        layer = next(iter(secs), "unmatched")
        split[stage_of(e, by_id, ranges)][layer] += (
            (e.time_range.end - e.time_range.start) / steps)
    return {s: dict(v) for s, v in split.items()}


def read_call(sampler, batch, k):
    sampler.run(batch, k)["phi_norm"][-1].item()


class _Timed:
    """A captured graph whose replays note their host start and end."""

    def __init__(self, graph, marks):
        self.graph, self.marks = graph, marks

    def replay(self):
        t0 = time.perf_counter()
        self.graph.replay()
        self.marks.append((t0, time.perf_counter()))

    def reset(self):
        self.graph.reset()


def plain_calls(sampler, batch, k, calls):
    """``calls`` calls with no profiler running, on the host clock, us a
    step: the wall; the lead-in (the call's entry to its first replay: the
    seed and prep, which the card runs as the host queues them); the
    replays' launches; the drain (the last launch's end to the read's end:
    the card finishing the queued graphs)."""
    marks = []
    graphs = list(sampler._graphs.graphs.values())
    for g in graphs:
        g.graph = _Timed(g.graph, marks)
    lead = launch = drain = 0.0
    t_all = time.perf_counter()
    try:
        for _ in range(calls):
            del marks[:]
            t0 = time.perf_counter()
            read_call(sampler, batch, k)
            t1 = time.perf_counter()
            lead += marks[0][0] - t0
            launch += sum(b - a for a, b in marks)
            drain += t1 - marks[-1][1]
        wall = time.perf_counter() - t_all
    finally:
        for g in graphs:
            g.graph = g.graph.graph
    steps = calls * k
    return {name: v * 1e6 / steps for name, v in
            (("wall_us_per_step", wall), ("lead_in_us_per_step", lead),
             ("launch_us_per_step", launch), ("drain_us_per_step", drain))}


def run_rank(cell, args, rank, port):
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from stein_tpu_torch.utils.cache import enable_compilation_cache
    enable_compilation_cache(str(ROOT / "build" / "stein_tpu_torch"))
    mesh = None
    if cell.chips > 1:
        from stein_tpu_torch.parallel import (
            particle_mesh,
            setup_distributed,
        )
        setup_distributed("nccl", init_method=f"tcp://localhost:{port}",
                          world_size=cell.chips, rank=rank, device_id=dev)
        mesh = particle_mesh()
    k = int(cell.traffic["k"])
    prob = problem.build(cell, args.seed, dev, mesh)
    s, batch = prob.sampler, prob.batch
    read_call(s, batch, k)
    read_call(s, batch, k)
    torch.cuda.synchronize()
    out = {"cell": cell.name, "rank": rank, "k": k,
           "card": torch.cuda.get_device_name(dev)}

    def barrier():
        if mesh is not None:
            import torch.distributed as dist
            dist.barrier(group=mesh.group)
        torch.cuda.synchronize()

    barrier()
    out["plain"] = plain_calls(s, batch, k, args.calls)
    out["cost"] = span_cost(dev, k, mesh is not None)

    barrier()
    profiling.reset()
    with profiling.trace(str(Path(args.out) / cell.name)):
        read_call(s, batch, k)
    out["one_call"] = account(profiling.summary(), k)

    barrier()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        t0 = time.perf_counter()
        for _ in range(args.calls):
            read_call(s, batch, k)
        wall = time.perf_counter() - t0
    out["calls"] = account(profiling.summary(), args.calls * k)
    out["calls"]["wall_us_per_step"] = wall * 1e6 / (args.calls * k)

    barrier()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s._eager("run", batch, k)["phi_norm"][-1].item()
        torch.cuda.synchronize()
    out["stages"] = stage_split(prof.events(), k)
    profiling.reset()
    if mesh is not None:
        from stein_tpu_torch.utils import graphs
        import torch.distributed as dist
        del s, prob
        graphs.release()
        dist.barrier(group=mesh.group)
        dist.destroy_process_group()
    line = json.dumps(out)
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / f"{cell.name}.rank{rank}.json").write_text(line)
    print(f"[spans] {line}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--out", default=str(ROOT / "build" / "call_spans"))
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args(argv)
    cell = spec.Cell(args.cell)
    if torch.cuda.device_count() < cell.chips:
        print(f"cuda_call_spans: {args.cell} needs {cell.chips} cards",
              file=sys.stderr)
        return 3
    procs, port = [], args.port
    if cell.chips > 1 and args.rank is None:
        from stein_tpu_torch import _cuda
        from torch_mesh_runner import _free_port
        _cuda.library()    # built once, before the ranks start
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--cell",
             args.cell, "--seed", str(args.seed), "--calls",
             str(args.calls), "--out", args.out, "--rank", str(r),
             "--port", str(port)]) for r in range(1, cell.chips)]
    try:
        run_rank(cell, args, args.rank or 0, port)
    finally:
        codes = [p.wait(timeout=600) for p in procs]
    return 1 if any(codes) else 0


if __name__ == "__main__":
    sys.exit(main())
