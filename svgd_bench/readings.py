"""The readings each limit of limits/<cell>.json is set from, for many
seeds in one process (one process a card on a mesh):

    python3 svgd_bench/readings.py --workload CELL --seeds 11,12,... \
        [--seconds 2] [--out FILE]

For every seed: a run's set-up, a short window at the cell's load and the
check's numbers for the program (what run.py's check reads), then for the
control, the plain reference in float32 with TF32 matmuls put in the
program's place on the same states. A limit lies above the program's
largest reading and below the control's smallest. Prints one JSON line a
seed and writes them all to --out. Needs the cell's cards; the benchmark's
own runs never run this."""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from svgd_bench import check, run, spec  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args(argv)
    cell = spec.Cell(args.workload)
    import torch
    import torch.distributed as dist

    if torch.cuda.device_count() < cell.chips:
        print("readings: not enough cards", file=sys.stderr)
        return 3
    rank = args.rank or 0
    procs, port = [], args.port
    if cell.chips > 1 and args.rank is None:
        from stein_tpu_torch import _cuda
        _cuda.library()
        port = run.free_port()
        import subprocess
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--workload", args.workload,
             "--seeds", args.seeds, "--seconds", str(args.seconds),
             "--rank", str(r), "--port", str(port)], stdout=sys.stderr)
            for r in range(1, cell.chips)]
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    mesh = None
    if cell.chips > 1:
        from stein_tpu_torch.parallel import particle_mesh, setup_distributed
        setup_distributed("nccl", init_method=f"tcp://localhost:{port}",
                          world_size=cell.chips, rank=rank, device_id=device)
        mesh = particle_mesh()
    lines = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        a = run.parse(["--workload", args.workload, "--seed", str(seed),
                       "--seconds", str(args.seconds)])
        kept = {}
        out = run.run_cell(cell, a, device, rank, mesh=mesh, kept_out=kept)
        if rank != 0:
            continue
        ctl = check.control_records(cell, kept["prob"], kept["records"],
                                    kept["keywords"], kept["n"])
        per_call = check.read_calls(cell, kept["prob"], ctl,
                                    kept["keywords"], kept["n"])
        control = {k: max(g[k] for g in per_call) for k in per_call[0]}
        prog_calls = check.read_calls(cell, kept["prob"], kept["records"],
                                      kept["keywords"], kept["n"])
        line = {"seed": seed, "program": {k: v["value"] for k, v in
                                          out["checks"].items()},
                "control": control, "calls": out["attempted"],
                "per_call": [
                    {"count": r["count"], "lr": r["lr"], "program": g,
                     "control": c, "phi_norm": r["phi_norm"]}
                    for r, g, c in zip(kept["records"], prog_calls,
                                       per_call)],
                "updates_per_s": out["metrics"].get(
                    "updates_per_s", {}).get("value")}
        lines.append(line)
        print(json.dumps(line), flush=True)
        del kept, ctl
        torch.cuda.empty_cache()
    if mesh is not None:
        dist.destroy_process_group()
    for p in procs:
        p.wait(timeout=600)
    if rank == 0 and args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
