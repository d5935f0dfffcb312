"""The particle mesh across cards (BASELINE #5: particles sharded over
ranks, psum'd phi and bandwidth): the port's 4-card checks and
measurements in one command, one NCCL rank a card.

    python tests/cuda_mesh_cards.py [--world N] [--out DIR] [--cpu]

(--out defaults to build/mesh_cards/.)

In order, each under a limit of its own (a process past it is killed and
the command fails), each process's output in a log of its own under --out,
written as it runs:

1. tests/cuda_graph_ranks.py on N ranks with --timing: every mesh path's
   checks (i)-(iv) and timings; the ranks then free their graphs and
   destroy the process group (the teardown with destroy_process_group);
2. the same runner on one path with --teardown exit: no destroy, the
   graphs freed from atexit (the teardown at the interpreter's exit);
3. examples_torch/large_particle.py --mesh at its defaults (n=10240, p=64,
   1000 observations, 1500 iterations) under torchrun on N ranks, and as
   one process on one card (a one-process NCCL group), in turns (1, N, N,
   1): each run's particle-updates/s and posterior lines;
4. the crash-and-resume drill on meshL rounds (n=8192, p=64, fused_shard;
   tests/cuda_graph_ranks.py --recovery, three launches on fresh processes
   and fresh ports): a crash after the first checkpoint (rank 1 exits 17,
   the others 1 s later, graphs live, no destroy; the checkpoint must hold
   step 64), the relaunch that resumes (executed 192 on every rank, graphs
   replayed) and an uninterrupted run that the resumed state must equal
   bitwise (and, restored from the crash's checkpoint, rank 0's card alone
   at (iii)'s class over its 10 steps);
5. examples_torch/production_run.py --mesh under torchrun on N ranks, run
   through (--csv production_B.csv); then the same job stopped at
   --n-iters 1000 and relaunched with the defaults on one --csv
   (production_A.csv): the relaunch must report executed 2000 steps and a
   total of 3000, and its step lines and final KSD^2 line must equal the
   uninterrupted run's letter for letter, the CSV rows too (step,
   phi_norm, h2, log_p_mean: the other two columns are wall times).

Every process must exit as its step says (0; 17 for the drill's crash).
Prints a line a step and, last, ``[result] cards {...}`` (JSON). --cpu
rehearses the same on gloo CPU processes at small sizes (the CLIs with
--device cpu and 256 particles; production_run with 600 iterations, a
checkpoint every 200, stopped at 200; the drill at 256 particles).
"""

import argparse
import csv
import glob
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:   # run as a script from tests/
    sys.path.insert(0, ROOT)
RUNNER = os.path.join(HERE, "cuda_graph_ranks.py")
EXAMPLES = os.path.join(ROOT, "examples_torch")
# Limits in seconds: the runner's paths (104 s on 4 H100s with 64-step
# readings), its one-path exit check (36 s), each CLI run (23-31 s), each
# launch of the drill.
RANKS_LIMIT_S, EXIT_LIMIT_S, CLI_LIMIT_S = 600, 180, 300
DRILL_LIMIT_S = 240
EXIT_PATH = "fused_shard rounds"
# The drill's first checkpoint (cuda_graph_ranks.RECOVERY_EVERY).
DRILL_CKPT_STEP = 64
# The metrics CSV's columns that a resumed run must reproduce (the others
# are wall times).
CSV_SAME = ("step", "phi_norm", "h2", "log_p_mean")


def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_all(name, cmds, out_dir, limit, env=None):
    """Start every command of ``cmds`` at once (stdout and stderr to
    <out_dir>/<name>.<i>.log, unbuffered); kill those alive after
    ``limit`` s. Returns (return codes, None for a killed one; logs; s)."""
    logs = [os.path.join(out_dir, f"{name}.{i}.log") for i in range(len(cmds))]
    procs = []
    for cmd, path in zip(cmds, logs):
        with open(path, "w") as f:
            procs.append(subprocess.Popen(
                cmd, stdout=f, stderr=subprocess.STDOUT, cwd=ROOT,
                env=dict(os.environ if env is None else env,
                         PYTHONUNBUFFERED="1")))
    t0 = time.time()
    while any(p.poll() is None for p in procs) and time.time() - t0 < limit:
        time.sleep(0.5)
    rcs = []
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
            rcs.append(None)
        else:
            rcs.append(p.returncode)
    return rcs, [open(path).read() for path in logs], time.time() - t0


def ranks(world, extra, name, out_dir, limit, cpu):
    port = free_port()
    cmds = [[sys.executable, RUNNER, str(r), str(world), str(port), *extra]
            + (["--cpu"] if cpu else []) for r in range(world)]
    return run_all(name, cmds, out_dir, limit)


def cli(script, args, world, out_dir, name, cpu):
    """One CLI run: under torchrun on ``world`` processes, or (world 0) as
    one process (the one-process group on card 0)."""
    path = os.path.join(EXAMPLES, script)
    if world:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(world), path, *args]
    else:
        cmd = [sys.executable, path, *args]
    env = dict(os.environ)
    if not world and not cpu:
        env["CUDA_VISIBLE_DEVICES"] = env.get("CUDA_VISIBLE_DEVICES",
                                              "0").split(",")[0]
    return run_all(name, [cmd], out_dir, CLI_LIMIT_S, env)


def parse_large(out):
    """large_particle.py's lines: particle-updates/s and posterior."""
    m = re.search(r"(\d+) steps of n=(\d+) particles in ([\d.]+)s -> "
                  r"([\d.]+) steps/s, ([\d.]+)M particle-updates/s", out)
    post = re.search(r"posterior mean max-abs-err ([\d.e+-]+) \(MC err "
                     r"scale ([\d.e+-]+)\); var ratio \[([\d.]+), "
                     r"([\d.]+)\]", out)
    return {"steps_per_s": float(m.group(4)) if m else None,
            "updates_M_per_s": float(m.group(5)) if m else None,
            "posterior_mean_err": float(post.group(1)) if post else None,
            "var_ratio": [float(post.group(3)), float(post.group(4))]
            if post else None}


def lines(out, keep):
    """The lines of ``out`` that ``keep`` selects, each once (torchrun's
    ranks print the same lines)."""
    return "\n".join(dict.fromkeys(ln for ln in out.splitlines()
                                    if keep(ln)))


def checkpoint_step(path):
    """The step a checkpoint file holds (its '.step' leaf)."""
    import numpy as np

    with np.load(path) as f:
        paths = str(f["__meta__"][1]).split("|")
        return int(f[f"leaf_{paths.index('.step')}"])


def csv_rows(path):
    """The metrics CSV's rows, CSV_SAME's columns only."""
    with open(path, newline="") as f:
        return [tuple(row[k] for k in CSV_SAME) for row in csv.DictReader(f)]


# Where production_run.py's reports start: torchrun runs its workers
# unbuffered (python -u), so ranks that print the same line can run one
# rank's line into another's before either writes its newline.
REPORT_START = re.compile(
    r"(?<!\n)(?=step \d+: held-out|executed \d+ steps|final KSD\^2:)")


def unspliced(out):
    """``out`` with each of production_run.py's reports on a line of its
    own."""
    return REPORT_START.sub("\n", out)


def step_lines(out, after=0):
    """production_run.py's 'step N:' lines past step ``after``, each once."""
    return [ln for ln in dict.fromkeys(out.splitlines())
            if ln.startswith("step ") and int(ln.split()[1][:-1]) > after]


def gpu_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip().replace("\n", " | ")


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                   "mesh_cards"))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    world, cpu = args.world, args.cpu
    os.makedirs(args.out, exist_ok=True)
    result, failed = {"world": world}, []
    if not cpu:
        from stein_tpu_torch import _cuda

        result["gpus"] = gpu_line()
        print(f"[cards] {result['gpus']}", flush=True)
        t0 = time.time()
        _cuda.library()   # once, before the ranks load it
        print(f"[cards] kernel library ready in {time.time() - t0:.1f} s",
              flush=True)

    def step(name, rcs, outs, secs, show, ok=None):
        ok = all(rc == 0 for rc in rcs) if ok is None else ok
        print(f"[cards] {name}: return codes {rcs} in {secs:.1f} s"
              + ("" if ok else " FAILED"), flush=True)
        if not ok:
            failed.append(name)
            for i, out in enumerate(outs):
                print(f"--- {name} process {i}:\n{out[-3000:]}", flush=True)
        else:
            print(show(outs), flush=True)
        result[name] = {"rcs": rcs, "s": secs}

    rcs, outs, secs = ranks(world, ["--timing"], "ranks", args.out,
                            RANKS_LIMIT_S, cpu)
    step("ranks", rcs, outs, secs, lambda o: lines(
        o[0], lambda ln: not ln.startswith(("[ranks] rank", "USDT"))))
    line = [ln for ln in outs[0].splitlines()
            if ln.startswith("[result] ranks ")]
    if line:
        result["runner"] = json.loads(line[0][len("[result] ranks "):])
    rcs, outs, secs = ranks(world, ["--paths", EXIT_PATH, "--teardown",
                                    "exit"], "exit", args.out, EXIT_LIMIT_S,
                            cpu)
    step("exit", rcs, outs, secs,
         lambda o: f"[cards] {EXIT_PATH}: every rank exited 0 without "
                   "destroy_process_group")

    large = ["--mesh"] + (["--device", "cpu", "--n-particles", "256",
                           "--n-iters", "200"] if cpu else [])
    runs = {}
    for i, w in enumerate((0, world, world, 0)):
        name = f"large_particle_{w or 1}_{i}"
        rcs, outs, secs = cli("large_particle.py", large, w, args.out, name,
                              cpu)
        runs[name] = parse_large(outs[0])
        step(name, rcs, outs, secs, lambda o: lines(
            o[0], lambda ln: "particle-updates/s" in ln
            or "posterior" in ln))
    result["large_particle"] = runs
    one = [v for k, v in runs.items() if "_1_" in k]
    many = [v for k, v in runs.items() if f"_{world}_" in k]
    if all(r["steps_per_s"] for r in one + many):
        t1 = sum(1 / r["steps_per_s"] for r in one) / len(one)
        tw = sum(1 / r["steps_per_s"] for r in many) / len(many)
        result["large_particle_efficiency"] = t1 / (world * tw)
        print(f"[cards] large_particle: s/step 1 card {t1:.6g}, {world} "
              f"cards {tw:.6g}; strong-scaling efficiency t1 / ({world} "
              f"t{world}) = {t1 / (world * tw):.4f}", flush=True)

    drill = os.path.join(args.out, "meshL_drill.ckpt")
    for path in glob.glob(drill + "*"):
        os.unlink(path)
    rcs, outs, secs = ranks(world, ["--recovery", "crash", "--ckpt", drill],
                            "recovery_crash", args.out, DRILL_LIMIT_S, cpu)
    held = checkpoint_step(drill) if os.path.exists(drill) else None
    files = sorted(os.path.basename(p) for p in glob.glob(drill + "*"))
    if held is not None:   # kept for the whole run's (iii) from step 64
        shutil.copyfile(drill, f"{drill}.step{DRILL_CKPT_STEP}")
    step("recovery_crash", rcs, outs, secs, lambda o: lines(
        o[0], lambda ln: ln.startswith("[recovery]"))
        + f"\n[cards] the checkpoint holds step {held}; the files of the "
          f"drill: {files}",
        ok=(rcs == [17] * world and held == DRILL_CKPT_STEP
            and files == [os.path.basename(drill)]
            and not any("DID-NOT-CRASH" in o for o in outs)))
    for mode in ("resume", "whole"):
        rcs, outs, secs = ranks(world, ["--recovery", mode, "--ckpt", drill],
                                f"recovery_{mode}", args.out, DRILL_LIMIT_S,
                                cpu)
        step(f"recovery_{mode}", rcs, outs, secs, lambda o: lines(
            o[0], lambda ln: ln.startswith("[recovery]")))

    ckpt = os.path.join(args.out, "production.ckpt")
    csv_a, csv_b = (os.path.join(args.out, f"production_{x}.csv")
                    for x in "AB")
    prod = ["--mesh", "--ckpt", ckpt]
    total, stop = 3000, 1000
    if cpu:
        total, stop = 600, 200
        prod += ["--device", "cpu", "--n-iters", str(total), "--ckpt-every",
                 "200"]
    runs = {}
    for name, extra in (("production_run", ["--csv", csv_b]),
                        ("production_stopped", ["--n-iters", str(stop),
                                                "--csv", csv_a]),
                        ("production_resumed", ["--csv", csv_a])):
        if name != "production_resumed":   # a fresh job
            for path in (ckpt, extra[-1]):
                if os.path.exists(path):
                    os.unlink(path)
        rcs, outs, secs = cli("production_run.py", prod + extra, world,
                              args.out, name, cpu)
        runs[name] = unspliced(outs[0])
        step(name, rcs, outs, secs, lambda o: lines(
            o[0], lambda ln: ln.startswith(("step ", "executed",
                                            "final KSD"))))
    whole, resumed = runs["production_run"], runs["production_resumed"]
    same_lines = (step_lines(resumed) == step_lines(whole, stop)
                  and bool(step_lines(resumed)))
    ksd = [lines(o, lambda ln: ln.startswith("final KSD^2:"))
           for o in (resumed, whole)]
    same_ksd = ksd[0] == ksd[1] != ""
    counts = (f"executed {total - stop} steps" in resumed
              and f"total step count {total}" in resumed)
    rows = {x: csv_rows(p) if os.path.exists(p) else None
            for x, p in (("A", csv_a), ("B", csv_b))}
    same_rows = rows["A"] is not None and rows["A"] == rows["B"]
    ok = counts and same_lines and same_ksd and same_rows
    print(f"[cards] production_run stopped at {stop}, relaunched: executed "
          f"{total - stop} of {total} {counts}; its {len(step_lines(resumed))}"
          f" step lines equal the uninterrupted run's {same_lines}; final "
          f"KSD^2 line equal {same_ksd}; CSV rows ({', '.join(CSV_SAME)}) "
          f"{len(rows['A'] or [])} and {len(rows['B'] or [])}, equal "
          f"{same_rows}" + ("" if ok else " FAILED"), flush=True)
    result["production_resume"] = {"counts": counts, "lines": same_lines,
                                   "ksd": same_ksd, "csv": same_rows}
    if not ok:
        failed.append("production_resume")
    result["failed"] = failed
    print("[result] cards " + json.dumps(result), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
