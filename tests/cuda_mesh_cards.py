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
4. examples_torch/production_run.py --mesh under torchrun on N ranks.

Every process must exit 0. Prints a line a step and, last,
``[result] cards {...}`` (JSON). --cpu rehearses the same on gloo CPU
processes at small sizes (the CLIs with --device cpu and 256 particles).
"""

import argparse
import json
import os
import re
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
# readings), its one-path exit check (36 s), each CLI run (23-31 s).
RANKS_LIMIT_S, EXIT_LIMIT_S, CLI_LIMIT_S = 600, 180, 300
EXIT_PATH = "fused_shard rounds"


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

    def step(name, rcs, outs, secs, show):
        ok = all(rc == 0 for rc in rcs)
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

    prod = ["--mesh", "--ckpt", os.path.join(args.out, "production.ckpt")]
    if cpu:
        prod += ["--device", "cpu", "--n-iters", "600", "--ckpt-every",
                 "200"]
    if os.path.exists(prod[2]):
        os.unlink(prod[2])
    rcs, outs, secs = cli("production_run.py", prod, world, args.out,
                          "production_run", cpu)
    step("production_run", rcs, outs, secs, lambda o: lines(
        o[0], lambda ln: ln.startswith(("step ", "executed", "final KSD"))))
    result["failed"] = failed
    print("[result] cards " + json.dumps(result), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
