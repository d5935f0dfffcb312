"""The bin count's parts on one card, timed apart, for each checkout given
(this one by default; another version of the kernel, such as the
repository's parent unpacked under build/, compares with it in one call):

    python tests/cuda_bin_count_parts.py [--tree DIR ...] [--reps N]
                                         [--out DIR]

Each tree runs in a process of its own (the package is imported from it),
the trees in turns, forward then back. Every reading is device µs a
launch (chip_smoke.device_us: the launches queued behind a spin kernel,
timed by CUDA events around them). chip_smoke.py's [timing] takes the
kernel at the binned paths' levels on every run; this script takes what
it does not:

  launch     an ordinary one-block kernel (torch's add_ on 4 floats): the
             card's own floor for a launch, beside the count's;
  floor      the count of a [1, 4] block at 1 bin: its launch, barrier
             and conversion with nothing to count;
  tail       the same at 4096 bins, one window and two: zeroing, flushing
             and converting the bins;
  pass       each path's block at 1 bin: the read, with every entry in a
             register count;
  level 1/2  the same block at the first level's interval and at a second
             level's, one window and two (chip_smoke's readings, for the
             trees compared).

Each block's counts are checked bitwise against the plain version's first.
Prints one line a reading and, last, one JSON object of every tree's
readings, also written to <out>/bin_count_parts.json (--out defaults to
build/bin_count_parts/).
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# (rows, columns, p): the binned paths' blocks at 4096 bins. [median-binned]
# (large_particle.py's n=10240, p=64, 256-row blocks); the one-process
# gathered mesh step (n=1000, p=128); the ring's rotation on one rank and
# on 4.
SHAPES = ((256, 10240, 64), (256, 1000, 128), (1000, 1000, 128),
          (250, 250, 128))
N_BINS = 4096


def readings(reps):
    """{name: device µs} of this process's stein_tpu_torch on the card."""
    import torch

    from chip_smoke import device_us
    from stein_tpu_torch.ops import median

    dev = torch.device("cuda")
    out = {}

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    x = torch.zeros(4, device=dev)
    out["launch: torch add_ on [4]"] = device_us(lambda: x.add_(1.0), reps,
                                                 torch)
    G1, r1, c1 = (torch.zeros(1, 4, device=dev), torch.zeros(1, device=dev),
                  torch.zeros(4, device=dev))
    win = (f32(-1.0), f32(0.5))
    for name, wins, nb in (("floor, 1 bin", [win], 1),
                           ("tail, 4096 bins", [win], N_BINS),
                           ("tail, 4096 bins, two windows", [win, win],
                            N_BINS)):
        out[name] = device_us(
            lambda wins=wins, nb=nb: median.bin_count(G1, r1, c1, wins, nb),
            reps, torch)

    rng = np.random.default_rng(3)
    for rows, cols, p in SHAPES:
        theta = torch.tensor(rng.normal(size=(cols, p)) * 0.01,
                             dtype=torch.float32, device=dev)
        rsq = torch.sum(theta * theta, dim=1)
        r = rsq[-rows:]
        G = torch.matmul(theta[-rows:], theta.T)
        D = median._sq_dists_from_gram(G, r, rsq)
        lo0, hi0 = median._binned_range(torch.max(rsq), torch.float32)
        w0 = (hi0 - lo0) / N_BINS
        # The two middle ranks' first-level bins, each refined by N_BINS.
        flat = D.reshape(-1).double()
        k = flat.numel()
        second = []
        for rank in ((k + 1) // 2, k // 2 + 1):
            b = torch.floor((torch.kthvalue(flat, rank).values.float()
                             - lo0) / w0)
            second.append((lo0 + b * w0, w0 / N_BINS))
        cases = {"pass, 1 bin": ([(lo0, hi0 - lo0)], 1),
                 "level 1": ([(lo0, w0)], N_BINS),
                 "level 2": (second[:1], N_BINS),
                 "level 2, two windows": (second, N_BINS)}
        for name, (wins, nb) in cases.items():
            got = median.bin_count(G, r, rsq, wins, nb)
            if not torch.equal(got, median._gram_bin_counts(G, r, rsq, wins,
                                                            nb)):
                raise RuntimeError(f"[{rows}, {cols}] {name}: the counts "
                                   "are not the plain version's")
            out[f"[{rows}, {cols}] {name}"] = device_us(
                lambda wins=wins, nb=nb: median.bin_count(G, r, rsq, wins,
                                                          nb), reps, torch)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=None)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                   "bin_count_parts"))
    ap.add_argument("--one", help=argparse.SUPPRESS)   # a tree's process
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("cuda_bin_count_parts: no CUDA device", file=sys.stderr)
        return 2
    if args.one:
        sys.path[:0] = [os.path.abspath(args.one), ROOT]
        print(json.dumps(readings(args.reps)))
        return 0
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    trees = [os.path.abspath(t) for t in (args.tree or [ROOT])]
    runs = []
    for tree in trees + trees[::-1]:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", tree,
             "--reps", str(args.reps)], capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            return proc.returncode
        us = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append({"tree": tree, "us": us})
        for name, v in us.items():
            print(f"[parts] {os.path.basename(tree)} {gpu}: {name}: {v} us",
                  flush=True)
    out = {"card": gpu, "runs": runs}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "bin_count_parts.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
