"""The step profile of one checkout of the port on the card, path by path,
for comparing two trees in turns on one card.

    python tests/cuda_profile_paths.py [--tree DIR] [--paths LABEL,...]

imports ``stein_tpu_torch`` and ``chip_smoke.py`` from DIR (default: this
checkout) and builds each path as chip_smoke.py builds it, from its data
and configurations: [main] (LR n=1000, p=128, fused_gram), [main-fused]
(step_impl='fused'), [large-n] (n=10240, the tile), [median-subsample] and
[median-binned] (large_particle.py's n=10240, p=64, kernel_impl='pallas'),
[mesh] (fused_shard 'rounds' on a one-process NCCL group) and [mesh2d]
(a 1x1 2-D mesh). For each it prints ``[paths] {...}`` (JSON): the graph
step's wall µs/step by CUDA events (whole 32-step chunks, after a call
of the same length that captures them), then under torch.profiler the
device µs/step, kernels a step, the busy share and the largest kernels.
The card's name and power limit lead.
Each tree runs in its own process; in turns, e.g. with the parent unpacked
under build/parent:

    for t in build/parent . . build/parent; do
        python3 tests/cuda_profile_paths.py --tree $t; done

Needs a card: without one it exits 2.
"""

import argparse
import json
import os
import sys

PATHS = ("main", "main-fused", "large-n", "median-subsample",
         "median-binned", "mesh", "mesh2d")
# Steps a reading: whole graph chunks (the n=10240 paths: fewer).
WALL_STEPS = {"large-n": 64, "median-subsample": 64, "median-binned": 64}
PROFILE_STEPS = {"large-n": 32, "median-subsample": 32,
                 "median-binned": 32}


def builders(cs, torch, dev):
    """{label: () -> (sampler, batch)} as chip_smoke.py builds each path."""
    import numpy as np
    import torch.distributed as dist

    from stein_tpu_torch import Adam, SVGDSampler, throughput_config
    from stein_tpu_torch.models import LinearRegressionModel

    f32 = torch.float32
    X, y, theta0 = cs.make_data()
    lin = LinearRegressionModel(cs.P)
    batch = {"X": torch.tensor(X, dtype=f32, device=dev),
             "y": torch.tensor(y, dtype=f32, device=dev)}

    def lr(n, theta, **kw):
        return SVGDSampler(n, lin.log_p, lin.template(), Adam(1e-1),
                           theta=theta, device="cuda", **kw), batch

    def median_path(**kw):
        Xm, ym, theta_m = cs.large_particle_data()
        model = LinearRegressionModel(cs.MED_P)
        b = {"X": torch.tensor(Xm, device=dev),
             "y": torch.tensor(ym, device=dev)}
        return SVGDSampler(cs.MED_N, model.log_p, model.template(),
                           Adam(1e-2), theta=theta_m, device="cuda",
                           kernel_impl="pallas", **kw), b

    meshes = {}

    def mesh(two_d):
        from stein_tpu_torch.parallel import (
            mesh_2d,
            particle_mesh,
            setup_distributed,
        )
        if not meshes:
            setup_distributed("nccl", store=dist.HashStore(), world_size=1,
                              rank=0, device_id=dev)
            meshes["1d"], meshes["2d"] = particle_mesh(), mesh_2d(1, 1)
        return meshes["2d" if two_d else "1d"]

    theta_n = np.random.default_rng(3).normal(size=(cs.LARGE_N, cs.P)) * 0.01
    return {
        "main": lambda: lr(cs.N, theta0, **throughput_config(cs.N, cs.P)),
        "main-fused": lambda: lr(cs.N, theta0, **dict(
            throughput_config(cs.N, cs.P), step_impl="fused")),
        "large-n": lambda: lr(cs.LARGE_N, theta_n,
                              **throughput_config(cs.LARGE_N, cs.P)),
        "median-subsample": lambda: median_path(
            median="subsample", median_max_rows=cs.MED_ROWS),
        "median-binned": lambda: median_path(median="binned"),
        "mesh": lambda: lr(cs.N, theta0, **throughput_config(
            cs.N, cs.P, mesh=mesh(False))),
        "mesh2d": lambda: lr(cs.N, theta0, **throughput_config(
            cs.N, cs.P, mesh=mesh(True), model_axis="model")),
    }


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--paths", default=",".join(PATHS))
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    import torch
    if not torch.cuda.is_available():
        print("cuda_profile_paths: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, tree)
    import chip_smoke as cs
    import stein_tpu_torch

    if not stein_tpu_torch.__file__.startswith(tree):
        raise RuntimeError(f"stein_tpu_torch came from "
                           f"{stein_tpu_torch.__file__}, not {tree}")
    from stein_tpu_torch import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _cuda.library()
    print(f"[paths] {cs.gpu_line()} | tree {tree}", flush=True)
    make = builders(cs, torch, dev)
    try:
        for label in args.paths.split(","):
            s, b = make[label]()

            def fn(k, s=s, b=b):
                s.run(b, k)
            steps = WALL_STEPS.get(label, 128)
            fn(steps)   # the chunk's capture, outside the timing
            wall = cs.run_timed(fn, torch, steps)
            prof_wall, rows = cs.profile_numbers(
                fn, PROFILE_STEPS.get(label, 64), torch)
            dev_us = sum(r[0] for r in rows)
            print("[paths] " + json.dumps({
                "tree": os.path.basename(tree) or tree, "path": label,
                "wall_us": wall, "device_us": dev_us,
                "busy": dev_us / wall if rows else None,
                "kernels_per_step": sum(r[2] for r in rows),
                "profiled_wall_us": prof_wall,
                "top": [[round(t, 2), k[:60], round(c, 2)]
                        for t, k, c in rows[:6]]}), flush=True)
            del s, b
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            from stein_tpu_torch.utils import graphs

            graphs.release()
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
