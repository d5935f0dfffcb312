"""A production-shaped SVGD run on the PyTorch port (counterpart of
examples/production_run.py): a crash-recoverable training loop with atomic
checkpoints, divergence detection, metrics logging, and a KSD convergence
report.

Kill it at any point and run it again: it resumes from the last checkpoint
and finishes with the identical trajectory (utils/recovery.py). With
--mesh the particles are sharded over the processes of the torchrun
environment (or a one-process group). tests/cuda_mesh_cards.py checks
that sentence under torchrun on 4 processes (NCCL on 4 cards, or gloo
with --cpu): a job stopped at --n-iters 1000 and relaunched with the
defaults on the same --ckpt and --csv executes 2000 steps to step 3000,
prints the uninterrupted run's step lines from step 1500 on and its final
KSD^2 line letter for letter, and leaves the same CSV rows (the two wall-
time columns aside); tests/test_torch_multihost.py runs the library's
crash drill on 2 gloo processes.

Run: python examples_torch/production_run.py [--mesh] [--ckpt PATH]
     [--device cpu]
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _common  # noqa: E402  (puts the repository on the path)

from stein_tpu_torch import Adam, SVGDSampler  # noqa: E402
from stein_tpu_torch.models import LogisticRegressionModel  # noqa: E402
from stein_tpu_torch.utils.metrics import MetricsLogger  # noqa: E402
from stein_tpu_torch.utils.recovery import train_with_recovery  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-iters", type=int, default=3000)
    ap.add_argument("--n-particles", type=int, default=128)
    ap.add_argument("--n-batch", type=int, default=64)
    ap.add_argument("--ckpt-every", type=int, default=500)
    ap.add_argument("--ckpt", type=str,
                    default=os.path.join(tempfile.gettempdir(),
                                         "svgd_production.ckpt"))
    ap.add_argument("--csv", type=str, default=None)
    ap.add_argument("--mesh", action="store_true",
                    help="shard the particles over the processes of the "
                         "torchrun environment (or a one-process group)")
    ap.add_argument("--seed", type=int, default=0)
    _common.add_device_flag(ap)
    args = ap.parse_args()
    device = _common.device_of(args.device)

    rng = np.random.default_rng(args.seed)
    n_data, n_feats = 20000, 54
    X = rng.normal(size=(n_data, n_feats))
    w_true = rng.normal(size=(n_feats, 1))
    y = (X @ w_true + rng.normal(size=(n_data, 1)) * 0.5 > 0).astype(float)
    n_test = n_data // 5
    X_train, y_train = X[n_test:], y[n_test:]
    X_test, y_test = X[:n_test], y[:n_test]
    n_train = X_train.shape[0]

    model = LogisticRegressionModel(n_feats, n_train, args.n_batch)
    with _common.mesh_context(args.mesh, device) as mesh:
        if mesh is not None:
            device = mesh.device

        def on_device(a):
            return torch.tensor(a, dtype=torch.float32, device=device)

        sampler = SVGDSampler(
            n_particles=args.n_particles, log_p=model.log_p,
            param_template=model.template(), gd=Adam(learning_rate=1e-1),
            generator=torch.Generator(device).manual_seed(args.seed),
            device=device, mesh=mesh,
        )
        X_t, y_t = on_device(X_train), on_device(y_train)

        def make_batches(start_step, k):
            # Deterministic in start_step, so a resumed run replays the
            # same minibatch sequence (bit-identical recovery).
            seq = np.random.default_rng(args.seed + 2 + start_step)
            idx = torch.from_numpy(np.stack([
                seq.choice(n_train, args.n_batch, replace=False)
                for _ in range(k)
            ])).to(device)
            return {"X": X_t[idx], "y": y_t[idx]}

        # Append to the CSV only when this invocation resumes from a
        # checkpoint (a fresh run with a stale CSV at the same path
        # truncates it). On a mesh the rank that writes the checkpoint
        # writes the CSV, once.
        resuming = os.path.exists(args.ckpt)
        writes = mesh is None or mesh.rank == 0
        metrics = MetricsLogger(log_every=0,
                                csv_path=args.csv if writes else None,
                                resume=resuming)
        test_batch = {"X": on_device(X_test), "y": on_device(y_test)}

        def on_checkpoint(step, aux):
            metrics.record(step, {k: v[-1] for k, v in aux.items()})
            logits = sampler.function_posterior(model.logits, test_batch)
            acc = np.mean((logits.mean(axis=0) > 0) == y_test.ravel())
            print(f"step {step}: held-out acc {acc:.4f}, "
                  f"phi_norm {metrics.history[-1]['phi_norm']:.3g}, "
                  f"checkpointed -> {args.ckpt}")

        t0 = time.time()
        executed = train_with_recovery(
            sampler, args.n_iters, make_batches, args.ckpt,
            ckpt_every=args.ckpt_every, on_checkpoint=on_checkpoint,
        )
        metrics.close()
        print(f"executed {executed} steps this invocation "
              f"({time.time() - t0:.1f}s); total step count "
              f"{int(sampler.state.step)}")
        # KSD against the trained-for target: log_p's n_train/n_batch
        # likelihood scaling assumes an n_batch-sized batch, so evaluate on
        # one.
        ksd_batch = {"X": X_t[:args.n_batch], "y": y_t[:args.n_batch]}
        print(f"final KSD^2: {sampler.ksd(ksd_batch):.4g}")


if __name__ == "__main__":
    main()
