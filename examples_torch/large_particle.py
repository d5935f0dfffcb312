"""Large-particle SVGD on the PyTorch port (counterpart of
examples/large_particle.py; BASELINE.json config #4): n=10240 particles on
one card, the streaming tile, an on-device median.

Bayesian linear regression is the target, so the posterior moments can be
checked against the conjugate closed form at this particle count:
posterior = N((X'X+I)^-1 X'y, (X'X+I)^-1).

Run: python examples_torch/large_particle.py [--n-particles 10240]
     [--kernel-impl pallas|xla] [--median bisect|subsample|binned|exact]
     [--device cpu]
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _common  # noqa: E402  (puts the repository on the path)

from stein_tpu_torch import Adam, SVGDSampler  # noqa: E402
from stein_tpu_torch.models import LinearRegressionModel  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-particles", type=int, default=10240)
    ap.add_argument("--n-feats", type=int, default=64)
    ap.add_argument("--n-obs", type=int, default=1000)
    ap.add_argument("--n-iters", type=int, default=1500)
    ap.add_argument("--chunk", type=int, default=100)
    ap.add_argument("--kernel-impl", type=str, default="pallas",
                    choices=["pallas", "xla"],
                    help="'pallas' = the streaming tile (kernel B3 on a "
                         "card), 'xla' = the dense K")
    ap.add_argument("--median", type=str, default="bisect",
                    choices=["bisect", "subsample", "binned", "exact"])
    ap.add_argument("--median-passes", type=int, default=16)
    ap.add_argument("--warm", action="store_true",
                    help="warm-started median across the steps of a run")
    ap.add_argument("--median-impl", type=str, default=None,
                    choices=["xla", "fused"],
                    help="'fused' = the whole bisect search in one kernel "
                         "(B2; bitwise-equal medians; default: fused "
                         "off-mesh, xla on a mesh)")
    ap.add_argument("--median-rows", type=int, default=None,
                    help="median row subsample (default: 128 at "
                         "n>=8192, else 512)")
    ap.add_argument("--mesh", action="store_true",
                    help="shard the particle axis over the processes of "
                         "the torchrun environment, or a one-process "
                         "group (kernel tiles, median counts and the clip "
                         "norm run as collectives; use --median bisect or "
                         "binned: the mesh step has no 'subsample' mode "
                         "and guards large-n 'exact')")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--precision", type=str, default="high",
                    choices=["high", "default", "highest"],
                    help="the model's precision field (the port's "
                         "matmuls are f32 at every setting)")
    _common.add_device_flag(ap)
    args = ap.parse_args()
    device = _common.device_of(args.device)

    rng = np.random.default_rng(args.seed)
    X = rng.normal(size=(args.n_obs, args.n_feats))
    w_true = rng.normal(size=(args.n_feats, 1))
    y = X @ w_true + rng.normal(size=(args.n_obs, 1)) * 0.5
    model = LinearRegressionModel(args.n_feats, precision=args.precision)

    median_impl = args.median_impl
    if median_impl is None:
        # One device: the single-kernel search; the mesh searches psum
        # across ranks and stay plain.
        median_impl = (
            "fused" if not args.mesh and args.median == "bisect" else "xla"
        )
    median_rows = args.median_rows
    if median_rows is None:
        median_rows = 128 if args.n_particles >= 8192 else 512

    with _common.mesh_context(args.mesh, device) as mesh:
        if mesh is not None:
            device = mesh.device
        batch = {"X": torch.tensor(X, dtype=torch.float32, device=device),
                 "y": torch.tensor(y, dtype=torch.float32, device=device)}
        sampler = SVGDSampler(
            n_particles=args.n_particles,
            log_p=model.log_p,
            param_template=model.template(),
            gd=Adam(learning_rate=1e-2),
            generator=torch.Generator(device).manual_seed(args.seed),
            device=device,
            kernel_impl=args.kernel_impl,
            median=args.median,
            median_passes=args.median_passes,
            median_max_rows=median_rows,
            warm_median=args.warm,
            median_impl=median_impl,
            mesh=mesh,
        )

        # The first chunk is the warm-up (kernel builds, allocations).
        sampler.run(batch, args.chunk)
        _common.sync(device)

        t0 = time.time()
        done = args.chunk
        while done + args.chunk <= args.n_iters:
            sampler.run(batch, args.chunk)
            done += args.chunk
        _common.sync(device)
        dt = time.time() - t0
        steps = done - args.chunk
        print(f"{steps} steps of n={args.n_particles} particles in "
              f"{dt:.2f}s -> {steps / dt:.1f} steps/s, "
              f"{args.n_particles * steps / dt / 1e6:.1f}M "
              f"particle-updates/s [{args.kernel_impl}/{args.median}"
              f"{f'/mesh{mesh.size}' if mesh is not None else ''}]")

        # Conjugate posterior check.
        A = X.T @ X + np.eye(args.n_feats)
        cov = np.linalg.inv(A)
        mean = (cov @ X.T @ y).ravel()
        s = sampler.samples
    mean_err = np.abs(s.mean(axis=0) - mean).max()
    mc = np.sqrt(np.diag(cov) / args.n_particles).max()
    var_ratio = (s.var(axis=0) / np.diag(cov))
    print(f"posterior mean max-abs-err {mean_err:.3e} "
          f"(MC err scale {mc:.3e}); var ratio "
          f"[{var_ratio.min():.3f}, {var_ratio.max():.3f}]")


if __name__ == "__main__":
    main()
