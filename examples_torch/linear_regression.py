"""Bayesian linear regression via SVGD on the PyTorch port (counterpart of
examples/linear_regression.py; reference: examples/linear_regression/
main.py).

Same model and hyperparameters: N(0,1) prior on weights, unit-variance
Gaussian likelihood, 50 particles, Adam lr=1e-1, 500 full-batch iterations,
on data generated from a fixed numpy seed (X ~ N(0,1) [1000 x 1],
w ~ 5 N(0,1), y ~ N(Xw, 0.3)), or the reference's CSV layout.

Run: python examples_torch/linear_regression.py [--device cpu]
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


def generate_data(seed=0, n=1000, k=1):
    rng = np.random.default_rng(seed)
    data_X = rng.normal(size=(n, k))
    data_w = rng.normal(size=(k, 1)) * 5.0
    data_y = rng.normal(data_X @ data_w, 0.3)
    return data_X, data_w, data_y


def load_csv_data(data_dir):
    """Load the reference's CSV layout (examples/linear_regression/data):
    data_X.csv, data_w.csv, data_y.csv."""
    data_X = np.loadtxt(os.path.join(data_dir, "data_X.csv"), delimiter=",")
    if data_X.ndim == 1:
        data_X = np.atleast_2d(data_X).T
    data_w = np.atleast_2d(
        np.loadtxt(os.path.join(data_dir, "data_w.csv"), delimiter=",")
    ).T
    data_y = np.atleast_2d(
        np.loadtxt(os.path.join(data_dir, "data_y.csv"), delimiter=",")
    ).T
    return data_X, data_w, data_y


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-iters", type=int, default=500)
    ap.add_argument("--n-particles", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-dir", type=str, default=None,
                    help="load the reference's CSV data layout instead of "
                         "generating")
    ap.add_argument("--plot", type=str, default=None,
                    help="save the posterior-lines figure (the reference "
                         "example's visualisation) to this path")
    ap.add_argument("--sufficient-stats", action="store_true",
                    help="precompute X^T X / X^T y once (exact algebra); "
                         "the per-step likelihood cost drops from "
                         "O(n_obs p) to O(p^2)")
    ap.add_argument("--precision", type=str, default="high",
                    choices=["high", "default", "highest"],
                    help="the model's precision field (the JAX package's "
                         "data-matmul precision; the port's matmuls are "
                         "f32 at every setting)")
    _common.add_device_flag(ap)
    args = ap.parse_args()
    device = _common.device_of(args.device)

    if args.data_dir:
        data_X, data_w, data_y = load_csv_data(args.data_dir)
    else:
        data_X, data_w, data_y = generate_data(args.seed)
    n_samples, n_feats = data_X.shape
    model = LinearRegressionModel(n_feats, precision=args.precision)
    batch = {"X": torch.tensor(data_X, dtype=torch.float32, device=device),
             "y": torch.tensor(data_y, dtype=torch.float32, device=device)}
    if args.sufficient_stats:
        batch = model.sufficient_batch(batch)

    start_time = time.time()
    sampler = SVGDSampler(
        n_particles=args.n_particles,
        log_p=model.log_p,
        param_template=model.template(),
        gd=Adam(learning_rate=1e-1),
        generator=torch.Generator(device).manual_seed(args.seed),
        device=device,
    )
    chunk = 100
    for i in range(0, args.n_iters, chunk):
        t0 = time.time()
        k = min(chunk, args.n_iters - i)
        sampler.run(batch, k)
        _common.sync(device)
        dt = time.time() - t0
        print(f"Iterations {i}-{i + k - 1}: {dt:.4f}s "
              f"({dt / k * 1e3:.3f} ms/iter)")

    est = sampler.theta["w"].mean(dim=0).reshape(-1).cpu().numpy()
    print(f"True coefficients: {data_w.ravel()}")
    print(f"Est. coefficients: {est}")
    print(f"Time elapsed: {time.time() - start_time:.2f}s")

    # Closed-form conjugate posterior for reference.
    A = data_X.T @ data_X + np.eye(n_feats)
    post_mean = np.linalg.solve(A, data_X.T @ data_y).ravel()
    print(f"Conjugate posterior mean: {post_mean}")

    # Posterior-lines visualisation (linear_regression/main.py:57-68),
    # saved, not shown.
    if args.plot and n_feats != 1:
        print(f"--plot ignored: the posterior-lines figure needs 1 "
              f"feature, data has {n_feats}")
    if args.plot and n_feats == 1:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        r = np.atleast_2d(np.linspace(-4.0, 4.0, num=100)).T
        W = sampler.theta["w"].cpu().numpy()[:, :, 0]        # [n_part, 1]
        Y = (r @ W.T).T                                      # [n_part, 100]
        plt.figure(figsize=(8, 6))
        plt.plot(data_X.ravel(), data_y.ravel(), "r.", alpha=0.3)
        for i in range(args.n_particles):
            plt.plot(r.ravel(), Y[i], "b-", alpha=0.1)
        plt.grid()
        plt.xlim((-4.0, 4.0))
        plt.savefig(args.plot, dpi=120)
        print(f"Saved figure to {args.plot}")


if __name__ == "__main__":
    main()
