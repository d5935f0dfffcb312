"""Bayesian neural-network regression via SVGD on the PyTorch port
(counterpart of examples/regression_neural_network.py; reference:
examples/regression_neural_network/main.py).

Same model and hyperparameters: 1 -> 100 -> 1 ReLU MLP, Gamma(1, 0.01)
priors on the weight precision lambda and the noise precision gamma,
N(0, lambda^-1/2) priors on the weights and biases, the log-posterior
rescaled by n_train/n_batch and divided by n_train; 20 particles, Adam
lr=1e-1 decay=0.999, 10000 iterations, the train MSE of the
particle-averaged prediction every 1000.

With the reference's hyperparameters this posterior has a degenerate
dominant mode: the Gamma(1, 0.01) ARD prior rewards lambda -> ~1e4 with
every weight shrunk to zero, so the particle-averaged prediction plateaus
near the data variance (see the JAX example's docstring). Use
--prior-beta 10 for a prior under which the fit mode wins.

Run: python examples_torch/regression_neural_network.py [--prior-beta 10]
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
from stein_tpu_torch.models import BayesianNNModel  # noqa: E402


def generate_data(seed=0, n=20):
    """y = cos(10x) * 5x + noise on x ~ U[0,1]
    (regression_neural_network/main.py:12-13)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, 1))
    y = rng.normal(np.cos(10 * X) * (5 * X), 0.1)
    return X, y


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-iters", type=int, default=10000)
    ap.add_argument("--n-particles", type=int, default=20)
    ap.add_argument("--n-hidden", type=int, default=100)
    ap.add_argument("--n-batch", type=int, default=20)
    ap.add_argument("--n-prog", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plot", type=str, default=None,
                    help="save the posterior-predictive figure to this path")
    ap.add_argument("--prior-beta", type=float, default=0.01,
                    help="rate of the Gamma precision priors; the reference "
                         "value 0.01 makes the ARD-collapse mode dominate "
                         "(see the module docstring); 10 lets the fit mode "
                         "win")
    ap.add_argument("--tuned", action="store_true",
                    help="splat throughput_config(n, p, model=) over the "
                         "sampler: at the default n=20 the fused_gram tail "
                         "(kernel B1), at n>=1000 the streaming tile (B3), "
                         "the in-kernel-Gram median (B5) and the model's "
                         "gradient kernel (B7); the default keeps the "
                         "reference-faithful step")
    _common.add_device_flag(ap)
    args = ap.parse_args()
    device = _common.device_of(args.device)

    X_train, y_train = generate_data(args.seed)
    n_train, n_feats = X_train.shape
    model = BayesianNNModel(
        n_feats, args.n_hidden, n_train, args.n_batch,
        prior_beta=args.prior_beta,
    )

    def on_device(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    full_batch = {"X": on_device(X_train), "y": on_device(y_train)}

    rng = np.random.default_rng(args.seed + 1)
    tuned_kw = {}
    if args.tuned:
        from stein_tpu_torch import throughput_config
        n_params = sum(leaf.numel() for leaf in model.template().values())
        tuned_kw = throughput_config(args.n_particles, n_params,
                                     model=model)
    sampler = SVGDSampler(
        n_particles=args.n_particles,
        log_p=model.log_p,
        param_template=model.template(),
        gd=Adam(learning_rate=1e-1, decay=0.999),
        generator=torch.Generator(device).manual_seed(args.seed),
        device=device,
        **tuned_kw,
    )

    start = time.time()
    # One sampler call per n_prog minibatch steps (the indices drawn first,
    # the batches gathered on the device).
    for i in range(0, args.n_iters, args.n_prog):
        y_hat = sampler.function_posterior(model.predict, full_batch)
        mse = np.mean((y_train.ravel() - y_hat.mean(axis=0)) ** 2)
        print(f"Iteration: {i}. Mean squared error: {mse:.4f}")
        k = min(args.n_prog, args.n_iters - i)
        idx = torch.from_numpy(np.stack([
            rng.choice(n_train, args.n_batch, replace=False)
            for _ in range(k)
        ])).to(device)
        sampler.train_on_batches({"X": full_batch["X"][idx],
                                  "y": full_batch["y"][idx]})

    y_hat = sampler.function_posterior(model.predict, full_batch)
    mse = np.mean((y_train.ravel() - y_hat.mean(axis=0)) ** 2)
    print(f"Final MSE: {mse:.4f}")
    print(f"Time elapsed: {time.time() - start:.2f}s")

    # Posterior predictive curves (regression_neural_network/main.py:
    # 104-112), saved, not shown.
    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        r = np.atleast_2d(np.linspace(0.0, 1.5, num=200)).T
        y_vis = sampler.function_posterior(model.predict,
                                           {"X": on_device(r)})
        plt.figure()
        plt.plot(X_train.ravel(), y_train.ravel(), "r.")
        for i in range(args.n_particles):
            plt.plot(r.ravel(), y_vis[i], "b-", alpha=0.3)
        plt.grid()
        plt.savefig(args.plot, dpi=120)
        print(f"Saved figure to {args.plot}")


if __name__ == "__main__":
    main()
