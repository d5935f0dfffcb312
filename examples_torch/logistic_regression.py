"""Hierarchical Bayesian logistic regression via SVGD on the PyTorch port
(counterpart of examples/logistic_regression.py; reference:
examples/logistic_regression/main.py).

Same model and hyperparameters: Gamma(1, 0.01) prior on the precision
alpha, N(0, alpha^-1/2) prior on the weights, sigmoid-CE likelihood
rescaled by n_train/n_batch; 100 particles, Adam lr=1e-1, minibatch 50,
held-out accuracy of the particle-averaged logits every 100 iterations. By
default the data are synthetic at Covertype's width (54 features, binary
labels); --data loads a covertype.mat with the reference's semantics.

Run: python examples_torch/logistic_regression.py [--n-iters 6000]
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
from stein_tpu_torch.models import LogisticRegressionModel  # noqa: E402


def generate_data(seed=0, n=20000, n_feats=54):
    """Synthetic binary classification at Covertype's feature width."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, n_feats))
    w_true = rng.normal(size=(n_feats, 1))
    logits = X @ w_true + rng.normal(size=(n, 1)) * 0.5
    y = (logits > 0).astype(np.float64)
    return X, y


def load_covertype(path):
    """Load the reference's covertype.mat with its semantics (reference:
    examples/logistic_regression/main.py:11-13): the 'covtype' matrix's
    first column is the label (2 relabelled to 0), the rest are features.
    The file is not in the reference repository; supply a copy via
    --data."""
    from scipy import io
    data = io.loadmat(path)["covtype"]
    X, y = data[:, 1:], data[:, :1].astype(np.float64)
    y[y == 2] = 0.0
    return X, y


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-iters", type=int, default=6000)
    ap.add_argument("--n-particles", type=int, default=100)
    ap.add_argument("--n-batch", type=int, default=50)
    ap.add_argument("--n-prog", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-data", type=int, default=20000,
                    help="dataset rows (581012 = true Covertype scale)")
    ap.add_argument("--data", type=str, default=None,
                    help="path to covertype.mat: loads the real Covertype "
                         "dataset with the reference's semantics "
                         "(logistic_regression/main.py:11-16) instead of "
                         "synthetic data")
    ap.add_argument("--on-device-sampling", action="store_true",
                    help="draw the minibatch indices on the device "
                         "(sampler.train_minibatched): the dataset stays "
                         "resident and no host RNG runs in the loop")
    ap.add_argument("--precision", type=str, default="high",
                    choices=["high", "default", "highest"],
                    help="the model's precision field (the port's "
                         "matmuls are f32 at every setting)")
    ap.add_argument("--step-impl", type=str, default="xla",
                    choices=["xla", "fused_gram", "fused_model"],
                    help="'xla' (default) = the reference-faithful f32 "
                         "path; 'fused_gram' = the step tail as kernel B1; "
                         "'fused_model' = B1 with the logistic gradients "
                         "in its model stage "
                         "(LogisticRegressionModel.inkernel_model)")
    _common.add_device_flag(ap)
    args = ap.parse_args()
    device = _common.device_of(args.device)

    if args.data:
        X, y = load_covertype(args.data)
    else:
        X, y = generate_data(args.seed, n=args.n_data)
    n_total = X.shape[0]
    # Shuffled 80/20 train/test split (the reference's
    # train_test_split(test_size=0.2), main.py:14-16, seeded here).
    rng = np.random.default_rng(args.seed + 1)
    perm = rng.permutation(n_total)
    n_test = n_total // 5
    test_idx, train_idx = perm[:n_test], perm[n_test:]
    X_train, y_train = X[train_idx], y[train_idx]
    X_test, y_test = X[test_idx], y[test_idx]
    n_train, n_feats = X_train.shape

    model = LogisticRegressionModel(n_feats, n_train, args.n_batch,
                                    precision=args.precision)

    def on_device(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    test_batch = {"X": on_device(X_test), "y": on_device(y_test)}

    fused_kw = {}
    if args.step_impl != "xla":
        # The fused steps carry the warm bisect median through the run.
        fused_kw = dict(step_impl=args.step_impl, median="bisect",
                        warm_median=True, median_impl="fused")
        if args.step_impl == "fused_model":
            fused_kw["inkernel_model"] = model.inkernel_model
    sampler = SVGDSampler(
        n_particles=args.n_particles,
        log_p=model.log_p,
        param_template=model.template(),
        gd=Adam(learning_rate=1e-1),
        generator=torch.Generator(device).manual_seed(args.seed),
        device=device,
        **fused_kw,
    )

    def evaluate():
        # Particle-averaged logits thresholded at 0, as the reference's
        # evaluate() does (logistic_regression/main.py:52-61).
        logits_pred = sampler.function_posterior(model.logits, test_batch)
        avg_pred = logits_pred.mean(axis=0) > 0.0
        return np.mean(avg_pred == y_test.ravel())

    start = time.time()
    # One sampler call per n_prog minibatch steps: the index matrix is
    # drawn first and the batches gathered on the device
    # (sampler.train_on_batches).
    train_data = {"X": on_device(X_train), "y": on_device(y_train)}
    key = torch.Generator(device).manual_seed(args.seed + 2)
    for i in range(0, args.n_iters, args.n_prog):
        acc = evaluate()
        print(f"Iteration {i} / {args.n_iters}: {acc:4f}")
        k = min(args.n_prog, args.n_iters - i)
        if args.on_device_sampling:
            sampler.train_minibatched(train_data, k, args.n_batch, key)
        else:
            idx = torch.from_numpy(np.stack([
                rng.choice(n_train, args.n_batch, replace=False)
                for _ in range(k)
            ])).to(device)
            sampler.train_on_batches({"X": train_data["X"][idx],
                                      "y": train_data["y"][idx]})
    print(f"Final accuracy: {evaluate():4f}")
    print(f"Time elapsed: {time.time() - start:.2f}s")


if __name__ == "__main__":
    main()
