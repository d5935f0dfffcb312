"""SVGD on a 2-D Gaussian mixture, on the PyTorch port (counterpart of
examples/gaussian_mixture.py): the multimodality demo.

The repulsive term spreads the particles across separated modes in
proportion to their mass. This samples a K-component 2-D mixture and
reports each mode's mass and mean error, and the KSD.

Run: python examples_torch/gaussian_mixture.py [--n-particles 200]
     [--weights 0.5,0.3,0.2] [--plot mixture.png] [--device cpu]
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _common  # noqa: E402  (puts the repository on the path)

from stein_tpu_torch import Adam, SVGDSampler  # noqa: E402


def make_mixture(weights, spread=4.0, sigma=0.6, device="cpu"):
    """Equally-spaced modes on a circle of radius ``spread``."""
    k = len(weights)
    ang = 2 * np.pi * np.arange(k) / k
    mus = spread * np.stack([np.cos(ang), np.sin(ang)], axis=1)  # [k, 2]
    log_w = torch.tensor(np.log(np.asarray(weights)), dtype=torch.float32,
                         device=device)
    mus_t = torch.tensor(mus, dtype=torch.float32, device=device)
    inv2s2 = 1.0 / (2.0 * sigma * sigma)

    def log_p(params, batch):
        x = params["x"]                                   # [2]
        d2 = torch.sum((mus_t - x) ** 2, dim=1)           # [k]
        return torch.logsumexp(log_w - d2 * inv2s2, dim=0)

    return log_p, mus, sigma


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-particles", type=int, default=200)
    ap.add_argument("--n-iters", type=int, default=2000)
    ap.add_argument("--weights", type=str, default="0.5,0.3,0.2")
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plot", type=str, default=None)
    _common.add_device_flag(ap)
    args = ap.parse_args()
    device = _common.device_of(args.device)

    weights = [float(w) for w in args.weights.split(",")]
    weights = [w / sum(weights) for w in weights]
    log_p, mus, sigma = make_mixture(weights, device=device)

    sampler = SVGDSampler(
        n_particles=args.n_particles,
        log_p=log_p,
        param_template={"x": torch.zeros(2)},
        gd=Adam(learning_rate=args.lr),
        generator=torch.Generator(device).manual_seed(args.seed),
        device=device,
    )
    # The 0.01 N(0, I) init sits between the modes; the repulsive term must
    # push the particles out to all of them.
    sampler.run(batch=None, n_steps=args.n_iters)
    s = sampler.samples                                   # [n, 2]

    # Assign each particle to its nearest mode.
    d2 = ((s[:, None, :] - mus[None, :, :]) ** 2).sum(-1)  # [n, k]
    assign = d2.argmin(axis=1)
    print(f"KSD^2: {sampler.ksd(None):.4g}")
    max_mass_err = 0.0
    for k, (w, mu) in enumerate(zip(weights, mus)):
        mask = assign == k
        mass = mask.mean()
        mean_err = (np.abs(s[mask].mean(axis=0) - mu).max()
                    if mask.any() else float("inf"))
        max_mass_err = max(max_mass_err, abs(mass - w))
        print(f"mode {k}: true mass {w:.3f}, particle mass {mass:.3f}, "
              f"mean err {mean_err:.3f}")
    print(f"max mass error: {max_mass_err:.4f}")

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        g = np.linspace(-7, 7, 200)
        GX, GY = np.meshgrid(g, g)
        P = sum(
            w * np.exp(-((GX - m[0]) ** 2 + (GY - m[1]) ** 2)
                       / (2 * sigma ** 2))
            for w, m in zip(weights, mus)
        )
        plt.figure(figsize=(6, 6))
        plt.contour(GX, GY, P, levels=8, alpha=0.5)
        plt.plot(s[:, 0], s[:, 1], "b.", ms=4, alpha=0.6)
        plt.savefig(args.plot, dpi=120)
        print(f"Saved figure to {args.plot}")


if __name__ == "__main__":
    main()
