"""Plain Bayesian neural-network regression (the reference's
examples/regression_neural_network model): a one-hidden-layer ReLU MLP
f -> H -> 1, Gamma(alpha, beta) priors on the weight precision
lambda = exp(log_lambda) and the noise precision gamma = exp(log_gamma)
(at the exp'd values, no Jacobian), N(0, lambda^-1/2) on every weight and
bias, a Gaussian likelihood of scale gamma^-1/2 rescaled by
n_train / n_batch, and the whole log-posterior divided by n_train.

A particle's p = f H + 2 H + 3 numbers are laid out as the parameter
structure's keys in sorted order: b_1 [H] | b_2 | log_gamma | log_lambda |
w_1 [f, H] | w_2 [H]. The gradient is autograd's, of the sum over
particles (the particles are independent)."""

import math

import torch

from svgd_bench.reference.svgd import mm

HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def log_p(theta, X, y, f, H, n_train, n_batch, alpha, beta):
    """log p of every particle row of ``theta`` [n, f H + 2 H + 3]."""
    b1 = theta[:, :H]
    b2 = theta[:, H]
    lg = theta[:, H + 1]
    ll = theta[:, H + 2]
    w1 = theta[:, H + 3:H + 3 + f * H].reshape(-1, f, H)
    w2 = theta[:, H + 3 + f * H:]
    lam, gam = torch.exp(ll), torch.exp(lg)
    h = torch.relu(mm(X, w1) + b1[:, None, :])                    # [n, B, H]
    pred = mm(h, w2[:, :, None])[:, :, 0] + b2[:, None]           # [n, B]
    r = y[None, :] - pred
    log_l = (-0.5 * gam * (r * r).sum(1)
             + X.shape[0] * (0.5 * lg - HALF_LOG_2PI))

    def gamma_lp(x, logx):
        return (alpha * math.log(beta) - math.lgamma(alpha)
                + (alpha - 1.0) * logx - beta * x)

    w_sq = ((w1 * w1).sum((1, 2)) + (w2 * w2).sum(1) + (b1 * b1).sum(1)
            + b2 * b2)
    n_w = f * H + 2 * H + 1
    prior_w = -0.5 * lam * w_sq + n_w * (0.5 * ll - HALF_LOG_2PI)
    return ((log_l * (n_train / n_batch) + gamma_lp(lam, ll)
             + gamma_lp(gam, lg) + prior_w) / n_train)


def grad_fn(data, n_feats, n_hidden, n_train, n_batch, prior_alpha,
            prior_beta):
    """theta [n, p] -> (log p [n], grads [n, p]) on ``data`` {"X" [B, f],
    "y" [B, 1]}."""
    X, y = data["X"], data["y"].reshape(-1)

    def fn(theta):
        with torch.enable_grad():
            t = theta.detach().requires_grad_()
            lp = log_p(t, X, y, n_feats, n_hidden, n_train, n_batch,
                       prior_alpha, prior_beta)
            g, = torch.autograd.grad(lp.sum(), t)
        return lp.detach(), g
    return fn
