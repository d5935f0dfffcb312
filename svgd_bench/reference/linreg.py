"""Plain Bayesian linear regression (the reference's
examples/linear_regression model): an N(0, 1) prior on the weights w [p]
and a unit-variance Gaussian likelihood,

    log p(w) = -0.5 ||X w - y||^2 - 0.5 ||w||^2 - (p / 2) log(2 pi),
    grad     = X^T (y - X w) - w.

``form="sufficient"`` evaluates the same posterior through A = X^T X,
b = X^T y and y^T y, which it works out again from X and y."""

import math

from svgd_bench.reference.svgd import mm


def grad_fn(data, form="observations"):
    """theta [n, p] -> (log p [n], grads [n, p]) on ``data`` {"X" [N, p],
    "y" [N, 1]}, in the dtype of X."""
    X, y = data["X"], data["y"]
    p = X.shape[1]
    const = -0.5 * p * math.log(2.0 * math.pi)
    if form == "sufficient":
        A, b, yty = mm(X.T, X), mm(X.T, y)[:, 0], float((y * y).sum())

        def fn(theta):
            Aw = mm(theta, A)
            log_l = -0.5 * ((theta * Aw).sum(1) - 2.0 * mm(theta, b) + yty)
            return (log_l - 0.5 * (theta * theta).sum(1) + const,
                    b[None, :] - Aw - theta)
        return fn
    if form != "observations":
        raise ValueError(f"unknown data form {form!r}")

    def fn(theta):
        r = y - mm(X, theta.T)                    # [N, n]
        return (-0.5 * (r * r).sum(0) - 0.5 * (theta * theta).sum(1) + const,
                mm(r.T, X) - theta)
    return fn
