"""The benchmark's plain reference (svgd_bench/reference/) against a frozen
copy of the NumPy oracle, on the CPU at small sizes, in float64."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from svgd_bench.reference import bnn, linreg, svgd  # noqa: E402
from svgd_bench.tests import numpy_svgd_frozen as oracle  # noqa: E402


def _lr_problem(n, p, N, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, p))
    y = X @ rng.normal(size=(p, 1)) + 0.3 * rng.normal(size=(N, 1))
    return X, y, rng.normal(size=(n, p)) * 0.01


@pytest.mark.parametrize("n,p,steps", [(7, 3, 4), (40, 5, 6), (64, 12, 3)])
def test_exact_median_steps_match_the_oracle(n, p, steps):
    X, y, theta0 = _lr_problem(n, p, 30, seed=n)
    grad_row = lambda w, _: (X.T @ (y - X @ w.reshape(-1, 1)) - w.reshape(
        -1, 1)).ravel()
    o = oracle.NumpySVGD(grad_row, theta0, oracle.NumpyAdam(0.1))
    data = {"X": torch.tensor(X), "y": torch.tensor(y)}
    s = svgd.Sampler(linreg.grad_fn(data), svgd.Adam(0.1), median="exact",
                     warm=False)
    theta = torch.tensor(theta0)
    opt = s.gd.init(theta)
    for _ in range(steps):
        o.train_on_batch(None)
        theta, opt, aux = s.step(theta, opt, 0.0)
        assert aux["h2"] == pytest.approx(o.last_h2, rel=1e-12)
    np.testing.assert_allclose(theta.numpy(), o.samples, rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("decay", [1.0, 0.999])
def test_adam_matches_the_oracle(decay):
    rng = np.random.default_rng(1)
    o = oracle.NumpyAdam(0.1, decay=decay)
    r = svgd.Adam(0.1, decay=decay)
    st = r.init(torch.zeros(4, 3, dtype=torch.float64))
    for _ in range(5):
        phi = rng.normal(size=(4, 3))
        want = o.update(phi)
        got, st = r.update(st, torch.tensor(phi))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-13)


@pytest.mark.parametrize("n,p", [(9, 2), (50, 4), (120, 6)])
def test_phi_matches_the_oracle(n, p):
    rng = np.random.default_rng(n)
    theta, grads = rng.normal(size=(n, p)), rng.normal(size=(n, p))
    want, h2 = oracle.compute_phi(theta, grads)
    got = svgd.phi(torch.tensor(theta), torch.tensor(grads), h2,
                   block_rows=16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("shape,hint,passes", [
    ((40, 300), 0.0, 30), ((40, 300), 0.0, 16), ((100, 2000), 0.0, 30),
    ((100, 2000), 1.0, 8), ((100, 2000), 3.0, 6), ((100, 2000), 0.2, 8)])
def test_search_brackets_the_median(shape, hint, passes):
    """The search ends on an interval holding the k-th smallest entry:
    its result lies within half that interval of the entry."""
    g = torch.Generator().manual_seed(shape[0])
    D = torch.rand(shape, generator=g, dtype=torch.float64) * 4.0
    total = D.numel()
    med = svgd.search_median(D, hint, passes)
    if hint <= 0 and total <= svgd.QUAD_MIN_TOTAL:
        exact = float(torch.quantile(D.reshape(-1), 0.5))
        assert med == pytest.approx(exact, abs=4.0 / 2 ** passes)
        return
    x_k = float(torch.kthvalue(D.reshape(-1), (total + 1) // 2).values)
    lo, hi = 0.0, float(D.max())
    for a, b in svgd.BRACKETS:
        if hint > 0 and ((D <= a * hint).sum() < (total + 1) // 2 <= (
                D <= b * hint).sum()):
            lo, hi = a * hint, b * hint
            break
    width = (hi - lo) / 4 ** ((passes + 1) // 2)
    assert abs(med - x_k) <= 0.5 * width * (1 + 1e-9)


def test_sufficient_form_equals_observations():
    X, y, theta = _lr_problem(20, 6, 50, seed=3)
    data = {"X": torch.tensor(X), "y": torch.tensor(y)}
    lp1, g1 = linreg.grad_fn(data)(torch.tensor(theta))
    lp2, g2 = linreg.grad_fn(data, "sufficient")(torch.tensor(theta))
    np.testing.assert_allclose(lp1, lp2, rtol=1e-10)
    np.testing.assert_allclose(g1, g2, rtol=1e-9, atol=1e-10)


def test_bnn_gradient_by_finite_differences():
    g = torch.Generator().manual_seed(0)
    f, H, B = 1, 7, 5
    p = f * H + 2 * H + 3
    X = torch.rand(B, f, generator=g, dtype=torch.float64)
    y = torch.randn(B, 1, generator=g, dtype=torch.float64)
    theta = 0.3 * torch.randn(3, p, generator=g, dtype=torch.float64)
    fn = bnn.grad_fn({"X": X, "y": y}, f, H, B, B, 1.0, 10.0)
    lp, grads = fn(theta)
    eps = 1e-6
    for j in range(p):
        e = torch.zeros(p, dtype=torch.float64)
        e[j] = eps
        fd = (fn(theta + e)[0] - fn(theta - e)[0]) / (2 * eps)
        np.testing.assert_allclose(grads[:, j], fd, rtol=1e-5, atol=1e-8)
    assert torch.isfinite(lp).all()
