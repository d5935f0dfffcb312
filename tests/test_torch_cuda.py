"""The port's CUDA kernels against their plain PyTorch versions on an
NVIDIA card. Marked ``cuda``: without a card every test here skips (the
decision is made in the fixture, at run time). On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: this file needs torch and the port only, not the JAX
package's test configuration)."""

import numpy as np
import pytest
import torch

from stein_tpu_torch import Adagrad, Adam, SVGDSampler, throughput_config
from stein_tpu_torch.models import BayesianNNModel, LinearRegressionModel
from stein_tpu_torch.models import bayesian_nn
from stein_tpu_torch.ops import fused_median, fused_step, svgd_tile
from stein_tpu_torch.ops.median import row_subsample_block, subsample_rows
from stein_tpu_torch.ops.optimizers import AdagradState, AdamState

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("hint,passes", [(0.0, 30), (1.01, 8), (0.8, 8)])
def test_b2_bitwise_against_plain(dev, hint, passes):
    rng = np.random.default_rng(0)
    theta = torch.tensor(rng.normal(size=(1000, 32)), dtype=torch.float32,
                         device=dev)
    D = row_subsample_block(theta, 256)
    med0 = fused_median.warm_search_on_value(
        D, torch.zeros((), device=dev), 30)
    med_prev = med0 * hint
    got = fused_median.fused_warm_median_rows(D, med_prev, passes)
    want = fused_median.warm_search_on_value(D, med_prev, passes)
    assert got.item() == want.item()


@pytest.mark.parametrize("rule", ["adam", "adagrad"])
@pytest.mark.parametrize("n,p,rows", [(1000, 128, 256), (300, 40, 512),
                                     (300, 400, 512)])
def test_b1_against_plain_on_exact_d(dev, rule, n, p, rows):
    """Integer particles whose columns sum to 0: the centre, the Gram and
    D are exact in any summation order, so the median and h^2 are bitwise
    equal and the rest differs by the order of the K @ u sums only
    (max|a-b| / max|b| <= 1e-5)."""
    rng = np.random.default_rng(1)
    half = rng.integers(-3, 4, size=(n // 2, p))
    theta = torch.tensor(np.concatenate([half, -half]), dtype=torch.float32,
                         device=dev)
    grads = torch.tensor(rng.normal(size=(n, p)), dtype=torch.float32,
                         device=dev)
    nu = torch.ones(n, p, device=dev)
    count = torch.full((), 5, dtype=torch.int32, device=dev)
    lr = torch.full((), 0.1, device=dev)
    if rule == "adam":
        gd, state = Adam(1e-1, decay=0.99), AdamState(
            torch.zeros_like(nu), nu, count, lr)
    else:
        gd, state = Adagrad(5e-2), AdagradState(nu, count, lr)
    sub = subsample_rows(theta, rows)
    med_prev = fused_median.warm_search_on_value(
        row_subsample_block(theta, rows), torch.zeros((), device=dev), 30)
    k_theta, k_state, k_stats = fused_step.fused_warm_step_tail(
        theta, grads, None, None, med_prev, state, gd, gram_in_kernel=True,
        theta_sub=sub)
    p_theta, p_state, p_stats = fused_step._plain_tail(
        theta, grads, sub, med_prev, state, gd, 10.0, 8,
        fused_step.DEFAULT_BRACKETS)
    assert k_stats[0].item() == p_stats[0].item()
    assert k_stats[2].item() == p_stats[2].item()
    for a, b in zip([k_theta, *k_state, k_stats[1]],
                    [p_theta, *p_state, p_stats[1]]):
        a, b = a.double().cpu(), b.double().cpu()
        scale = max(b.abs().max().item(), 1e-30)
        assert (a - b).abs().max().item() / scale <= 1e-5


def test_sampler_runs_through_both_kernels(dev):
    rng = np.random.default_rng(0)
    X = torch.tensor(rng.normal(size=(200, 16)), dtype=torch.float32,
                     device=dev)
    y = X @ torch.ones(16, 1, device=dev)
    model = LinearRegressionModel(16)
    s = SVGDSampler(600, model.log_p, model.template(), Adam(1e-1),
                    theta=rng.normal(size=(600, 16)) * 0.1, device="cuda",
                    **throughput_config(600, 16))
    fused_median.fused_warm_median_rows.launches = 0
    fused_step.fused_warm_step_tail.launches = 0
    aux = s.run({"X": X, "y": y}, 5)
    torch.cuda.synchronize()
    assert fused_median.fused_warm_median_rows.launches == 1
    assert fused_step.fused_warm_step_tail.launches == 5
    assert all(torch.isfinite(v).all() for v in aux.values())
    assert np.isfinite(s.samples).all()


def _lattice(n, p, dev, seed=1):
    """Integer particles whose columns sum to 0: the centre, every norm and
    dot, and so D, are exact in any summation order."""
    half = np.random.default_rng(seed).integers(-3, 4, size=(n // 2, p))
    return torch.tensor(np.concatenate([half, -half]), dtype=torch.float32,
                        device=dev)


def _norm_err(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


@pytest.mark.parametrize("m,n,p,lattice", [
    (1000, 1000, 303, False), (1000, 1000, 303, True),
    (3000, 3000, 640, False), (200, 1000, 70, False),
    (500, 700, 1000, False), (400, 400, 1000, True),
])
def test_b3_against_plain(dev, m, n, p, lattice):
    """phi of the tile against its plain version: <= 1e-5 normalised on
    lattice particles, <= 1e-4 otherwise (f32 sums in other orders, D
    through exp2); two calls bitwise equal."""
    rng = np.random.default_rng(n + p)
    cols = (_lattice(n, p, dev) if lattice else torch.tensor(
        rng.normal(size=(n, p)), dtype=torch.float32, device=dev))
    rows = cols[:m] if m < n else cols
    grads = torch.tensor(rng.normal(size=(n, p)), dtype=torch.float32,
                         device=dev)
    D = fused_median.dist_block_plain(cols, cols,
                                      svgd_tile.column_center(cols))
    h2 = fused_median.warm_search_on_value(
        D, torch.zeros((), device=dev), 30) / np.log(n)
    c = svgd_tile.column_center(cols)
    got = svgd_tile.svgd_phi_rect(rows, cols, grads, h2)
    again = svgd_tile.svgd_phi_rect(rows, cols, grads, h2)
    ku, ks = svgd_tile.svgd_both_ksum_plain(rows, cols, grads, h2, c)
    want = (ku + ks * (rows - c) / h2) / n
    assert torch.equal(got, again)
    assert _norm_err(got, want) <= (1e-5 if lattice else 1e-4)
    ku_k, ks_k = svgd_tile.svgd_both_ksum(rows, cols, grads, h2, c)
    assert _norm_err(ku_k, ku) <= (1e-5 if lattice else 1e-4)
    assert _norm_err(ks_k, ks) <= (1e-5 if lattice else 1e-4)


@pytest.mark.parametrize("lattice", [True, False])
def test_b4_against_plain(dev, lattice):
    """The [128, 3000] block at p=303: bitwise on lattice particles,
    <= 1e-5 normalised otherwise."""
    n, p = 3000, 303
    theta = (_lattice(n, p, dev) if lattice else torch.tensor(
        np.random.default_rng(2).normal(size=(n, p)) + 2.0,
        dtype=torch.float32, device=dev))
    rows = subsample_rows(theta, 128)
    c = svgd_tile.column_center(theta)
    got = fused_median.dist_block(rows, theta, c)
    want = fused_median.dist_block_plain(rows, theta, c)
    if lattice:
        assert torch.equal(got, want)
    else:
        assert _norm_err(got, want) <= 1e-5


@pytest.mark.parametrize("lattice", [True, False])
def test_b5_against_plain(dev, lattice):
    """Gram and warm search in one launch at (128, 1000, 303): bitwise on
    lattice particles; otherwise within one final interval of the tight
    bracket, (1.09 - 0.92) hint / 4^4."""
    n, p = 1000, 303
    theta = (_lattice(n, p, dev) if lattice else torch.tensor(
        np.random.default_rng(3).normal(size=(n, p)) * 0.01,
        dtype=torch.float32, device=dev))
    rows = subsample_rows(theta, 128)
    c = svgd_tile.column_center(theta)
    zero = torch.zeros((), device=dev)
    for hint, passes in ((None, 30), (1.01, 8)):
        cold = fused_median.fused_warm_median_from_theta(rows, theta, zero,
                                                         c, passes)
        med_prev = zero if hint is None else cold * hint
        got = fused_median.fused_warm_median_from_theta(rows, theta,
                                                        med_prev, c, passes)
        want = fused_median.warm_search_on_value(
            fused_median.dist_block_plain(rows, theta, c), med_prev, passes)
        if lattice:
            assert got.item() == want.item()
        elif hint is not None:
            width = (1.09 - 0.92) * med_prev.item() / 4 ** 4
            assert abs(got.item() - want.item()) <= width * 1.0001


@pytest.mark.parametrize("n,B,f,H", [(1000, 20, 1, 100), (600, 12, 3, 50)])
def test_b7_against_plain(dev, n, B, f, H):
    """logp rtol 2e-5 / atol 1e-5, grads atol 2e-5 max|g| (the JAX suite's
    test_pallas_grads_match_autodiff)."""
    rng = np.random.default_rng(0)
    model = BayesianNNModel(f, H, n_train=5 * B, n_batch=B, prior_beta=10.0)
    p = f * H + 2 * H + 3
    theta = torch.tensor(rng.normal(size=(n, p)) * 0.3, dtype=torch.float32,
                         device=dev)
    X = rng.uniform(size=(B, f))
    y = np.cos(10 * X[:, :1]) * (5 * X[:, :1]) + rng.normal(size=(B, 1)) * .1
    batch = {"X": torch.tensor(X, dtype=torch.float32, device=dev),
             "y": torch.tensor(y, dtype=torch.float32, device=dev)}
    launches = bayesian_nn.nn_grads.launches
    lp, g = model.pallas_grads()(theta, batch)
    assert bayesian_nn.nn_grads.launches == launches + 1
    lp_ref, g_ref = bayesian_nn.nn_grads_plain(
        theta, batch["X"], batch["y"].reshape(-1), f, H, model._consts())
    torch.testing.assert_close(lp, lp_ref, rtol=2e-5, atol=1e-5)
    scale = g_ref.abs().max().item()
    torch.testing.assert_close(g, g_ref, rtol=0, atol=2e-5 * scale)


def test_nn_sampler_runs_through_its_kernels(dev):
    rng = np.random.default_rng(11)
    X = rng.uniform(size=(20, 1))
    y = rng.normal(np.cos(10 * X) * (5 * X), 0.1)
    model = BayesianNNModel(1, 100, 20, 20, prior_beta=10.0)
    s = SVGDSampler(1000, model.log_p, model.template(), Adam(0.1),
                    theta=rng.normal(size=(1000, 303)) * 0.01,
                    device="cuda", **throughput_config(1000, 303,
                                                       model=model))
    counts = (bayesian_nn.nn_grads, svgd_tile.svgd_both_ksum,
              fused_median.fused_warm_median_from_theta)
    for fn in counts:
        fn.launches = 0
    aux = s.run({"X": torch.tensor(X, dtype=torch.float32, device=dev),
                 "y": torch.tensor(y, dtype=torch.float32, device=dev)}, 5)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counts] == [5, 5, 6]
    assert all(torch.isfinite(v).all() for v in aux.values())
