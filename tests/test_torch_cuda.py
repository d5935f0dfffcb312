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
from stein_tpu_torch.models import LinearRegressionModel
from stein_tpu_torch.ops import fused_median, fused_step
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
@pytest.mark.parametrize("n,p,rows", [(1000, 128, 256), (300, 40, 512)])
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
