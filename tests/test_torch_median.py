"""The port's medians (stein_tpu_torch/ops/median.py, fused_median.py)
against the JAX package's on the same numpy inputs, in f32.

Searches on the same D block are held BITWISE (integer counts, order-free
min/max, the same scalar expression tree). Where each package computes D
itself from theta, the Gram's summation order differs, so the median is
held to rtol 1e-5 instead."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stein_tpu.ops import median as jmed
from stein_tpu.ops import pallas_median as jpm
from stein_tpu_torch.ops import fused_median as tfm
from stein_tpu_torch.ops import median as tmed


def _sq_dists(rows, cols):
    d = ((rows[:, None, :].astype(np.float64)
          - cols[None, :, :].astype(np.float64)) ** 2).sum(-1)
    return d.astype(np.float32)


def _block(m, n, p=6, seed=0):
    rng = np.random.default_rng(seed)
    theta = rng.normal(size=(n, p)).astype(np.float32)
    return _sq_dists(theta[:: max(n // m, 1)][:m], theta)


@pytest.mark.parametrize("shape", [(9, 9), (10, 10), (7, 12)])
def test_exact_median_matches_jnp(shape):
    D = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    got = tmed.exact_median(torch.from_numpy(D)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmed.exact_median(
        jnp.asarray(D))))


@pytest.mark.parametrize("n,max_rows", [(40, 512), (600, 512), (512, 256)])
def test_bisect_median_on_D_bitwise(n, max_rows):
    """Binary (< 100k entries) and quad-ary regimes, same D."""
    D = _block(n, n, seed=n)
    got = tmed.bisect_median_on_D(torch.from_numpy(D), max_rows=max_rows)
    want = jmed.bisect_median_on_D(jnp.asarray(D), max_rows=max_rows)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [40, 600])
def test_bisect_median_from_theta(n):
    theta = np.random.default_rng(n).normal(size=(n, 5)).astype(np.float32)
    got = tmed.bisect_median(torch.from_numpy(theta), max_rows=512)
    want = jmed.bisect_median(jnp.asarray(theta), max_rows=512)
    # rtol 1e-5: the two Grams sum in different orders (f32 both).
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


# med_prev as a multiple of the block's median: 0 is the cold search, ~1
# verifies the tight bracket, 0.8 the mid, 0.5 the wide, 3 none (fallback).
HINTS = [0.0, 1.0001, 0.8, 0.5, 3.0]


def _bracket_index(D, med_prev):
    """Which bracket select_bracket picks (len = full-range fallback)."""
    k = (D.size + 1) // 2
    for i, (lo, hi) in enumerate(jmed.DEFAULT_BRACKETS):
        a, b = np.float32(lo) * med_prev, np.float32(hi) * med_prev
        if med_prev > 0 and (D <= a).sum() < k <= (D <= b).sum():
            return i
    return len(jmed.DEFAULT_BRACKETS)


@pytest.mark.parametrize("hint", HINTS)
def test_warm_search_bitwise(hint):
    D = _block(64, 2000)
    med_prev = np.float32(np.median(D) * hint)
    got = tmed._warm_search(torch.from_numpy(D),
                            torch.tensor(med_prev), 8)
    want = jmed._warm_search(jnp.asarray(D), jnp.float32(med_prev), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_warm_search_hints_cover_every_bracket():
    D = _block(64, 2000)
    picked = {_bracket_index(D, np.float32(np.median(D) * h)) for h in HINTS}
    assert picked == {0, 1, 2, 3}


@pytest.mark.parametrize("hint,passes", [(0.0, 30), (0.0, 8), (1.0001, 8),
                                         (0.8, 6)])
def test_fused_warm_median_rows_bitwise(hint, passes):
    """Kernel B2's plain version against the JAX kernel in interpret mode
    on the same [256, 512] block (> 100k entries: the kernel's regime)."""
    D = _block(256, 512)
    med_prev = np.float32(np.median(D) * hint)
    got = tfm.fused_warm_median_rows(torch.from_numpy(D),
                                     torch.tensor(med_prev),
                                     warm_passes=passes)
    want = jpm.fused_warm_median_rows(jnp.asarray(D), jnp.float32(med_prev),
                                      warm_passes=passes, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fused_warm_median_rows_guards():
    huge = torch.zeros(1, 1).expand(2 ** 16, 2 ** 15)   # 2^31 entries
    with pytest.raises(ValueError, match="int32"):
        tfm.fused_warm_median_rows(huge, 0.0)
    with pytest.raises(TypeError, match="f32"):
        tfm.fused_warm_median_rows(torch.zeros(400, 400,
                                               dtype=torch.float64), 0.0)


@pytest.mark.parametrize("m,n", [(256, 390), (256, 391), (128, 24576),
                                 (512, 8192), (2 ** 16, 2 ** 15)])
def test_fused_block_ok_matches_jax(m, n):
    assert tfm.fused_block_ok(m, n) == jpm.fused_block_ok(m, n)


@pytest.mark.parametrize("n,max_rows", [(1000, 256), (512, 256), (100, 512)])
def test_subsample_rows_match_jax(n, max_rows):
    theta = np.random.default_rng(0).normal(size=(n, 3)).astype(np.float32)
    got = tmed.subsample_rows(torch.from_numpy(theta), max_rows)
    want = jmed.subsample_rows(jnp.asarray(theta), max_rows)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        blk = tmed.row_subsample_block(torch.from_numpy(theta), max_rows)
        assert tuple(blk.shape) == (max_rows, n)


@pytest.mark.parametrize("hint", [0.0, 1.0001])
def test_warm_bisect_median_matches_jax(hint):
    theta = np.random.default_rng(3).normal(size=(600, 5)).astype(np.float32)
    D = _sq_dists(theta, theta)
    med_prev = np.float32(np.median(D) * hint)
    got = tmed.warm_bisect_median_on_D(torch.from_numpy(D),
                                       torch.tensor(med_prev), max_rows=256)
    want = jmed.warm_bisect_median_on_D(jnp.asarray(D), jnp.float32(med_prev),
                                        max_rows=256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = tmed.warm_bisect_median(torch.from_numpy(theta),
                                  torch.tensor(med_prev), max_rows=256)
    want = jmed.warm_bisect_median(jnp.asarray(theta), jnp.float32(med_prev),
                                   max_rows=256)
    # rtol 1e-5: each package computes its own Gram here.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("m,n,p", [(128, 1000, 303), (128, 2829, 303),
                                   (128, 2830, 303), (128, 3000, 640),
                                   (512, 600, 8)])
def test_bracket_pass_fits_matches_jax(m, n, p):
    assert tfm.bracket_pass_fits(m, n, p) == jpm.bracket_pass_fits(m, n, p)


@pytest.mark.parametrize("hint", [0.0, 1.0001])
def test_warm_median_from_theta_matches_jax(hint):
    """Kernel B5's plain version against JAX's fused_warm_median_from_theta
    in interpret mode (tests/test_pallas_median.py's off-origin input),
    rtol 1e-5: the two Grams sum in other orders."""
    rng = np.random.default_rng(0)
    n, p, m = 600, 8, 512
    theta = (rng.normal(size=(n, p)) * 0.7 + 3.0).astype(np.float32)
    rows = theta[jmed._subsample_idx(n, m)] if n > m else theta
    center = theta.mean(0, keepdims=True)
    cold = jpm.fused_warm_median_from_theta(
        jnp.asarray(rows), jnp.asarray(theta), jnp.float32(0.0),
        jnp.asarray(center), warm_passes=16, interpret=True)
    med_prev = np.float32(float(cold) * hint)
    want = jpm.fused_warm_median_from_theta(
        jnp.asarray(rows), jnp.asarray(theta), jnp.float32(med_prev),
        jnp.asarray(center), warm_passes=16, interpret=True)
    got = tfm.fused_warm_median_from_theta(
        torch.from_numpy(rows), torch.from_numpy(theta),
        torch.tensor(med_prev), torch.from_numpy(center), warm_passes=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("n,p,m", [(3000, 640, 128), (1000, 303, 33),
                                   (200, 7, 17)])
def test_dist_block_then_b2_matches_jax(n, p, m):
    """Kernel B4's plain version then B2's against JAX's pallas_dist_block
    (block_j=512, so n=3000 has padded columns) then
    fused_warm_median_rows, at the JAX suite's large-block shape and at
    the Gram stage's ragged edges (m not a multiple of its 16-row warp
    tile, p not a multiple of its 8-index k-step), rtol 1e-5
    (tests/test_pallas_median.py)."""
    rng = np.random.default_rng(5)
    theta = (rng.normal(size=(n, p)) + 2.0).astype(np.float32)
    rows = theta[jmed._subsample_idx(n, m)]
    center = theta.mean(0, keepdims=True)
    jD = jpm.pallas_dist_block(jnp.asarray(rows), jnp.asarray(theta),
                               jnp.asarray(center), block_j=512,
                               interpret=True)
    want = jpm.fused_warm_median_rows(jD, jnp.float32(0.0), warm_passes=16,
                                      interpret=True)
    tD = tfm.dist_block(torch.from_numpy(rows), torch.from_numpy(theta),
                        torch.from_numpy(center))
    assert tuple(tD.shape) == (m, n)
    np.testing.assert_allclose(tD.numpy(), np.asarray(jD), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jD).max()))
    got = tfm.fused_warm_median_rows(tD, 0.0, warm_passes=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_gram_medians_guards():
    rows = torch.zeros(4, 3, dtype=torch.float64)
    c = torch.zeros(1, 3)
    with pytest.raises(TypeError, match="f32"):
        tfm.dist_block(rows, rows, c)
    with pytest.raises(TypeError, match="f32"):
        tfm.fused_warm_median_from_theta(rows, rows, 0.0, c)
    big = torch.zeros(1, 3).expand(2 ** 16, 3)
    with pytest.raises(ValueError, match="int32"):
        tfm.fused_warm_median_from_theta(big, torch.zeros(1, 3).expand(
            2 ** 15, 3), 0.0, c)
