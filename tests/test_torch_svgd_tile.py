"""Kernel B3's plain version (stein_tpu_torch/ops/svgd_tile.py) against the
JAX streaming tile in interpret mode, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stein_tpu.ops import rbf as jrbf
from stein_tpu.ops.median import exact_median as jexact
from stein_tpu.ops.pallas_svgd import pallas_svgd_both_ksum, pallas_svgd_phi
from stein_tpu_torch.ops import svgd_tile


def _inputs(n, p, seed, shift=0.0):
    rng = np.random.default_rng(seed)
    theta = (rng.normal(size=(n, p)) + shift).astype(np.float32)
    grads = rng.normal(size=(n, p)).astype(np.float32)
    h2 = jrbf.bandwidth_sq_from_median(
        jexact(jrbf.pairwise_sq_dists(jnp.asarray(theta))), n)
    return theta, grads, np.float32(h2)


# tests/test_pallas.py's four shapes (blocks over n, ragged n with odd p,
# p > 128, one block larger than n) plus the Bayesian-NN width, at that
# suite's rtol 2e-5 / atol 1e-6 (f32 sums in other orders).
@pytest.mark.parametrize("n,p,bi", [
    (64, 16, 32), (100, 7, 32), (32, 130, 32), (16, 3, 64), (1000, 303, 512),
])
def test_plain_tile_matches_jax(n, p, bi):
    theta, grads, h2 = _inputs(n, p, n * 1000 + p)
    want = pallas_svgd_phi(jnp.asarray(theta), jnp.asarray(grads),
                           jnp.float32(h2), block_i=bi, block_j=bi,
                           interpret=True)
    got = svgd_tile.svgd_phi(torch.from_numpy(theta),
                             torch.from_numpy(grads), torch.tensor(h2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-6)


def test_plain_rect_raw_accumulators_match_jax():
    """The raw (ku, ksum) of an m < n row block, off the origin, about the
    columns' mean."""
    theta, grads, h2 = _inputs(300, 40, 7, shift=3.0)
    rows = theta[::3][:70]
    center = theta.mean(0, keepdims=True)
    jku, jks = pallas_svgd_both_ksum(
        jnp.asarray(rows), jnp.asarray(theta), jnp.asarray(grads),
        jnp.float32(h2), jnp.asarray(center), block_i=64, block_j=128,
        interpret=True)
    tku, tks = svgd_tile.svgd_both_ksum(
        torch.from_numpy(rows), torch.from_numpy(theta),
        torch.from_numpy(grads), torch.tensor(h2), torch.from_numpy(center))
    assert tku.shape == (70, 40) and tks.shape == (70, 1)
    np.testing.assert_allclose(tks.numpy(), np.asarray(jks), rtol=2e-5,
                               atol=1e-6)
    scale = np.abs(np.asarray(jku)).max()
    np.testing.assert_allclose(tku.numpy(), np.asarray(jku), rtol=2e-5,
                               atol=1e-6 * scale)


def test_phi_rect_divides_by_n_total():
    theta, grads, h2 = _inputs(50, 5, 2)
    t, g = torch.from_numpy(theta), torch.from_numpy(grads)
    full = svgd_tile.svgd_phi_rect(t[:20], t, g, torch.tensor(h2))
    half = svgd_tile.svgd_phi_rect(t[:20], t, g, torch.tensor(h2),
                                   n_total=100)
    torch.testing.assert_close(half * 2, full, rtol=1e-6, atol=0)


def test_tile_guards():
    t = torch.zeros(8, 3)
    with pytest.raises(TypeError, match="f32"):
        svgd_tile.svgd_phi(t.double(), t.double(), 1.0)
    with pytest.raises(ValueError, match="grads"):
        svgd_tile.svgd_phi(t, torch.zeros(8, 4), 1.0)


# B10: the JAX on-D tile in interpret mode, with ragged blocks on its side
# (m, n not multiples of the block), at the B3 cases' rtol 2e-5 / atol 1e-6
# of the largest entry.
@pytest.mark.parametrize("m,n,p,block", [
    (64, 64, 16, 32), (70, 100, 7, 32), (128, 300, 40, 128),
])
def test_plain_on_d_matches_jax(m, n, p, block):
    from stein_tpu.ops.pallas_svgd import pallas_svgd_both_ksum_on_D

    theta, grads, h2 = _inputs(n, p, m + n + p)
    D = np.array(jrbf.pairwise_sq_dists(jnp.asarray(theta)))[:m]
    u = (grads - theta / h2).astype(np.float32)
    jku, jks = pallas_svgd_both_ksum_on_D(
        jnp.asarray(D), jnp.asarray(u), jnp.float32(h2), block_i=block,
        block_j=block, interpret=True)
    tku, tks = svgd_tile.svgd_both_ksum_on_D(
        torch.from_numpy(D), torch.from_numpy(u), torch.tensor(h2))
    assert tku.shape == (m, p) and tks.shape == (m, 1)
    np.testing.assert_allclose(tks.numpy(), np.asarray(jks), rtol=2e-5,
                               atol=1e-6)
    scale = np.abs(np.asarray(jku)).max()
    np.testing.assert_allclose(tku.numpy(), np.asarray(jku), rtol=2e-5,
                               atol=1e-6 * scale)


def test_on_d_guards():
    D = torch.zeros(4, 5)
    with pytest.raises(TypeError, match="f32"):
        svgd_tile.svgd_both_ksum_on_D(D.double(), torch.zeros(5, 2), 1.0)
    with pytest.raises(ValueError, match="u_cols"):
        svgd_tile.svgd_both_ksum_on_D(D, torch.zeros(4, 2), 1.0)
