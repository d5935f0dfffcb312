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


# ------------------------------------------------------------------ B11

def _sym_inputs(n, p, seed, shift=0.0, dtype=np.float32):
    """tests/test_pallas.py's B11 recipe: theta 0.3 N(0, I) (+ shift),
    gradients N(0, I), h^2 0.7."""
    rng = np.random.default_rng(seed)
    theta = (rng.normal(size=(n, p)) * 0.3 + shift).astype(dtype)
    grads = rng.normal(size=(n, p)).astype(dtype)
    return theta, grads, 0.7


def _regrouped(theta, grads, h2):
    """B11's phi in the CUDA kernel's grouping (csrc/svgd_sym.cu), in f32:
    (K @ (g - theta / h^2) + ksum theta / h^2) / n, a contraction p wide,
    K uncentred as the JAX kernel's."""
    t, g = torch.from_numpy(theta), torch.from_numpy(grads)
    n = t.shape[0]
    rsq = torch.sum(t * t, dim=1, keepdim=True)
    D = rsq + rsq.reshape(1, n) - 2.0 * torch.matmul(t, t.T)
    K = torch.exp2(D / h2 * svgd_tile._LOG2E_HALF)
    ksum = torch.sum(K, dim=1, keepdim=True)
    return (torch.matmul(K, g - t / h2) + ksum * t / h2) / n


def _sym_err(theta, grads, h2, block, form="wrapper"):
    """max |got - want| / max |want| against the JAX kernel in interpret
    mode; got is the port's wrapper (its plain version on the CPU), or, for
    form='regrouped', the CUDA kernel's grouping (_regrouped)."""
    from stein_tpu.ops.pallas_svgd import pallas_svgd_phi_sym

    want = np.asarray(pallas_svgd_phi_sym(
        jnp.asarray(theta), jnp.asarray(grads), jnp.float32(h2), block=block,
        interpret=True))
    if form == "regrouped":
        got = _regrouped(theta, grads, h2)
    else:
        got = svgd_tile.svgd_phi_sym(torch.from_numpy(theta),
                                     torch.from_numpy(grads), h2, block=block)
        assert got.dtype == torch.from_numpy(theta).dtype
    assert str(want.dtype) == str(theta.dtype)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


def _forms(cases):
    """Each case through the wrapper (the case's own id) and through the
    kernel's grouping (id + '-regrouped')."""
    return [pytest.param(*c, form, id="-".join(map(str, c)) + suffix)
            for c in cases
            for form, suffix in (("wrapper", ""), ("regrouped", "-regrouped"))]


# tests/test_pallas.py:109's shapes and blocks (ragged n, n a multiple of
# the block, p < 8), within its 1e-5 normalised: the two sides sum K @ [G|T]
# in other orders (measured 1.9-2.4e-7; the kernel's grouping 1.7-3.1e-7).
@pytest.mark.parametrize("n,p,block,form", _forms([(40, 8, 16), (64, 8, 16),
                                                   (100, 5, 32)]))
def test_plain_sym_matches_jax(n, p, block, form):
    theta, grads, h2 = _sym_inputs(n, p, n + p)
    assert _sym_err(theta, grads, h2, block, form) < 1e-5


# Off the origin: B11 does not centre, so the f32 cancellation in ksum theta
# - K theta grows with |theta|^2 (measured 1.3e-6 at n=100, p=8, |theta|
# 2.3-3.9, and 1.3e-5 at n=96, p=130, |theta| 3.9-5.0, in either grouping);
# held to 1e-4 normalised. n=300, p=130 is chip_smoke.py's off-origin case
# (|theta| 3.8-5.3, about 4.5; measured 1.9e-5).
@pytest.mark.parametrize("n,p,block,shift,form", _forms([
    (100, 8, 32, 1.0), (96, 130, 32, 0.25), (300, 130, 32, 0.25)]))
def test_plain_sym_off_origin_matches_jax(n, p, block, shift, form):
    theta, grads, h2 = _sym_inputs(n, p, 3 * n + p, shift)
    dist = np.linalg.norm(theta, axis=1)
    assert dist.min() > 0.5 and dist.max() > 2.0
    assert _sym_err(theta, grads, h2, block, form) < 1e-4


def test_plain_sym_f64_round_trip():
    """f64 in, f64 out, computed in f32 as the JAX function does."""
    theta, grads, h2 = _sym_inputs(64, 8, 5, dtype=np.float64)
    assert _sym_err(theta, grads, h2, 16) < 1e-5
    f32 = svgd_tile.svgd_phi_sym(torch.from_numpy(theta).float(),
                                 torch.from_numpy(grads).float(), h2)
    f64 = svgd_tile.svgd_phi_sym(torch.from_numpy(theta),
                                 torch.from_numpy(grads), h2)
    assert torch.equal(f64, f32.double())


def test_plain_sym_near_origin_matches_b3():
    """Near the origin the uncentred symmetric tile and B3's centred tile
    agree to 1e-5 normalised (tests/test_pallas.py:117-118's bound)."""
    theta, grads, _ = _sym_inputs(300, 40, 9)
    t, g = torch.from_numpy(theta * 0.3), torch.from_numpy(grads)
    sym = svgd_tile.svgd_phi_sym(t, g, 1.0)
    b3 = svgd_tile.svgd_phi(t, g, torch.tensor(1.0))
    assert ((sym - b3).abs().max() / b3.abs().max()).item() < 1e-5


def test_sym_guards():
    theta = torch.zeros(8, 3)
    with pytest.raises(ValueError, match="grads must be"):
        svgd_tile.svgd_phi_sym(theta, torch.zeros(8, 4), 1.0)
    with pytest.raises(TypeError, match="floating"):
        svgd_tile.svgd_phi_sym(theta.long(), theta.long(), 1.0)
    with pytest.raises(ValueError, match="no kernel"):
        svgd_tile.svgd_phi_sym(theta.to("meta"), theta.to("meta"), 1.0)


def test_sym_block_parity():
    """block is accepted for parity: any positive value gives the same phi,
    and a value the JAX function could not tile by raises."""
    theta, grads, h2 = _sym_inputs(50, 6, 2)
    t, g = torch.from_numpy(theta), torch.from_numpy(grads)
    assert torch.equal(svgd_tile.svgd_phi_sym(t, g, h2, block=16),
                       svgd_tile.svgd_phi_sym(t, g, h2))
    with pytest.raises(ValueError, match="block must be positive"):
        svgd_tile.svgd_phi_sym(t, g, h2, block=0)
