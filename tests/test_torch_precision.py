"""pallas_precision='bf16': the streaming tile's bf16 operands (kernel B3's
plain version, stein_tpu_torch/ops/svgd_tile.py) against the JAX package's
tile with precision='bf16' in interpret mode, and the bf16 sampler (one
device and a one-process gloo mesh) against the JAX sampler of the same
configuration, on the same numpy inputs.

Tolerances. Both sides round the same f32 values to bf16 (the centred
particles, K and u), so they differ by f32 summation order, which can move
a K entry across a bf16 rounding boundary: one bf16 ulp (2^-8) of one
term. Measured on these inputs: phi within 1.2e-4 of max|phi|, ksum within
2.1e-7; held to 5e-4 and 1e-5. Against the f32 tile, the JAX suite's own
bf16 class (tests/test_pallas.py:91-93): rtol 0.05, atol 5e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stein_tpu as sj
import stein_tpu_torch as st
from stein_tpu.models import LinearRegressionModel as JModel
from stein_tpu.ops import rbf as jrbf
from stein_tpu.ops.median import exact_median as jexact
from stein_tpu.ops.pallas_svgd import pallas_svgd_both_ksum, pallas_svgd_phi
from stein_tpu.parallel import particle_mesh as jax_mesh
from stein_tpu_torch.models import LinearRegressionModel as TModel
from stein_tpu_torch.ops import svgd_tile
from torch_mesh_runner import one_process_mesh

PHI_BF16 = 5e-4     # normalised, bf16 plain vs JAX bf16
KSUM_BF16 = 1e-5    # normalised (K and its sums stay f32)


def _inputs(n, p, seed, shift=0.0):
    rng = np.random.default_rng(seed)
    theta = (rng.normal(size=(n, p)) + shift).astype(np.float32)
    grads = rng.normal(size=(n, p)).astype(np.float32)
    h2 = jrbf.bandwidth_sq_from_median(
        jexact(jrbf.pairwise_sq_dists(jnp.asarray(theta))), n)
    return theta, grads, np.float32(h2)


def _norm_err(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(
        want).max()


# tests/test_pallas.py:79's shape and tests/test_torch_svgd_tile.py's five.
@pytest.mark.parametrize("n,p,bi", [
    (64, 16, 32), (100, 7, 32), (32, 130, 32), (16, 3, 64), (1000, 303, 512),
])
def test_bf16_plain_tile_matches_jax(n, p, bi):
    theta, grads, h2 = _inputs(n, p, n * 1000 + p)
    want = pallas_svgd_phi(jnp.asarray(theta), jnp.asarray(grads),
                           jnp.float32(h2), block_i=bi, block_j=bi,
                           interpret=True, precision="bf16")
    got = svgd_tile.svgd_phi(torch.from_numpy(theta),
                             torch.from_numpy(grads), torch.tensor(h2),
                             precision="bf16")
    assert _norm_err(got.numpy(), want) <= PHI_BF16


@pytest.mark.parametrize("m,n,p", [(70, 300, 40), (33, 97, 130)])
def test_bf16_plain_rect_accumulators_match_jax(m, n, p):
    """The raw (ku, ksum) of an m < n row block off the origin, about the
    columns' mean, at two rectangular shapes."""
    theta, grads, h2 = _inputs(n, p, m + n + p, shift=1.0)
    rows = theta[::3][:m]
    center = theta.mean(0, keepdims=True)
    jku, jks = pallas_svgd_both_ksum(
        jnp.asarray(rows), jnp.asarray(theta), jnp.asarray(grads),
        jnp.float32(h2), jnp.asarray(center), block_i=64, block_j=128,
        interpret=True, precision="bf16")
    tku, tks = svgd_tile.svgd_both_ksum(
        torch.from_numpy(rows), torch.from_numpy(theta),
        torch.from_numpy(grads), torch.tensor(h2), torch.from_numpy(center),
        precision="bf16")
    assert _norm_err(tku.numpy(), jku) <= PHI_BF16
    assert _norm_err(tks.numpy(), jks) <= KSUM_BF16


@pytest.mark.parametrize("n,p", [(64, 16), (1000, 303)])
def test_bf16_plain_phi_within_jax_class_of_f32(n, p):
    """The bf16 plain phi against the f32 plain phi at the JAX suite's
    bf16 class (test_pallas_bf16_precision_close)."""
    theta, grads, h2 = _inputs(n, p, 6 + n)
    t, g = torch.from_numpy(theta), torch.from_numpy(grads)
    f32 = svgd_tile.svgd_phi(t, g, torch.tensor(h2))
    bf16 = svgd_tile.svgd_phi(t, g, torch.tensor(h2), precision="bf16")
    np.testing.assert_allclose(bf16.numpy(), f32.numpy(), rtol=0.05,
                               atol=5e-3)


def test_unknown_precision_raises():
    t = torch.zeros(8, 3)
    with pytest.raises(ValueError, match="pallas_precision"):
        svgd_tile.svgd_phi(t, t, 1.0, precision="fp8")
    with pytest.raises(ValueError, match="pallas_precision"):
        st.SVGDSampler(8, TModel(3).log_p, TModel(3).template(), st.Adam(),
                       device="cpu", median="bisect", kernel_impl="pallas",
                       pallas_precision="fp8")


def _problem(n=48, p=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(80, p)).astype(np.float32)
    y = (X @ rng.normal(size=(p, 1))).astype(np.float32)
    theta0 = (rng.normal(size=(n, p)) * 0.1).astype(np.float32)
    return X, y, theta0


# Five steps of Adam(0.1) from the same theta0 (run(): the cold seed, then
# the warm bisect). The bf16 phi of the two sides differs by the rounding
# flips above, and Adam's first steps divide phi by its own magnitude, so a
# small component carries its relative change into theta at the scale of
# lr. Measured on this problem: samples within 3.0e-7 of max|theta|,
# medians equal, phi_norm within 1.8e-7 relative (one device and the mesh
# alike); held to 1e-5 of max|theta|, medians rtol 1e-6 and phi_norm rtol
# 1e-5.
SAMPLES_BF16 = 1e-5


@pytest.mark.parametrize("where", ["device", "mesh"])
def test_bf16_sampler_matches_jax(where):
    X, y, theta0 = _problem()
    n, p = theta0.shape
    cfg = dict(median="bisect", kernel_impl="pallas", warm_median=True,
               pallas_precision="bf16", pallas_block=16)
    jm, tm = JModel(p), TModel(p)
    jcfg = dict(cfg, pallas_interpret=True)
    if where == "mesh":
        jcfg["mesh"] = jax_mesh(jax.devices()[:1])
    js = sj.SVGDSampler(n, jm.log_p, jm.template(), sj.Adam(0.1),
                        theta=jnp.asarray(theta0), **jcfg)
    ja = js.run({"X": jnp.asarray(X), "y": jnp.asarray(y)}, 5)

    def port(mesh=None):
        ts = st.SVGDSampler(n, tm.log_p, tm.template(), st.Adam(0.1),
                            theta=theta0, device="cpu", mesh=mesh, **cfg)
        ta = ts.run({"X": torch.from_numpy(X), "y": torch.from_numpy(y)}, 5)
        return ts.samples, ta

    if where == "mesh":
        with one_process_mesh() as mesh:
            samples, ta = port(mesh)
    else:
        samples, ta = port()
    want = np.asarray(js.samples)
    assert np.abs(samples - want).max() <= SAMPLES_BF16 * np.abs(want).max()
    np.testing.assert_allclose(ta["median"].numpy(), np.asarray(ja["median"]),
                               rtol=1e-6)
    np.testing.assert_allclose(ta["phi_norm"].numpy(),
                               np.asarray(ja["phi_norm"]), rtol=1e-5)
