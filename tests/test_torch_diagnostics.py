"""The port's KSD diagnostic (stein_tpu_torch/ops/diagnostics.py) and
SVGDSampler.ksd against the JAX package's on the same numpy inputs: the
dense and the streaming forms, V- and U-statistic, and on the mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stein_tpu as sj
import stein_tpu_torch as st
from stein_tpu.models import LinearRegressionModel as JLR
from stein_tpu.ops import diagnostics as jd
from stein_tpu.parallel import particle_mesh as jax_mesh
from stein_tpu_torch.models import LinearRegressionModel as TLR
from stein_tpu_torch.ops import diagnostics as td
from test_diagnostics import _np_ksd
from torch_mesh_runner import one_process_mesh


def _inputs(n, p, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, p)).astype(dtype),
            rng.normal(size=(n, p)).astype(dtype))


@pytest.mark.parametrize("u", [False, True])
def test_ksd_matches_numpy_loop(u):
    """tests/test_diagnostics.py::test_ksd_matches_numpy_loop on the port
    (f64, rtol 1e-9)."""
    theta, grads = _inputs(12, 4, 0)
    got = float(td.ksd_rbf(torch.from_numpy(theta), torch.from_numpy(grads),
                           h2=torch.tensor(1.7, dtype=torch.float64),
                           u_statistic=u))
    np.testing.assert_allclose(got, _np_ksd(theta, grads, 1.7, u),
                               rtol=1e-9)


@pytest.mark.parametrize("u", [False, True])
@pytest.mark.parametrize("n,dtype,rtol", [(50, np.float64, 1e-12),
                                          (50, np.float32, 2e-4),
                                          (300, np.float32, 2e-4)])
def test_ksd_matches_jax(n, dtype, rtol, u):
    """ksd_rbf with the bisect-median bandwidth (h2=None) against JAX's on
    the same inputs: f64 rtol 1e-12, f32 rtol 2e-4 (the f32 sums of n^2
    terms of both signs in two summation orders)."""
    theta, grads = _inputs(n, 5, n, dtype)
    got = float(td.ksd_rbf(torch.from_numpy(theta), torch.from_numpy(grads),
                           u_statistic=u))
    want = float(jd.ksd_rbf(jnp.asarray(theta), jnp.asarray(grads),
                            u_statistic=u))
    np.testing.assert_allclose(got, want, rtol=rtol)


@pytest.mark.parametrize("n", [64, 71])
@pytest.mark.parametrize("u", [False, True])
@pytest.mark.parametrize("given_h2", [False, True])
def test_streaming_ksd_matches_dense_and_jax(monkeypatch, n, u, given_h2):
    """tests/test_diagnostics.py::test_streaming_ksd_matches_dense on the
    port: with KSD_DENSE_MAX_N lowered to 16 the row-block form (16-row
    blocks, and a remainder at n=71) equals the dense form at f64 rtol
    1e-12, and JAX's streaming form too."""
    theta, grads = _inputs(n, 5, 2)
    h2 = 2.3 if given_h2 else None
    t_args = (torch.from_numpy(theta), torch.from_numpy(grads))
    dense = float(td.ksd_rbf(*t_args, h2=h2, u_statistic=u))
    monkeypatch.setattr(td, "KSD_DENSE_MAX_N", 16)
    monkeypatch.setattr(jd, "KSD_DENSE_MAX_N", 16)
    blocked = float(td.ksd_rbf(*t_args, h2=h2, u_statistic=u,
                               block_rows=16))
    jax_blocked = float(jd.ksd_rbf(jnp.asarray(theta), jnp.asarray(grads),
                                   h2=None if h2 is None else jnp.float64(h2),
                                   u_statistic=u, block_rows=16))
    np.testing.assert_allclose(blocked, dense, rtol=1e-12)
    np.testing.assert_allclose(blocked, jax_blocked, rtol=1e-12)


def _problem(seed=1, n=64, dtype=np.float64):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(40, 3))
    y = X @ rng.normal(size=(3, 1)) + rng.normal(size=(40, 1)) * 0.3
    theta0 = rng.normal(size=(n, 3)) * 0.01
    return X.astype(dtype), y.astype(dtype), theta0.astype(dtype)


def test_sampler_ksd_matches_jax_and_decreases():
    """SVGDSampler.ksd against JAX's on the same f64 particles (rtol
    1e-10), before and after 400 steps; tests/test_diagnostics.py's rule:
    the KSD after the run is below a tenth of the KSD at theta0, and the
    V-statistic is >= 0. It returns a Python float."""
    X, y, theta0 = _problem()
    js = sj.SVGDSampler(64, JLR(3).log_p, JLR(3).template(jnp.float64),
                        sj.Adam(1e-1), theta=jnp.asarray(theta0),
                        dtype=jnp.float64)
    ts = st.SVGDSampler(64, TLR(3).log_p, TLR(3).template(torch.float64),
                        st.Adam(1e-1), theta=theta0, dtype=torch.float64,
                        device="cpu")
    jb = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    tb = {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}
    k0 = ts.ksd(tb)
    assert isinstance(k0, float)
    np.testing.assert_allclose(k0, js.ksd(jb), rtol=1e-10)
    ts.run(tb, 400)
    js.run(jb, 400)
    for u in (False, True):
        np.testing.assert_allclose(ts.ksd(tb, u_statistic=u),
                                   js.ksd(jb, u_statistic=u), rtol=1e-6)
    k1 = ts.ksd(tb)
    assert 0 <= k1 < k0 / 10


def test_sampler_ksd_ignores_custom_grads():
    """ksd's scores come from autodiff of log_p, never custom_grads (as in
    the JAX package): a hook that returns zeros changes nothing."""
    X, y, theta0 = _problem(n=16, dtype=np.float32)
    tb = {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}

    def zeros(theta, batch):
        return torch.zeros(theta.shape[0]), torch.zeros_like(theta)
    plain = st.SVGDSampler(16, TLR(3).log_p, TLR(3).template(), st.Adam(),
                           theta=theta0, device="cpu")
    hooked = st.SVGDSampler(16, TLR(3).log_p, TLR(3).template(), st.Adam(),
                            theta=theta0, device="cpu", custom_grads=zeros)
    assert hooked.ksd(tb) == plain.ksd(tb)


@pytest.fixture(scope="module")
def mesh1():
    with one_process_mesh() as mesh:
        yield mesh


def test_sampler_ksd_on_the_mesh(mesh1):
    """tests/test_sharded.py:1060 on the port: ksd on a one-process gloo
    mesh (the gathered particles) equals the single-device ksd bitwise
    after the same 3 steps, and JAX's 8-device mesh ksd at rtol 1e-6
    (f32), both statistics."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(40, 3))
    y = X @ (rng.normal(size=(3, 1)) * 2.0) + rng.normal(size=(40, 1)) * 0.3
    theta0 = (rng.normal(size=(16, 3)) * 0.01).astype(np.float32)
    X, y = X.astype(np.float32), y.astype(np.float32)
    tb = {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}
    jb = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    single, meshed = (st.SVGDSampler(16, TLR(3).log_p, TLR(3).template(),
                                     st.Adam(1e-1), theta=theta0,
                                     device="cpu", **kw)
                      for kw in ({}, dict(mesh=mesh1)))
    jmesh = sj.SVGDSampler(16, JLR(3).log_p, JLR(3).template(jnp.float32),
                           sj.Adam(1e-1), theta=jnp.asarray(theta0),
                           dtype=jnp.float32,
                           mesh=jax_mesh(jax.devices()[:8]))
    for _ in range(3):
        single.train_on_batch(tb)
        meshed.train_on_batch(tb)
        jmesh.train_on_batch(jb)
    for u in (False, True):
        k_m = meshed.ksd(tb, u_statistic=u)
        assert k_m == single.ksd(tb, u_statistic=u)
        np.testing.assert_allclose(k_m, jmesh.ksd(jb, u_statistic=u),
                                   rtol=1e-6)
        assert np.isfinite(k_m)
