"""Statistical validation of the port on analytically known targets,
counterpart of tests/test_statistical.py: SVGD particle moments converge to
the target's moments within Monte-Carlo error, at the JAX file's bounds
(its line beside each case), in f64 (bf16 storage with the model in f32
for :100).

Particle RNG differs between the packages, so every case draws theta0 with
numpy from default_rng(0) (the JAX default's 0.01 N(0, 1); 3 N(0, 1) for
the bimodal case) and passes it to the sampler. On the CPU every case but
the bimodal one also runs the JAX sampler from the same theta0: the port's
mean must agree with JAX's within 0.05 and its covariance within 0.08,
the JAX file's warm-against-cold tightness (:179-184). The bimodal
trajectory is chaotic, so that case is held to the analytic target only,
as in the JAX file.

Each case's card instance is marked ``cuda`` and skips without a card
(decided in a fixture, at run time); there the sampler replays its steps
from CUDA graphs (``run``), which the case checks. The card run imports
neither jax nor stein_tpu (the JAX comparison runs on the CPU only, and
imports jax there):

    python -m pytest tests/test_torch_statistical.py -m cuda -q \\
        --noconftest -p no:cacheprovider -rs -s
"""

import numpy as np
import pytest
import torch

from stein_tpu_torch import Adagrad, Adam, SVGDSampler

F64, BF16, F32 = torch.float64, torch.bfloat16, torch.float32
MU = np.array([1.0, -2.0, 0.5])
COV = np.array([
    [1.0, 0.7, 0.2],
    [0.7, 1.5, -0.3],
    [0.2, -0.3, 0.8],
])
# The port against the JAX sampler from the same theta0
# (tests/test_statistical.py:179-184).
JAX_MEAN_TOL, JAX_COV_TOL = 0.05, 0.08


def _device(name):
    if name == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
        torch.backends.cuda.matmul.allow_tf32 = False
        return torch.device("cuda", 0)
    return torch.device("cpu")


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    """The CPU (the plain versions, and the JAX comparison), then the
    card."""
    return _device(request.param)


def theta0(n, d, scale=0.01):
    return np.random.default_rng(0).normal(size=(n, d)) * scale


def gaussian_target(mu, cov, device):
    """log_p of N(mu, cov) on {"x": [d]} in f64, and its template."""
    prec = torch.tensor(np.linalg.inv(cov), dtype=F64, device=device)
    m = torch.tensor(mu, dtype=F64, device=device)

    def log_p(params, batch):
        d = params["x"] - m
        return -0.5 * d @ prec @ d
    return log_p, {"x": torch.zeros(mu.shape, dtype=F64, device=device)}


def bf16_target(device):
    """The correlated Gaussian on bf16 particles, the model in f32 (storage
    bf16, math f32)."""
    prec = torch.tensor(np.linalg.inv(COV), dtype=F32, device=device)
    m = torch.tensor(MU, dtype=F32, device=device)

    def log_p(params, batch):
        d = params["x"].to(F32) - m
        return -0.5 * d @ prec @ d
    return log_p, {"x": torch.zeros((3,), dtype=BF16, device=device)}


def bimodal_target(device):
    """An equal-weight 1-D mixture of N(3, 1) and N(-3, 1)."""
    def log_p(params, batch):
        x = params["x"][0]
        return torch.logsumexp(
            torch.stack([-0.5 * (x - 3.0) ** 2, -0.5 * (x + 3.0) ** 2]), 0)
    return log_p, {"x": torch.zeros((1,), dtype=F64, device=device)}


def port_samples(log_p, template, gd, th0, n_steps, device, dtype=F64,
                 **kw):
    """The port's run(None, n_steps) from th0; on a card it must replay
    graphs. The samples as f64 numpy."""
    s = SVGDSampler(th0.shape[0], log_p, template, gd, theta=th0,
                    dtype=dtype, device=device, **kw)
    aux = s.run(None, n_steps)
    if device.type == "cuda":
        torch.cuda.synchronize()
        assert s._graphs is not None and s._graphs.captures > 0, \
            "the card's run replayed no graph"
    assert torch.isfinite(aux["phi_norm"]).all()
    return np.asarray(s.samples, np.float64)


def jax_samples(case, th0, n_steps, **kw):
    """The JAX sampler's run from the same th0 (CPU only)."""
    import jax.numpy as jnp

    import stein_tpu as sj

    dtype = jnp.bfloat16 if case == "bf16" else jnp.float64
    if case == "bf16":
        prec = jnp.asarray(np.linalg.inv(COV), jnp.float32)
        m = jnp.asarray(MU, jnp.float32)

        def log_p(params, batch):
            d = params["x"].astype(jnp.float32) - m
            return -0.5 * d @ prec @ d
        gd = sj.Adam(learning_rate=5e-2)
    else:
        mu, cov = ((np.array([2.0, -1.0]), np.eye(2) * 0.5)
                   if case == "adagrad" else (MU, COV))
        prec = jnp.asarray(np.linalg.inv(cov), jnp.float64)
        m = jnp.asarray(mu, jnp.float64)

        def log_p(params, batch):
            d = params["x"] - m
            return -0.5 * d @ prec @ d
        gd = (sj.Adagrad(learning_rate=5e-2) if case == "adagrad"
              else sj.Adam(learning_rate=5e-2))
    s = sj.SVGDSampler(
        n_particles=th0.shape[0], log_p=log_p,
        param_template={"x": jnp.zeros((th0.shape[1],), dtype)}, gd=gd,
        theta=jnp.asarray(th0, dtype), dtype=dtype, **kw)
    s.run(batch=None, n_steps=n_steps)
    return np.asarray(s.samples, np.float64)


def report(case, device, **errs):
    """The case's ``[statistical]`` line: each measured error beside its
    bound (chip_smoke.py's [statistical] prints the card's)."""
    print(f"[statistical] {case} on {device.type}: " + ", ".join(
        f"{k} {v[0]:.4g} (bound {v[1]:g})" for k, v in errs.items()),
        flush=True)


def max_abs(a, b):
    return float(np.max(np.abs(a - b)))


def agrees_with_jax(case, s, j):
    report(case, torch.device("cpu"),
           mean_vs_jax=(max_abs(s.mean(axis=0), j.mean(axis=0)),
                        JAX_MEAN_TOL),
           cov_vs_jax=(max_abs(np.cov(s.T), np.cov(j.T)), JAX_COV_TOL))
    np.testing.assert_allclose(s.mean(axis=0), j.mean(axis=0),
                               atol=JAX_MEAN_TOL)
    np.testing.assert_allclose(np.cov(s.T), np.cov(j.T), atol=JAX_COV_TOL)


def test_correlated_gaussian_moments(device):
    """tests/test_statistical.py:24."""
    n, th0 = 128, theta0(128, 3)
    log_p, template = gaussian_target(MU, COV, device)
    s = port_samples(log_p, template, Adam(learning_rate=5e-2), th0, 1500,
                     device)
    mc = np.sqrt(np.diag(COV) / n)
    est_cov = np.cov(s.T)
    corr = est_cov[0, 1] / np.sqrt(est_cov[0, 0] * est_cov[1, 1])
    true_corr = COV[0, 1] / np.sqrt(COV[0, 0] * COV[1, 1])
    report("correlated gaussian", device,
           mean=(max_abs(s.mean(axis=0), MU), 4 * mc.max()),
           cov=(max_abs(est_cov, COV), 0.45),
           corr=(abs(corr - true_corr), 0.2))
    np.testing.assert_allclose(s.mean(axis=0), MU, atol=4 * mc.max())
    np.testing.assert_allclose(est_cov, COV, atol=0.45)
    assert abs(corr - true_corr) < 0.2
    if device.type == "cpu":
        agrees_with_jax("correlated gaussian", s,
                        jax_samples("gaussian", th0, 1500))


def test_gaussian_adagrad_converges(device):
    """tests/test_statistical.py:51."""
    mu, n, th0 = np.array([2.0, -1.0]), 64, theta0(64, 2)
    log_p, template = gaussian_target(mu, np.eye(2) * 0.5, device)
    s = port_samples(log_p, template, Adagrad(learning_rate=5e-2), th0,
                     1500, device)
    report("adagrad", device,
           mean=(max_abs(s.mean(axis=0), mu), 4 * np.sqrt(0.5 / n)))
    np.testing.assert_allclose(s.mean(axis=0), mu,
                               atol=4 * np.sqrt(0.5 / n))
    if device.type == "cpu":
        agrees_with_jax("adagrad", s, jax_samples("adagrad", th0, 1500))


def test_bimodal_1d_mass_split(device):
    """tests/test_statistical.py:68: particles spread across both basins
    split the mass roughly evenly, the modes near +-3."""
    log_p, template = bimodal_target(device)
    s = port_samples(log_p, template, Adam(learning_rate=1e-1),
                     theta0(100, 1, scale=3.0), 2000, device).ravel()
    frac_right = np.mean(s > 0)
    print(f"[statistical] bimodal on {device.type}: mass right "
          f"{frac_right:.4g} (bounds 0.3, 0.7), modes "
          f"{np.mean(s[s > 0]):.4g} and {np.mean(s[s < 0]):.4g} (within "
          "0.5 of +-3)", flush=True)
    assert 0.3 < frac_right < 0.7
    assert abs(np.mean(s[s > 0]) - 3.0) < 0.5
    assert abs(np.mean(s[s < 0]) + 3.0) < 0.5


def test_bfloat16_end_to_end_posterior(device):
    """tests/test_statistical.py:100: bf16 particles, moments and phi, the
    model in f32; the moments inside the Monte-Carlo band at the JAX file's
    coarser bf16 bounds."""
    n, th0 = 128, theta0(128, 3)
    log_p, template = bf16_target(device)
    s = port_samples(log_p, template, Adam(learning_rate=5e-2), th0, 1500,
                     device, dtype=BF16)
    assert np.isfinite(s).all()
    mc = np.sqrt(np.diag(COV) / n)
    est = np.cov(s.T)
    report("bf16", device, mean=(max_abs(s.mean(axis=0), MU), 4 * mc.max()),
           cov=(max_abs(est, COV), 0.55),
           least_variance=(float(np.min(np.diag(est))), 0.3))
    np.testing.assert_allclose(s.mean(axis=0), MU, atol=4 * mc.max())
    np.testing.assert_allclose(est, COV, atol=0.55)
    assert np.all(np.diag(est) > 0.3)
    if device.type == "cpu":
        agrees_with_jax("bf16", s, jax_samples("bf16", th0, 1500))


def test_warm_median_posterior_statistically_equal(device):
    """tests/test_statistical.py:150: warm (warm_passes=6) and cold bisect
    medians from the same theta0 converge to the same moments."""
    th0 = theta0(128, 3)
    log_p, template = gaussian_target(MU, COV, device)
    runs = {}
    for name, kw in (("cold", {}),
                     ("warm", dict(warm_median=True, warm_passes=6))):
        runs[name] = port_samples(log_p, template, Adam(learning_rate=5e-2),
                                  th0, 1500, device, median="bisect", **kw)
        if device.type == "cpu":
            agrees_with_jax(f"{name} bisect", runs[name], jax_samples(
                "gaussian", th0, 1500, median="bisect", **kw))
    warm, cold = runs["warm"], runs["cold"]
    report("warm against cold", device,
           mean=(max_abs(warm.mean(axis=0), cold.mean(axis=0)), 0.05),
           cov=(max_abs(np.cov(warm.T), np.cov(cold.T)), 0.08))
    np.testing.assert_allclose(warm.mean(axis=0), cold.mean(axis=0),
                               atol=0.05)
    np.testing.assert_allclose(np.cov(warm.T), np.cov(cold.T), atol=0.08)
