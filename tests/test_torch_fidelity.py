"""Deployed-numerics fidelity of the port: its f32 step on the card against
the f64 NumPy oracle (baselines/numpy_svgd.py) or a closed form. Counterpart
of tests_tpu/test_tpu_fidelity.py, one test per JAX test, named after it,
with its line there and its bound.

The port's other card checks compare each kernel with its plain version,
both in f32 on the card, and its CPU tests compare the port with JAX on the
CPU. This file holds the card's arithmetic (mma.sync 3xTF32 on the tensor
cores, f32 on the CUDA cores) to f64: in particular where truncating
tensor-core accumulation could lose digits, the Gram cancellation probe
(particles 1e-3 apart at norm ~8) and the off-origin clouds (shifts 10
and 100).

Cases parametrised by ``device`` also run on the CPU (the plain versions;
tier-1); the others, and each case's card instance, are marked ``cuda`` and
skip without a card (decided in a fixture, at run time). On a card:

    python -m pytest tests/test_torch_fidelity.py -m cuda -q --noconftest \\
        -p no:cacheprovider -rs -s

It imports neither jax nor stein_tpu (``--noconftest``: the JAX package's
test configuration is not needed). Each case prints a ``[fidelity]`` line
with its measured error beside its bound. The mesh cases run on a
one-process NCCL group (``setup_distributed(store=HashStore())``)."""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from baselines.numpy_svgd import NumpyAdam, clip_phi, compute_phi
from stein_tpu_torch import (
    Adam,
    SVGDSampler,
    throughput_config,
)
from stein_tpu_torch.api import _make_grad_all, make_phi_fn
from stein_tpu_torch.models import (
    BayesianNNModel,
    LinearRegressionModel,
    LogisticRegressionModel,
)
from stein_tpu_torch.ops import fused_median, svgd_tile
from stein_tpu_torch.ops.diagnostics import ksd_rbf
from stein_tpu_torch.ops.median import _strided_rows, _warm_search
from stein_tpu_torch.ops.rbf import pairwise_sq_dists
from stein_tpu_torch.parallel import mesh_2d, particle_mesh, setup_distributed
from stein_tpu_torch.utils.ravel import template_unraveler

F32 = torch.float32
# One f32-induced Adam sign flip on a near-zero phi coordinate moves that
# coordinate by 2 * lr * (1/(1-b1)) / sqrt(1/(1-b2)) = 2 * 0.1 * 0.316 per
# step; up to 2 flips' worth across 5 steps (:43-46).
FLIP_BOUND = 2 * 2 * 0.1 * 0.3163


def _device(name):
    if name == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
        torch.backends.cuda.matmul.allow_tf32 = False
        return torch.device("cuda", 0)
    return torch.device("cpu")


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    """The CPU (the plain versions), then the card."""
    return _device(request.param)


@pytest.fixture
def card():
    return _device("cuda")


@pytest.fixture(scope="module")
def nccl():
    """(1-D mesh, 1 x 1 2-D mesh) on a one-process NCCL group."""
    dev = _device("cuda")
    setup_distributed("nccl", store=dist.HashStore(), world_size=1, rank=0,
                      device_id=dev)
    try:
        yield particle_mesh(), mesh_2d(1, 1)
    finally:
        dist.destroy_process_group()


def _t(x, device):
    return torch.tensor(np.asarray(x), dtype=F32, device=device)


def _np(x):
    return x.detach().to("cpu", torch.float64).numpy()


def _linreg_problem(seed=0, n_particles=64, n_feats=16, n_obs=128):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_obs, n_feats))
    w_true = rng.normal(size=(n_feats, 1))
    y = X @ w_true + rng.normal(size=(n_obs, 1)) * 0.3
    theta0 = rng.normal(size=(n_particles, n_feats)) * 0.01
    return X, y, theta0


def _numpy_grads(X, y, theta):
    """d/dw [ -0.5||Xw-y||^2 - 0.5||w||^2 ] rows, f64."""
    return (y.T - theta @ X.T) @ X - theta


def _oracle_trajectory(X, y, theta0, k_steps, lr=1e-1, amb_tol=3e-4):
    """The f64 oracle's trajectory and the sign-ambiguity mask (:63-83): a
    coordinate is ambiguous if at any step its clipped phi was within
    ``amb_tol`` of zero relative to that step's phi scale (3e-4 for the
    reference-semantics path, 3e-3 for the kernels' class)."""
    theta = np.array(theta0, dtype=np.float64)
    gd = NumpyAdam(learning_rate=lr)
    ambiguous = np.zeros(theta.shape, dtype=bool)
    for _ in range(k_steps):
        phi, _ = compute_phi(theta, _numpy_grads(X, y, theta))
        phi = clip_phi(phi)
        ambiguous |= np.abs(phi) < amb_tol * np.abs(phi).max()
        theta = theta + gd.update(phi)
    return theta, ambiguous


def _linreg_batch(X, y, device):
    return {"X": _t(X, device), "y": _t(y, device)}


def _port_sampler(X, y, theta0, device, lr=1e-1, **kw):
    model = LinearRegressionModel(X.shape[1])
    return SVGDSampler(theta0.shape[0], model.log_p, model.template(),
                       Adam(learning_rate=lr),
                       theta=np.asarray(theta0, np.float32), device=device,
                       **kw)


def _port_trajectory(X, y, theta0, k_steps, device, lr=1e-1, **kw):
    s = _port_sampler(X, y, theta0, device, lr, **kw)
    s.run(_linreg_batch(X, y, device), k_steps)
    return s.samples


def _assert_trajectory_close(got, ref, ambiguous, label, bound=1e-3):
    """Unambiguous coordinates within ``bound`` (1e-3 for the reference
    path, 5e-3 for the kernels' class), every coordinate within two Adam
    sign flips (:102-123)."""
    err = np.abs(got - ref)
    err_clean = err[~ambiguous]
    bad_clean = err_clean.max() if err_clean.size else 0.0
    print(f"[fidelity] {label}: max {err.max():.3e} (bound "
          f"{FLIP_BOUND:.3f}) max-unambiguous {bad_clean:.3e} (bound "
          f"{bound:g}) ambiguous-frac {ambiguous.mean():.4f}")
    assert bad_clean < bound, (label, bad_clean, bound)
    assert err.max() < FLIP_BOUND, (label, err.max())


def _linreg_posterior(seed):
    rng = np.random.default_rng(seed)
    n, p, n_obs = 512, 8, 256
    X = rng.normal(size=(n_obs, p))
    w_true = rng.normal(size=(p, 1))
    y = X @ w_true + rng.normal(size=(n_obs, 1)) * 0.5
    A = X.T @ X + np.eye(p)
    cov = np.linalg.inv(A)
    return X, y, cov @ (X.T @ y), cov, n, p


def _assert_posterior(label, samples, mean, cov, n):
    """The conjugate posterior: mean within 6 Monte-Carlo scales, each
    variance ratio in (0.5, 1.6) (:431-442)."""
    mc = np.sqrt(np.diag(cov) / n)
    err = np.abs(samples.mean(axis=0) - mean.ravel())
    ratio = samples.var(axis=0) / np.diag(cov)
    print(f"[fidelity] {label}: mean max err {err.max():.3e} (bound "
          f"{6 * mc.max():.3e}); var ratio {ratio.min():.3f}-"
          f"{ratio.max():.3f} (bound 0.5-1.6)")
    assert err.max() < 6 * mc.max(), (err.max(), mc.max())
    assert np.all(ratio > 0.5) and np.all(ratio < 1.6), ratio


# --------------------------------------------------------------- phi
def test_phi_engine_fidelity(device):
    """:126 -- the f32 engine (exact median, kernel, direction) fed the
    same f64-computed gradients as the oracle: rel < 1e-4 of phi's scale,
    its norm within 1e-5."""
    X, y, theta0 = _linreg_problem()
    theta, _ = _oracle_trajectory(X, y, theta0, 3)
    grads64 = _numpy_grads(X, y, theta)
    phi_fn = make_phi_fn(theta.shape[0], median="exact", kernel_impl="xla")
    got = _np(phi_fn(_t(theta, device), _t(grads64, device))[0])
    ref, _ = compute_phi(theta, grads64)
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    norm_rel = abs(np.linalg.norm(got) - np.linalg.norm(ref)) \
        / np.linalg.norm(ref)
    print(f"[fidelity] phi engine ({device.type}): rel {rel:.3e} (bound "
          f"1e-4), norm rel {norm_rel:.3e} (bound 1e-5)")
    assert rel < 1e-4
    assert norm_rel < 1e-5


def test_phi_direction_fidelity(device):
    """:152 -- phi with the port's own f32 model gradients (torch.func):
    rel < 1e-4."""
    X, y, theta0 = _linreg_problem()
    theta, _ = _oracle_trajectory(X, y, theta0, 3)
    model = LinearRegressionModel(X.shape[1])
    grad_all = _make_grad_all(model.log_p,
                              template_unraveler(model.template())[1])
    th = _t(theta, device)
    _, grads = grad_all(th, _linreg_batch(X, y, device))
    phi_fn = make_phi_fn(theta.shape[0], median="exact", kernel_impl="xla")
    got = _np(phi_fn(th, grads)[0])
    ref, _ = compute_phi(theta, _numpy_grads(X, y, theta))
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    print(f"[fidelity] phi end-to-end ({device.type}): rel {rel:.3e} "
          "(bound 1e-4)")
    assert rel < 1e-4


# -------------------------------------------------- 5-step trajectories
def test_f32_xla_step_matches_f64_oracle(device):
    """:188 -- 5 f32 steps (exact median, the reference-semantics path)."""
    X, y, theta0 = _linreg_problem()
    ref, amb = _oracle_trajectory(X, y, theta0, 5)
    got = _port_trajectory(X, y, theta0, 5, device, median="exact",
                           kernel_impl="xla")
    _assert_trajectory_close(got, ref, amb, f"xla exact-median "
                             f"({device.type})")


def test_f32_bisect_step_matches_f64_oracle(device):
    """:197 -- the sort-free bisect median (40 passes)."""
    X, y, theta0 = _linreg_problem(seed=1)
    ref, amb = _oracle_trajectory(X, y, theta0, 5)
    got = _port_trajectory(X, y, theta0, 5, device, median="bisect",
                           median_passes=40, kernel_impl="xla")
    _assert_trajectory_close(got, ref, amb, f"xla bisect ({device.type})")


def test_f32_pallas_step_matches_f64_oracle(device):
    """:206 -- the streaming tile (B3 on the card: mma.sync 3xTF32) at
    n=256, p=128, at the kernels' class (amb_tol 3e-3, bound 5e-3)."""
    X, y, theta0 = _linreg_problem(seed=2, n_particles=256, n_feats=128)
    ref, amb = _oracle_trajectory(X, y, theta0, 5, amb_tol=3e-3)
    got = _port_trajectory(X, y, theta0, 5, device, median="bisect",
                           median_passes=40, kernel_impl="pallas",
                           pallas_block=128)
    _assert_trajectory_close(got, ref, amb, f"pallas ({device.type})",
                             bound=5e-3)


def _mesh_vs_single(mesh, dev, seed, label, **extra):
    """(max abs difference, cold and warm) of 4 steps of the
    kernel_impl='pallas' sampler on the one-rank mesh against the
    single-card sampler (n=256, p=128, bisect with 40 passes)."""
    X, y, theta0 = _linreg_problem(seed=seed, n_particles=256, n_feats=128)
    batch = _linreg_batch(X, y, dev)
    errs = []
    for warm in (False, True):
        common = dict(median="bisect", median_passes=40,
                      kernel_impl="pallas", pallas_block=128,
                      warm_median=warm)
        single = _port_sampler(X, y, theta0, dev, **common)
        sharded = _port_sampler(X, y, theta0, dev, mesh=mesh, **extra,
                                **common)
        single.run(batch, 4)
        sharded.run(batch, 4)
        err = float(np.max(np.abs(sharded.samples - single.samples)))
        print(f"[fidelity] {label}-{'warm' if warm else 'cold'}: max abs "
              f"{err:.3e} (bound 0: bitwise)")
        errs.append(err)
    return errs


@pytest.mark.cuda
def test_sharded_pallas_bitwise_vs_single_chip(nccl):
    """:216 -- the JAX test holds the Mosaic kernel inside shard_map on a
    1-device mesh bitwise to the single chip. The port's counterpart: the
    one-rank NCCL mesh's kernel_impl='pallas' sampler against the
    single-card sampler, cold and warm. Both reach B3 with the same rows,
    columns, centre and h^2 (the psum'd counts of one rank are its own),
    so bitwise."""
    mesh = nccl[0]
    assert _mesh_vs_single(mesh, mesh.device, 2, "sharded-pallas") == [0, 0]


# ------------------------------------------------- cancellation, KSD
def _numpy_sq_dists(theta):
    r = np.sum(theta * theta, axis=1, keepdims=True)
    return r + r.T - 2.0 * theta @ theta.T


def test_gram_cancellation_precision(device):
    """:261 -- particles ~1e-3 apart at norm ~8: max(D) ~ 1e-4 against
    Gram terms ~64. The f32 formula's error is ~0.1 x max(D), bf16 inputs
    ~6e3 x. pairwise_sq_dists (IEEE f32: torch.matmul with TF32 off) and,
    on the card, B4's tensor-core Gram (gram_stage.cuh, mma.sync 3xTF32;
    about the column mean, so its D is of the centred particles) must
    each be < 1 x max(D) and within 4x the host f32 formula's error."""
    rng = np.random.default_rng(3)
    base = rng.normal(size=(1, 64))
    theta = base + rng.normal(size=(128, 64)) * 1e-3
    D_ref = _numpy_sq_dists(theta)
    scale = D_ref.max()
    t32 = theta.astype(np.float32)
    r32 = np.sum(t32 * t32, axis=1, keepdims=True, dtype=np.float32)
    D_host32 = r32 + r32.T - np.float32(2.0) * (t32 @ t32.T)
    err_host = np.abs(D_host32 - D_ref).max() / scale
    th = _t(theta, device)
    errs = {"pairwise_sq_dists": pairwise_sq_dists(th),
            "B4 dist_block": fused_median.dist_block(
                th, th, svgd_tile.column_center(th))}
    for name, D in errs.items():
        err = np.abs(_np(D) - D_ref).max() / scale
        print(f"[fidelity] gram cancellation, {name} ({device.type}): "
              f"{err:.3e} x max(D) (bound < 1 and < 4 x host-f32 "
              f"{err_host:.3e}; bf16 regime ~6e3)")
        assert err < 1.0, (name, err)
        assert err < 4.0 * err_host + 1e-6, (name, err, err_host)


def test_ksd_precision(device):
    """:302 -- KSD's cross terms cancel like D; f32 KSD within 1e-3
    (relative, or absolute below 1) of the f64 value."""
    rng = np.random.default_rng(4)
    theta = rng.normal(size=(128, 32)) * 0.1
    grads = -theta * 25.0      # score of N(0, 0.2^2 I)
    got = float(ksd_rbf(_t(theta, device), _t(grads, device)))
    D = _numpy_sq_dists(theta)
    n, p = theta.shape
    h2 = np.median(D) / np.log(n)
    K = np.exp(-D / h2 / 2.0)
    SS = grads @ grads.T
    ST = grads @ theta.T
    d = np.sum(grads * theta, axis=1)
    cross = d[:, None] + d[None, :] - ST - ST.T
    ref = float(np.mean(K * (SS + cross / h2 + p / h2 - D / (h2 * h2))))
    bound = 1e-3 * max(1.0, abs(ref))
    print(f"[fidelity] ksd ({device.type}): f32 {got:.6g} vs f64 {ref:.6g}"
          f", |diff| {abs(got - ref):.3e} (bound {bound:.3e})")
    assert abs(got - ref) < bound


@pytest.mark.cuda
def test_fused_warm_median_bitwise_on_tpu(card):
    """:326 -- B2 (the single-kernel warm median) bitwise equal to the
    plain warm search (ops.median._warm_search) on the card, at the JAX
    test's shapes, passes and hints."""
    rng = np.random.default_rng(7)
    checked = 0
    for n, m, wp in ((1000, 512, 6), (4096, 128, 8), (777, 512, 4)):
        theta = rng.normal(size=(n, 32)) * rng.uniform(0.01, 10.0)
        th = _t(theta, card)
        rsq = torch.sum(th * th, dim=1)
        D = rsq[:, None] + rsq[None, :] - 2.0 * th @ th.T
        D_sub = _strided_rows(D, m)
        approx = float(np.median(_np(D_sub)))
        for med_prev in (0.0, approx, 0.8 * approx, 1.25 * approx,
                         0.3 * approx, 5.0 * approx):
            hint = torch.tensor(med_prev, dtype=F32, device=card)
            want = _warm_search(D_sub, hint, wp).item()
            got = fused_median.fused_warm_median_rows(D_sub, hint,
                                                      warm_passes=wp).item()
            assert got == want, (n, m, wp, med_prev, got, want)
            checked += 1
    print(f"[fidelity] fused warm median: {checked} cases bitwise (bound 0)")


# ------------------------------------------------------- fused tails
def test_f32_fused_step_matches_f64_oracle(device):
    """:355 -- step_impl='fused' (B1's D-given chain with B10 on the card)
    against the oracle at the kernels' class."""
    X, y, theta0 = _linreg_problem(seed=3, n_particles=384, n_feats=64)
    ref, amb = _oracle_trajectory(X, y, theta0, 5, amb_tol=3e-3)
    got = _port_trajectory(X, y, theta0, 5, device, median="bisect",
                           median_passes=40, warm_median=True,
                           warm_passes=16, step_impl="fused")
    _assert_trajectory_close(got, ref, amb,
                             f"fused step tail ({device.type})", bound=5e-3)


def test_f32_fused_gram_step_matches_f64_oracle(device):
    """:368 -- step_impl='fused_gram' (B1 with its tensor-core Gram)
    against the oracle at the kernels' class."""
    X, y, theta0 = _linreg_problem(seed=5, n_particles=384, n_feats=64)
    ref, amb = _oracle_trajectory(X, y, theta0, 5, amb_tol=3e-3)
    got = _port_trajectory(X, y, theta0, 5, device, median="bisect",
                           median_passes=40, warm_median=True,
                           warm_passes=16, step_impl="fused_gram")
    _assert_trajectory_close(got, ref, amb,
                             f"fused_gram step tail ({device.type})",
                             bound=5e-3)


def test_fused_step_matches_xla_warm_on_chip(device):
    """:382 -- the fused tail against the plain warm path: fewer than 0.5%
    of coordinates off rtol/atol 3e-3 (isolated Adam sign flips)."""
    X, y, theta0 = _linreg_problem(seed=4, n_particles=384, n_feats=64)
    kw = dict(median="bisect", warm_median=True, warm_passes=6)
    a = _port_trajectory(X, y, theta0, 5, device, **kw)
    b = _port_trajectory(X, y, theta0, 5, device, step_impl="fused", **kw)
    frac_bad = float(np.mean(~np.isclose(b, a, rtol=3e-3, atol=3e-3)))
    print(f"[fidelity] fused-vs-xla ({device.type}): flip fraction "
          f"{frac_bad:.5f} (bound 0.005)")
    assert frac_bad < 0.005


@pytest.mark.cuda
def test_fused_step_posterior_statistics_on_chip(card):
    """:404 -- throughput_config(512, 8) (fused_gram) for 1500 steps lands
    on the conjugate posterior."""
    X, y, mean, cov, n, p = _linreg_posterior(11)
    cfg = throughput_config(n, p)
    assert cfg["step_impl"] == "fused_gram"
    model = LinearRegressionModel(p)
    s = SVGDSampler(n, model.log_p, model.template(), Adam(learning_rate=5e-2),
                    generator=torch.Generator(card).manual_seed(0),
                    device=card, **cfg)
    s.run(_linreg_batch(X, y, card), 1500)
    _assert_posterior("fused-step posterior", s.samples, mean, cov, n)


@pytest.mark.cuda
def test_ring_layout_bitwise_vs_single_chip(nccl):
    """:445 -- comm='ring' with the tile on the one-rank NCCL mesh against
    the single-card sampler, cold and warm: the ring's one rotation is the
    same B3 call on the same block, so bitwise."""
    mesh = nccl[0]
    assert _mesh_vs_single(mesh, mesh.device, 6, "ring",
                           comm="ring") == [0, 0]


@pytest.mark.cuda
def test_streaming_ksd_at_scale_on_chip(card):
    """:483 -- ksd_rbf at n=10240 (the streaming row-blocked form) runs on
    the card, is finite, and is within 0.5 x |val| + 1e-3 of the dense KSD
    of a strided half."""
    rng = np.random.default_rng(9)
    n, p = 10240, 64
    theta = _t(rng.normal(size=(n, p)) * 0.1, card)
    grads = _t(rng.normal(size=(n, p)), card)
    h2 = torch.tensor(1.3, dtype=F32, device=card)
    val = float(ksd_rbf(theta, grads, h2=h2))
    assert np.isfinite(val)
    t0 = time.perf_counter()
    for _ in range(5):
        val = float(ksd_rbf(theta, grads, h2=h2))
    dt = (time.perf_counter() - t0) / 5
    sub = float(ksd_rbf(theta[::2], grads[::2], h2=h2))
    print(f"[fidelity] streaming KSD n={n}: {val:.4e} ({dt * 1e3:.1f} ms a "
          f"call); strided half {sub:.4e}, |diff| {abs(val - sub):.3e} "
          f"(bound {0.5 * abs(val) + 1e-3:.3e})")
    assert abs(val - sub) < 0.5 * abs(val) + 1e-3


@pytest.mark.cuda
def test_default_precision_posterior_statistics_on_chip(card):
    """:512 -- the model's precision='default' with throughput_config's
    fused_gram tail samples the conjugate posterior (the port's models
    accept the field; their products are f32 at every setting)."""
    X, y, mean, cov, n, p = _linreg_posterior(13)
    model = LinearRegressionModel(p, precision="default")
    s = SVGDSampler(n, model.log_p, model.template(), Adam(learning_rate=5e-2),
                    generator=torch.Generator(card).manual_seed(0),
                    device=card, **throughput_config(n, p))
    s.run(_linreg_batch(X, y, card), 1500)
    _assert_posterior("default-precision posterior", s.samples, mean, cov,
                      n)


@pytest.mark.cuda
def test_fused_glm_posterior_statistics_on_chip(card):
    """:550 -- step_impl='fused_glm' (the glm stage and B1: the whole step
    in the chain) samples the conjugate posterior."""
    X, y, mean, cov, n, p = _linreg_posterior(17)
    model = LinearRegressionModel(p)
    batch = model.sufficient_batch(_linreg_batch(X, y, card))
    s = SVGDSampler(n, model.log_p, model.template(), Adam(learning_rate=5e-2),
                    generator=torch.Generator(card).manual_seed(0),
                    device=card, median="bisect", warm_median=True,
                    step_impl="fused_glm",
                    quadratic_form=model.quadratic_form, median_impl="fused")
    s.run(batch, 1500)
    _assert_posterior("fused_glm posterior", s.samples, mean, cov, n)


def test_off_origin_robustness_on_chip(device):
    """:590 -- off-origin clouds (||mean|| >> spread): the tile (B3, which
    centres about the column mean) against the f64 phi at shifts 10 and
    100, rel < 5e-3; then the fused_gram sampler at shift 100, finite and
    within rtol/atol 3e-3 of the plain warm path on all but 1% of the
    coordinates after 3 steps."""
    rng = np.random.default_rng(21)
    n, p = 1024, 128
    base = rng.normal(size=(n, p)) * 0.05
    grads32 = rng.normal(size=(n, p)).astype(np.float32)
    g64 = grads32.astype(np.float64)
    for shift in (10.0, 100.0):
        t64 = (base + shift / np.sqrt(p)).astype(np.float32).astype(
            np.float64)
        D64 = _numpy_sq_dists(t64)
        h2 = np.median(D64) / np.log(n)
        K64 = np.exp(-D64 / h2 / 2.0)
        phi64 = (K64 @ g64
                 + (K64.sum(1)[:, None] * t64 - K64 @ t64) / h2) / n
        got = _np(svgd_tile.svgd_phi(_t(t64, device), _t(grads32, device),
                                     torch.tensor(h2, dtype=F32,
                                                  device=device)))
        rel = np.abs(got - phi64).max() / np.abs(phi64).max()
        print(f"[fidelity] off-origin tile shift={shift} ({device.type}): "
              f"rel {rel:.3e} (bound 5e-3)")
        assert np.isfinite(rel) and rel < 5e-3, (shift, rel)

    X, y, theta0 = _linreg_problem(seed=23, n_particles=384, n_feats=64)
    theta0 = theta0 + 100.0 / np.sqrt(64)
    kw = dict(median="bisect", warm_median=True, warm_passes=16,
              median_passes=40)
    a = _port_trajectory(X, y, theta0, 3, device, **kw)
    b = _port_trajectory(X, y, theta0, 3, device, step_impl="fused_gram",
                         **kw)
    assert np.all(np.isfinite(b))
    frac_bad = float(np.mean(~np.isclose(b, a, rtol=3e-3, atol=3e-3)))
    print(f"[fidelity] off-origin fused_gram ({device.type}): flip "
          f"fraction {frac_bad:.5f} (bound 0.01)")
    assert frac_bad < 0.01


@pytest.mark.cuda
def test_fused_model_logreg_posterior_statistics_on_chip(card):
    """:644 -- step_impl='fused_model' (the logistic stage and B1) against
    the plain f32 path after 1200 steps: log_p_mean risen and within
    rtol 2e-3, posterior means within half the posterior std, variance
    ratios in (0.6, 1.7)."""
    rng = np.random.default_rng(23)
    n, d, n_obs = 512, 20, 128
    X = rng.normal(size=(n_obs, d))
    w_true = rng.normal(size=(d, 1))
    y = (X @ w_true + 0.5 * rng.normal(size=(n_obs, 1)) > 0).astype(
        np.float64)
    model = LogisticRegressionModel(d, n_train=n_obs, n_batch=n_obs)
    batch = _linreg_batch(X, y, card)
    theta0 = (rng.normal(size=(n, d + 1)) * 0.1).astype(np.float32)

    def make(step_impl, **kw):
        return SVGDSampler(n, model.log_p, model.template(),
                           Adam(learning_rate=5e-2), theta=theta0,
                           device=card, median="bisect", warm_median=True,
                           step_impl=step_impl, **kw)

    a = make("xla")
    b = make("fused_model", inkernel_model=model.inkernel_model)
    aux_a = a.run(batch, 1200)
    aux_b = b.run(batch, 1200)
    sa, sb = a.samples, b.samples
    assert np.isfinite(sb).all()
    lp_a, lp_b = _np(aux_a["log_p_mean"]), _np(aux_b["log_p_mean"])
    std_a = sa.std(axis=0)
    mean_diff = np.abs(sa.mean(axis=0) - sb.mean(axis=0))
    ratio = sb.var(axis=0) / sa.var(axis=0)
    print(f"[fidelity] fused_model logreg: log_p_mean {lp_b[-1]:.6g} vs "
          f"{lp_a[-1]:.6g} (rtol {abs(lp_b[-1] / lp_a[-1] - 1):.3e}, bound "
          f"2e-3); mean diff / std max {(mean_diff / std_a).max():.3f} "
          f"(bound 0.5); var ratio {ratio.min():.3f}-{ratio.max():.3f} "
          "(bound 0.6-1.7)")
    assert lp_b[-1] > lp_b[0]
    np.testing.assert_allclose(lp_b[-1], lp_a[-1], rtol=2e-3)
    assert np.all(mean_diff < 0.5 * std_a), mean_diff / std_a
    assert np.all(ratio > 0.6) and np.all(ratio < 1.7), ratio


@pytest.mark.cuda
def test_bfloat16_end_to_end_posterior_on_chip(card):
    """:697 -- the whole sampler in bfloat16 (particles, moments, phi; the
    model's math in f32) samples a correlated Gaussian: the mean within 4
    Monte-Carlo scales, the covariance within 0.55, variances > 0.3."""
    mu = np.array([1.0, -2.0, 0.5])
    cov = np.array([[1.0, 0.7, 0.2], [0.7, 1.5, -0.3], [0.2, -0.3, 0.8]])
    prec = _t(np.linalg.inv(cov), card)
    mut = _t(mu, card)

    def log_p(params, batch):
        d = params["x"].to(F32) - mut
        return -0.5 * d @ prec @ d

    n = 128
    sampler = SVGDSampler(
        n, log_p, {"x": torch.zeros(3, dtype=torch.bfloat16)},
        Adam(learning_rate=5e-2),
        generator=torch.Generator(card).manual_seed(1),
        dtype=torch.bfloat16, device=card)
    sampler.run(None, 1500)
    s = np.asarray(sampler.samples, np.float64)
    assert np.isfinite(s).all()
    mc = np.sqrt(np.diag(cov) / n)
    merr = np.abs(s.mean(axis=0) - mu).max()
    est = np.cov(s.T)
    print(f"[fidelity] bf16 end-to-end: mean err {merr:.4f} (bound "
          f"{4 * mc.max():.4f}), cov max err {np.abs(est - cov).max():.3f} "
          f"(bound 0.55), diag cov {np.diag(est).round(3)} (bound > 0.3)")
    np.testing.assert_allclose(s.mean(axis=0), mu, atol=4 * mc.max())
    np.testing.assert_allclose(est, cov, atol=0.55)
    assert np.all(np.diag(est) > 0.3)


# ------------------------------------------------------------ meshes
def _mesh_problem(seed, device):
    rng = np.random.default_rng(seed)
    n, p = 512, 32
    X = rng.normal(size=(128, p))
    y = X @ rng.normal(size=(p, 1))
    theta0 = (rng.normal(size=(n, p)) * 0.1).astype(np.float32)
    model = LinearRegressionModel(p)
    common = dict(n_particles=n, log_p=model.log_p,
                  param_template=model.template(), theta=theta0,
                  device=device)
    return model, _linreg_batch(X, y, device), common


@pytest.mark.cuda
def test_fused_shard_one_device_mesh_on_chip(nccl):
    """:743 -- fused_shard (B8, B3) on the one-rank NCCL mesh tracks the
    single-card fused_gram step over 10 steps (rtol 2e-2 / atol 1e-4:
    the same class, another tile and centre order), and the GLM's
    theta-only gather tracks the autodiff gradients on the mesh."""
    mesh = nccl[0]
    model, batch, common = _mesh_problem(31, mesh.device)
    common.update(median="bisect", warm_median=True, warm_passes=8)
    fs = SVGDSampler(gd=Adam(learning_rate=1e-1), mesh=mesh,
                     step_impl="fused_shard", **common)
    fs.run(batch, 10)
    sg = SVGDSampler(gd=Adam(learning_rate=1e-1), step_impl="fused_gram",
                     median_impl="fused", **common)
    sg.run(batch, 10)
    a, b = fs.samples, sg.samples
    assert np.isfinite(a).all()
    suff = model.sufficient_batch(batch)
    glm = SVGDSampler(gd=Adam(learning_rate=1e-1), mesh=mesh,
                      step_impl="fused_shard",
                      quadratic_form=model.quadratic_form, **common)
    glm.run(suff, 10)
    auto = SVGDSampler(gd=Adam(learning_rate=1e-1), mesh=mesh,
                       step_impl="fused_shard", **common)
    auto.run(suff, 10)
    c, d = glm.samples, auto.samples
    print(f"[fidelity] fused_shard vs fused_gram: max abs "
          f"{np.abs(a - b).max():.3e}; glm vs autodiff "
          f"{np.abs(c - d).max():.3e} (bound rtol 2e-2 / atol 1e-4)")
    np.testing.assert_allclose(a, b, rtol=2e-2, atol=1e-4)
    np.testing.assert_allclose(c, d, rtol=2e-2, atol=1e-4)


def test_pallas_grads_match_autodiff_on_chip(device):
    """:791 -- the NN gradient kernel (B7; its plain version on the CPU)
    against torch.func autodiff at n=1000, B=20, H=100: rel < 1e-4, log_p
    within rtol/atol 1e-4."""
    rng = np.random.default_rng(7)
    n, B, f, H = 1000, 20, 1, 100
    model = BayesianNNModel(f, H, n_train=B, n_batch=B, prior_beta=10.0)
    n_params, unravel = template_unraveler(model.template())
    theta = _t(rng.normal(size=(n, n_params)) * 0.3, device)
    X = rng.uniform(size=(B, f)).astype(np.float32)
    y = np.cos(10 * X) * (5 * X) + rng.normal(size=(B, 1)) * 0.1
    batch = {"X": _t(X, device), "y": _t(y, device)}
    lp_ref, g_ref = _make_grad_all(model.log_p, unravel)(theta, batch)
    lp, g = model.pallas_grads()(theta, batch)
    g, g_ref = _np(g), _np(g_ref)
    rel = np.abs(g - g_ref).max() / np.abs(g_ref).max()
    lp_err = np.abs(_np(lp) - _np(lp_ref)).max()
    print(f"[fidelity] pallas_grads ({device.type}): max rel {rel:.3e} "
          f"(bound 1e-4), log_p max abs {lp_err:.3e} (bound 1e-4 + 1e-4 "
          "rel)")
    assert rel < 1e-4
    np.testing.assert_allclose(_np(lp), _np(lp_ref), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_fused_shard_grid_and_ring_on_chip(nccl):
    """:822 -- median_collectives='grid' (B9) and comm='ring' track the
    rounds arm (B8) on the one-rank NCCL mesh over 10 steps: rtol 1e-3 /
    atol 1e-6."""
    mesh = nccl[0]
    _, batch, common = _mesh_problem(17, mesh.device)
    common.update(median="bisect", warm_median=True, warm_passes=8,
                  mesh=mesh, step_impl="fused_shard")
    rounds = SVGDSampler(gd=Adam(learning_rate=1e-1),
                         median_collectives="rounds", **common)
    rounds.run(batch, 10)
    ref = rounds.samples
    assert np.isfinite(ref).all()
    out = {}
    for name, kw in (("grid", {}), ("ring", dict(comm="ring"))):
        s = SVGDSampler(gd=Adam(learning_rate=1e-1),
                        median_collectives="grid", median_grid_g1=8, **kw,
                        **common)
        s.run(batch, 10)
        out[name] = s.samples
    print("[fidelity] grid / ring vs rounds: max abs "
          + " / ".join(f"{np.abs(v - ref).max():.3e}" for v in out.values())
          + " (bound rtol 1e-3 / atol 1e-6)")
    for v in out.values():
        np.testing.assert_allclose(v, ref, rtol=1e-3, atol=1e-6)


@pytest.mark.cuda
def test_mesh_custom_grads_on_chip(nccl):
    """:866 -- custom_grads (B7) inside the mesh step's gradient stage on
    the one-rank NCCL mesh reproduces the single-card trajectory over 5
    steps of train_on_batch (rtol 1e-6 / atol 1e-8)."""
    mesh = nccl[0]
    dev = mesh.device
    rng = np.random.default_rng(23)
    n, B, f, H = 256, 20, 1, 32
    model = BayesianNNModel(f, H, n_train=B, n_batch=B, prior_beta=10.0)
    n_params, _ = template_unraveler(model.template())
    theta0 = (rng.normal(size=(n, n_params)) * 0.05).astype(np.float32)
    X = rng.uniform(size=(B, f)).astype(np.float32)
    y = np.cos(10 * X) * (5 * X) + rng.normal(size=(B, 1)) * 0.1
    batch = {"X": _t(X, dev), "y": _t(y, dev)}
    common = dict(theta=theta0, median="bisect",
                  custom_grads=model.pallas_grads(), device=dev)
    mc = SVGDSampler(n, model.log_p, model.template(),
                     Adam(learning_rate=1e-2), mesh=mesh, **common)
    sc = SVGDSampler(n, model.log_p, model.template(),
                     Adam(learning_rate=1e-2), **common)
    for _ in range(5):
        mc.train_on_batch(batch)
        sc.train_on_batch(batch)
    err = np.abs(mc.samples - sc.samples).max()
    print(f"[fidelity] mesh custom_grads vs single card: max abs {err:.3e} "
          "(bound rtol 1e-6 / atol 1e-8)")
    np.testing.assert_allclose(mc.samples, sc.samples, rtol=1e-6, atol=1e-8)


@pytest.mark.cuda
def test_mesh2d_tuned_config_on_chip(nccl):
    """:905 -- throughput_config(model_axis=) on the 1 x 1 NCCL 2-D mesh
    (B10 on the psum'd D rows) tracks the same 2-D step with
    kernel_impl='xla' over 5 steps: rtol 2e-2 / atol 5e-3, the particle
    means rtol 1e-3 / atol 1e-4, their stds rtol 5e-3 / atol 1e-4."""
    mesh2 = nccl[1]
    _, batch, common = _mesh_problem(29, mesh2.device)
    n, p = 512, 32
    cfg = throughput_config(n, p, mesh=mesh2, model_axis="model")
    assert cfg["kernel_impl"] == "pallas"
    tuned = SVGDSampler(gd=Adam(learning_rate=1e-1), **common, **cfg)
    tuned.run(batch, 5)
    ref_cfg = dict(cfg, kernel_impl="xla")
    ref_cfg.pop("pallas_block")
    ref = SVGDSampler(gd=Adam(learning_rate=1e-1), **common, **ref_cfg)
    ref.run(batch, 5)
    a, b = tuned.samples, ref.samples
    print(f"[fidelity] mesh2d tuned vs xla: max abs {np.abs(a - b).max():.3e}"
          f" (bound rtol 2e-2 / atol 5e-3); means "
          f"{np.abs(a.mean(0) - b.mean(0)).max():.3e}, stds "
          f"{np.abs(a.std(0) - b.std(0)).max():.3e}")
    np.testing.assert_allclose(a, b, rtol=2e-2, atol=5e-3)
    np.testing.assert_allclose(a.mean(axis=0), b.mean(axis=0), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(a.std(axis=0), b.std(axis=0), rtol=5e-3,
                               atol=1e-4)
