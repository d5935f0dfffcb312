#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (stein_tpu_torch) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from csrc/, checks each against its
plain PyTorch version on the card, drives the port's paths through the
entry points a user calls (SVGDSampler(..., device="cuda",
**throughput_config(n, p[, model=])) then run(batch, k)), checks the
results, and times the steps and the kernels. Phases:

  1. device   the card's name and power limit (nvidia-smi), the TF32 flags
  2. build    nvcc of csrc/ into build/stein_tpu_torch/, its seconds
  3. kernels  B2 bitwise against its plain version (cold and warm) on each
              path's block; B1's
              launch chain against the plain tail; B3, B4, B5 and B7
              against theirs, at the stated tolerances
  4. main     the bench's p=128 Bayesian linear regression at n=1000
              (B1, B2): launch counts of run(batch, 500), finiteness, the
              first 10 steps against the CPU run, the posterior mean
              against the conjugate closed form
     main-nn  the Bayesian NN (n=1000, p=303; B7, B3, B5): run(batch,
              500), launch counts, log_p_mean rising, the first 10 steps
              against the CPU run
     main-nn-large  the same model at n=3000 (B7, B3, B4 then B2), 50
              steps, 5 against the CPU run
     large-n  linear regression at n=10240 (B3, B2), 50 steps, 4 against
              the plain functions on the card
  5. timing   per-step time of run() with the kernels and with the plain
              functions on the card, and each kernel against its plain
              version (CUDA events; plain, kernel, kernel, plain)

Every phase prints its lines; a failed check raises and the script exits
non-zero. The line before the last is the kernel table as JSON, the last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or without the package beside the script, it exits
with code 2 and prints no result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

N, P, N_OBS, SEED = 1000, 128, 1000, 0
STEPS = 500
MEDIAN_ROWS = 256
# Bound on max_j |mean_i theta_ij - posterior_mean_j| after STEPS steps.
# The JAX package's own fused_gram run of this recipe (CPU, interpret mode)
# lands at POSTERIOR_JAX; the port's plain versions on the CPU at 0.0166
# (the trajectories part chaotically, so this spread is the run-to-run
# class). The bound is 4x the JAX value, about one posterior standard
# deviation of a coordinate (~0.03); the particles start 2.3 away.
POSTERIOR_JAX = 0.00874154569006752
POSTERIOR_BOUND = 4 * POSTERIOR_JAX


def log(*parts):
    print(*parts, flush=True)


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def make_data(seed=SEED):
    """bench.py's recipe: X [1000, 128], y = X w + 0.3 noise, theta0 =
    0.01 N(0, I), all from one numpy generator."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N_OBS, P))
    w = rng.normal(size=(P, 1))
    y = X @ w + rng.normal(size=(N_OBS, 1)) * 0.3
    theta0 = rng.normal(size=(N, P)) * 0.01
    return X, y, theta0


def gpu_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, torch):
    """Mean ms of fn() over reps launches, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(plain, kernel, reps, torch):
    """(kernel ms, plain ms), each the mean of two timings taken in the
    order plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, reps, torch)
    k1 = cuda_ms(kernel, reps, torch)
    k2 = cuda_ms(kernel, reps, torch)
    p2 = cuda_ms(plain, reps, torch)
    return (k1 + k2) / 2, (p1 + p2) / 2


def norm_err(a, b):
    """max |a - b| / max |b| (0 when both are 0)."""
    a = a.double().cpu()
    b = b.double().cpu()
    scale = b.abs().max().item()
    diff = (a - b).abs().max().item()
    return diff / scale if scale else diff


# ------------------------------------------------------------ NN slice

NN_N, NN_P, NN_LARGE = 1000, 303, 3000
NN_STEPS, NN_LARGE_STEPS, LARGE_N, LARGE_STEPS = 500, 50, 10240, 50
# log_p_mean of this recipe rises over the first ~10 steps and then falls
# as the particles spread (the weight precision shrinks): the JAX package's
# own run of it (CPU, median='bisect', warm_median=True, the autodiff
# gradients) reads -17.879913 at step 1, -16.133768 at step 11 and
# NN_LOGP_JAX at step 500. The port must rise over the first 10 steps and
# land within 1% of the JAX value at step 500.
NN_LOGP_JAX = -40.89201


def nn_data(n, seed=11):
    """bench.py's nn recipe: 20 observations of y = cos(10 x) 5 x + noise
    from numpy seed 11; theta0 = 0.01 N(0, I) from the same generator."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(20, 1))
    y = rng.normal(np.cos(10 * X) * (5 * X), 0.1)
    theta0 = rng.normal(size=(n, NN_P)) * 0.01
    return X, y, theta0


def lattice(n, p, dev, torch, seed=1):
    """Integer particles whose columns sum to 0: centre, norms, dots and
    so D are exact in any summation order."""
    half = np.random.default_rng(seed).integers(-3, 4, size=(n // 2, p))
    return torch.tensor(np.concatenate([half, -half]), dtype=torch.float32,
                        device=dev)


def adam_eps_regime(phi1, lr, b1=0.9, b2=0.999, eps=1e-8):
    """The coordinates where Adam's first step amplifies phi's roundings.
    The first step seeds mu = phi, nu = phi^2 and still divides by the
    bias corrections, so it is lr (phi / (1 - b1)) / (eps + |phi| /
    sqrt(1 - b2)), whose slope in phi, lr eps / ((1 - b1) (eps + |phi| /
    sqrt(1 - b2))^2), rises to lr / ((1 - b1) eps) = 1e8 at phi = 0 (lr
    0.1). Where it exceeds 10 (|phi| < ~1e-6) no bound on the samples
    follows from a bound on phi."""
    slope = lr / (1 - b1) * eps / (eps + np.abs(phi1) / np.sqrt(1 - b2)) ** 2
    return slope > 10


def check_class(label, what, got, want, steps, lr):
    """`got` against `want`, the run on `what` (dicts of numpy arrays:
    phi1, Adam's mu after step 1, i.e. the first clipped phi; samples,
    median and phi_norm after `steps` steps) at the fused_gram class:
    medians rtol 5e-3, phi_norm rtol 1e-4, phi1 and the samples rtol 2e-4
    / atol 1e-6. The samples in Adam's eps regime are held through phi1
    only, and that regime may hold at most 1 coordinate in 1000 (measured
    on the H100: 7.3e-5 at the NN shape, 7.5e-5 at n=3000, 1.6e-4 at
    n=10240, p=128)."""
    def excess(a, b):
        return float(np.max(np.abs(a - b) - (1e-6 + 2e-4 * np.abs(b))))

    med_rel = np.max(np.abs(got["median"] / want["median"] - 1))
    norm_rel = np.max(np.abs(got["phi_norm"] / want["phi_norm"] - 1))
    ill = adam_eps_regime(want["phi1"], lr)
    phi_ex = excess(got["phi1"], want["phi1"])
    s_ex = excess(got["samples"][~ill], want["samples"][~ill])
    ill_err = (np.abs(got["phi1"] - want["phi1"])[ill].max() if ill.any()
               else 0.0)
    log(f"[{label}] {steps} steps vs {what}: median rel {med_rel:.3e}, "
        f"phi_norm rel {norm_rel:.3e}; phi at step 1 excess over the class "
        f"{phi_ex:.3e} "
        f"({int(ill.sum())} coordinates in Adam's eps regime, their phi max "
        f"abs error {ill_err:.3e}); samples max abs "
        f"{np.abs(got['samples'] - want['samples']).max():.3e}, excess over "
        f"the class outside the eps regime {s_ex:.3e}")
    if (med_rel > 5e-3 or norm_rel > 1e-4 or phi_ex > 0 or s_ex > 0
            or ill.mean() > 1e-3):
        fail(f"{label}: the first {steps} steps left the reference's class")


def sampler_trial(make, batch, steps):
    """check_class's dict for make(): one sampler's first step, another's
    `steps` steps."""
    first = make()
    first.run(batch, 1)
    s = make()
    aux = s.run(batch, steps)
    return {"phi1": first.state.opt_state.mu.cpu().numpy(),
            "samples": s.samples, "median": aux["median"].cpu().numpy(),
            "phi_norm": aux["phi_norm"].cpu().numpy()}


def compare_with_cpu(make, batch, steps, label, lr):
    """The first `steps` steps of make("cuda") against make("cpu")."""
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    check_class(label, "the CPU", sampler_trial(lambda: make("cuda"), batch,
                                                steps),
                sampler_trial(lambda: make("cpu"), cpu_batch, steps), steps,
                lr)


def b2_case(label, D, fused_median, zero):
    """B2 bitwise against its plain version on the block D, cold (30
    passes) and warm (8 passes, hint 1.01 x the cold median). Returns the
    plain cold median."""
    cold_k = fused_median.fused_warm_median_rows(D, zero, 30)
    cold_p = fused_median.warm_search_on_value(D, zero, 30)
    warm_k = fused_median.fused_warm_median_rows(D, cold_p * 1.01, 8)
    warm_p = fused_median.warm_search_on_value(D, cold_p * 1.01, 8)
    log(f"[kernels] B2 {label} {list(D.shape)}: cold {cold_k.item()!r} vs "
        f"{cold_p.item()!r}, warm {warm_k.item()!r} vs {warm_p.item()!r}")
    if cold_k.item() != cold_p.item() or warm_k.item() != warm_p.item():
        fail(f"B2 ({label}) is not bitwise equal to its plain version")
    return cold_p


def check_new_kernels(dev, torch, fused_median, svgd_tile, bayesian_nn,
                      subsample_rows, row_subsample_block, nn_model,
                      nn_batch, nn_theta):
    """B2 at the new paths' blocks; B3, B4, B5 and B7 against their plain
    versions on the card. Returns the max abs error of each at the main
    path's shape."""
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)
    errs = {}

    # B7 on the main path's particles and batch, at a random (n, B, f, H)
    # of the same width, and at a second (f, H, B); the JAX suite's bounds:
    # logp rtol 2e-5 / atol 1e-5, grads atol 2e-5 max|g|.
    rng = np.random.default_rng(0)
    cases = [("main path", nn_model, nn_theta, nn_batch)]
    for n, B, f, H in ((NN_N, 20, 1, 100), (600, 12, 3, 50)):
        model = type(nn_model)(f, H, n_train=5 * B, n_batch=B,
                               prior_beta=10.0)
        p = f * H + 2 * H + 3
        theta = torch.tensor(rng.normal(size=(n, p)) * 0.3, dtype=f32,
                             device=dev)
        X = rng.uniform(size=(B, f))
        y = (np.cos(10 * X[:, :1]) * (5 * X[:, :1])
             + rng.normal(size=(B, 1)) * 0.1)
        batch = {"X": torch.tensor(X, dtype=f32, device=dev),
                 "y": torch.tensor(y, dtype=f32, device=dev)}
        cases.append((f"n={n} B={B} f={f} H={H}", model, theta, batch))
    for label, model, theta, batch in cases:
        lp, g = model.pallas_grads()(theta, batch)
        lp0, g0 = bayesian_nn.nn_grads_plain(
            theta, batch["X"], batch["y"].reshape(-1), model.n_feats,
            model.n_hidden, model._consts())
        lp_ex = ((lp - lp0).abs() - (1e-5 + 2e-5 * lp0.abs())).max().item()
        g_err = (g - g0).abs().max().item()
        g_bound = 2e-5 * g0.abs().max().item()
        log(f"[kernels] B7 {label}: logp excess over rtol 2e-5/atol 1e-5 "
            f"{lp_ex:.3e}, grads max abs {g_err:.3e} (bound {g_bound:.3e})")
        if lp_ex > 0 or g_err > g_bound:
            fail(f"B7 ({label}) disagrees with its plain version")
        if label == "main path":
            errs["B7"] = max((lp - lp0).abs().max().item(), g_err)
            g_path = g

    # B3: phi of the tile; <= 1e-4 normalised (lattice: 1e-5), two calls
    # bitwise equal. The main path's shape runs on its own particles and
    # gradients.
    def b3_case(label, rows, cols, grads, bound):
        sub = row_subsample_block(cols, 128)
        h2 = fused_median.warm_search_on_value(sub, zero, 30) / np.log(
            cols.shape[0])
        got = svgd_tile.svgd_phi_rect(rows, cols, grads, h2)
        again = svgd_tile.svgd_phi_rect(rows, cols, grads, h2)
        c = svgd_tile.column_center(cols)
        ku, ks = svgd_tile.svgd_both_ksum_plain(rows, cols, grads, h2, c)
        want = (ku + ks * (rows - c) / h2) / cols.shape[0]
        torch.cuda.synchronize()
        err = norm_err(got, want)
        log(f"[kernels] B3 {label}: normalised error {err:.3e} (bound "
            f"{bound:g}), repeat bitwise {torch.equal(got, again)}")
        if err > bound or not torch.equal(got, again):
            fail(f"B3 {label} disagrees with its plain version or itself")
        return (got - want).abs().max().item()

    errs["B3"] = b3_case(f"main path m=n={NN_N} p={NN_P}", nn_theta,
                         nn_theta, g_path, 1e-4)
    lat = lattice(NN_N, NN_P, dev, torch)
    lat_g = torch.tensor(rng.normal(size=(NN_N, NN_P)), dtype=f32,
                         device=dev)
    b3_case(f"lattice m=n={NN_N} p={NN_P}", lat, lat, lat_g, 1e-5)
    for m, n, p in ((LARGE_N, LARGE_N, 128), (3000, 3000, 640),
                    (300, NN_N, NN_P)):
        cols = torch.tensor(rng.normal(size=(n, p)), dtype=f32, device=dev)
        grads = torch.tensor(rng.normal(size=(n, p)), dtype=f32, device=dev)
        b3_case(f"m={m} n={n} p={p}", cols[:m], cols, grads, 1e-4)

    # B4 at (128, 3000, 303): bitwise on lattice particles, <= 1e-5
    # normalised on the n=3000 path's own particles. B2 then searches the
    # path's block bitwise as its plain version does.
    theta_l = torch.tensor(nn_data(NN_LARGE)[2], dtype=f32, device=dev)
    for kind, theta in (("lattice", lattice(NN_LARGE, NN_P, dev, torch)),
                        ("main-nn-large path", theta_l)):
        rows = subsample_rows(theta, 128)
        c = svgd_tile.column_center(theta)
        got = fused_median.dist_block(rows, theta, c)
        want = fused_median.dist_block_plain(rows, theta, c)
        torch.cuda.synchronize()
        err = norm_err(got, want)
        log(f"[kernels] B4 [128, {NN_LARGE}] p={NN_P} {kind}: normalised "
            f"error {err:.3e}, bitwise {torch.equal(got, want)}")
        if (kind == "lattice" and not torch.equal(got, want)) or err > 1e-5:
            fail(f"B4 ({kind}) disagrees with its plain version")
    errs["B4"] = (got - want).abs().max().item()
    b2_case("main-nn-large path (B4's block)", want, fused_median, zero)
    theta_n = torch.tensor(
        np.random.default_rng(3).normal(size=(LARGE_N, P)) * 0.01,
        dtype=f32, device=dev)
    b2_case("large-n path", row_subsample_block(theta_n, 128), fused_median,
            zero)

    # B5 at (128, 1000, 303): bitwise on lattice particles. On the main
    # path's particles, with the cold median x 1.01 as hint, within one
    # final interval of the tight bracket, (1.09 - 0.92) hint / 4^4; cold,
    # within one final interval of the full range, (max D - min(min D, 0))
    # / 4^15, or 2 ulps of the median where that is below f32's resolution
    # (D from two dot orders moves the range by an ulp).
    for kind, theta in (("lattice", lat), ("main path", nn_theta)):
        rows = subsample_rows(theta, 128)
        c = svgd_tile.column_center(theta)
        D = fused_median.dist_block_plain(rows, theta, c)
        cold = fused_median.warm_search_on_value(D, zero, 30)
        res = []
        for med_prev, passes in ((zero, 30), (cold * 1.01, 8)):
            k = fused_median.fused_warm_median_from_theta(
                rows, theta, med_prev, c, passes)
            p_ = fused_median.warm_search_on_value(D, med_prev, passes)
            res.append((k.item(), p_.item()))
        span = D.max().item() - min(D.min().item(), 0.0)
        cold_width = max(span / 4 ** 15,
                         2 * float(np.spacing(np.float32(res[0][1]))))
        width = (1.09 - 0.92) * cold.item() * 1.01 / 4 ** 4
        log(f"[kernels] B5 [128, {NN_N}] p={NN_P} {kind}: cold {res[0]} "
            f"(bound {cold_width:.3e}), warm {res[1]} (final interval "
            f"{width:.3e})")
        if kind == "lattice":
            if any(a != b for a, b in res):
                fail("B5 is not bitwise equal to its plain version on "
                     "lattice particles")
        else:
            if abs(res[0][0] - res[0][1]) > cold_width:
                fail("B5's cold median is off by more than its bound")
            if abs(res[1][0] - res[1][1]) > width * 1.0001:
                fail("B5's warm median is off by more than one final "
                     "interval")
            errs["B5"] = max(abs(a - b) for a, b in res)
    return errs


def reset(counters):
    for fn in counters.values():
        fn.launches = 0


def read(counters):
    return {k: fn.launches for k, fn in counters.items()}


def run_nn_paths(dev, torch, nn_model, counters):
    """[main-nn], [main-nn-large] and [large-n]; returns each path's
    launch counts, the NN path's sampler and batch, the large-n path's."""
    from stein_tpu_torch import Adam, SVGDSampler, throughput_config
    from stein_tpu_torch.api import _make_grad_all
    from stein_tpu_torch.models import LinearRegressionModel

    f32 = torch.float32
    X, y, theta0 = nn_data(NN_N)
    batch = {"X": torch.tensor(X, dtype=f32, device=dev),
             "y": torch.tensor(y, dtype=f32, device=dev)}

    def nn_sampler(n, theta, device):
        return SVGDSampler(n, nn_model.log_p, nn_model.template(),
                           Adam(0.1, decay=0.999), theta=theta,
                           device=device,
                           **throughput_config(n, NN_P, model=nn_model))

    kw = throughput_config(NN_N, NN_P, model=nn_model)
    log(f"[main-nn] throughput_config({NN_N}, {NN_P}, model=...) = "
        f"{ {k: (v if not callable(v) else 'pallas_grads()') for k, v in kw.items()} }")
    sampler = nn_sampler(NN_N, theta0, "cuda")
    reset(counters)
    t0 = time.perf_counter()
    aux = sampler.run(batch, NN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    nn_counts = read(counters)
    log(f"[main-nn] run(batch, {NN_STEPS}) in {wall:.2f} s (first call), "
        f"launches {nn_counts}")
    want = dict.fromkeys(counters, 0)
    want.update(B7=NN_STEPS, B3=NN_STEPS, B5=NN_STEPS + 1)
    if nn_counts != want:
        fail(f"[main-nn] launch counts {nn_counts}, expected {want}")
    samples = sampler.samples
    if not np.all(np.isfinite(samples)) or samples.shape != (NN_N, NN_P):
        fail("[main-nn] non-finite or misshapen samples")
    for key, v in aux.items():
        if tuple(v.shape) != (NN_STEPS,) or not torch.isfinite(v).all():
            fail(f"[main-nn] aux[{key!r}] is not {NN_STEPS} finite values")
    lp = aux["log_p_mean"]
    log(f"[main-nn] log_p_mean step 1 {lp[0].item():.6g}, step {NN_STEPS} "
        f"{lp[-1].item():.6g}; last step: " + ", ".join(
            f"{k}={v[-1].item():.6g}" for k, v in aux.items()))
    log(f"[main-nn] log_p_mean step 10 {lp[9].item():.6g}; JAX package at "
        f"step {NN_STEPS}: {NN_LOGP_JAX}")
    if not lp[9].item() > lp[0].item():
        fail("[main-nn] log_p_mean did not rise over the first 10 steps")
    if abs(lp[-1].item() / NN_LOGP_JAX - 1) > 0.01:
        fail(f"[main-nn] log_p_mean at step {NN_STEPS} is not within 1% of "
             "the JAX package's")
    compare_with_cpu(lambda d: nn_sampler(NN_N, theta0, d), batch, 10,
                     "main-nn", 0.1)

    # The B4 -> B2 route: n=3000 is past bracket_pass_fits(128, 3000, 303).
    _, _, theta_l = nn_data(NN_LARGE)
    large = nn_sampler(NN_LARGE, theta_l, "cuda")
    reset(counters)
    aux_l = large.run(batch, NN_LARGE_STEPS)
    torch.cuda.synchronize()
    large_counts = read(counters)
    log(f"[main-nn-large] n={NN_LARGE}: run(batch, {NN_LARGE_STEPS}) "
        f"launches {large_counts}")
    want = dict.fromkeys(counters, 0)
    want.update(B7=NN_LARGE_STEPS, B3=NN_LARGE_STEPS,
                B4=NN_LARGE_STEPS + 1, B2=NN_LARGE_STEPS + 1)
    if large_counts != want:
        fail(f"[main-nn-large] launch counts {large_counts}, expected {want}")
    if not np.all(np.isfinite(large.samples)) or not all(
            torch.isfinite(v).all() for v in aux_l.values()):
        fail("[main-nn-large] non-finite output")
    compare_with_cpu(lambda d: nn_sampler(NN_LARGE, theta_l, d), batch, 5,
                     "main-nn-large", 0.1)

    # Large-n linear regression: the tile (B3) and the fused rows search
    # (B2) on the 128-row block.
    Xl, yl, _ = make_data()
    lr_model = LinearRegressionModel(P)
    lr_batch = {"X": torch.tensor(Xl, dtype=f32, device=dev),
                "y": torch.tensor(yl, dtype=f32, device=dev)}
    theta_n = np.random.default_rng(3).normal(size=(LARGE_N, P)) * 0.01
    kw = throughput_config(LARGE_N, P)
    log(f"[large-n] throughput_config({LARGE_N}, {P}) = "
        f"{ {k: str(v) for k, v in kw.items()} }")

    def lr_sampler():
        return SVGDSampler(LARGE_N, lr_model.log_p, lr_model.template(),
                           Adam(1e-1), theta=theta_n, device="cuda", **kw)

    big = lr_sampler()
    reset(counters)
    aux_n = big.run(lr_batch, LARGE_STEPS)
    torch.cuda.synchronize()
    n_counts = read(counters)
    log(f"[large-n] run(batch, {LARGE_STEPS}) launches {n_counts}; last "
        "step: " + ", ".join(f"{k}={v[-1].item():.6g}"
                             for k, v in aux_n.items()))
    want = dict.fromkeys(counters, 0)
    want.update(B3=LARGE_STEPS, B2=LARGE_STEPS + 1)
    if n_counts != want:
        fail(f"[large-n] launch counts {n_counts}, expected {want}")
    if not np.all(np.isfinite(big.samples)) or not all(
            torch.isfinite(v).all() for v in aux_n.values()):
        fail("[large-n] non-finite output")
    # The first 4 steps against the same steps with every kernel's plain
    # version on the card (the plain tile at n=10240 holds a 420 MB K).
    # Not 5: at step 5 one coordinate of the 1.31M leaves the class by 7e-6
    # (H100 run), one whose Adam first moment crosses zero there (mu
    # -2.5e-5, sqrt(nu) 1.5e-4 against ~1e-2 for most), so its step's slope
    # in phi is ~10x a typical coordinate's.
    k = 4
    run = plain_pallas_runner(lr_sampler(), lr_batch, _make_grad_all(
        lr_model.log_p, big.unravel_fn), gram=False)
    _, opt1, _, _ = run(1)
    theta_k, _, meds, norms = run(k)
    check_class("large-n", "the plain functions on the card",
                sampler_trial(lr_sampler, lr_batch, k),
                {"phi1": opt1.mu.cpu().numpy(),
                 "samples": theta_k.cpu().numpy(),
                 "median": torch.stack(meds).cpu().numpy(),
                 "phi_norm": torch.stack(norms).cpu().numpy()}, k, 0.1)
    return {"main-nn": nn_counts, "main-nn-large": large_counts,
            "large-n": n_counts}, sampler, batch, big, lr_batch


def plain_pallas_runner(sampler, batch, grad_fn, gram):
    """run() of a kernel_impl='pallas' sampler with every kernel's plain
    version called on the card's tensors. run(k) starts from the sampler's
    state and returns (theta, optimizer state, [median], [phi_norm]) after
    k steps; the sampler is not advanced."""
    import torch
    from stein_tpu_torch.ops import fused_median, rbf, svgd_tile
    from stein_tpu_torch.ops.median import row_subsample_block, subsample_rows

    n = sampler.n_particles

    def median(theta, med_prev, passes):
        if gram:
            rows = subsample_rows(theta, 128)
            c = svgd_tile.column_center(theta)
            D = fused_median.dist_block_plain(rows, theta, c)
        else:
            D = row_subsample_block(theta, 128)
        return fused_median.warm_search_on_value(D, med_prev, passes)

    def run(n_steps):
        s = sampler.state
        theta, opt = s.particles, s.opt_state
        med = median(theta, torch.zeros((), device=theta.device), 30)
        meds, norms = [], []
        for _ in range(n_steps):
            _, grads = grad_fn(theta, batch)
            med = median(theta, med, 8)
            h2 = rbf.bandwidth_sq_from_median(med, n)
            c = svgd_tile.column_center(theta)
            ku, ks = svgd_tile.svgd_both_ksum_plain(theta, theta, grads, h2,
                                                    c)
            phi = (ku + ks * (theta - c) / h2) / n
            norm = torch.sqrt(torch.sum(phi * phi))
            phi = phi * (10.0 / torch.clamp(norm, min=10.0))
            delta, opt = sampler.gd.update(opt, phi)
            theta = theta + delta
            meds.append(med)
            norms.append(norm)
        return theta, opt, meds, norms
    return run


def run_timed(fn, torch, steps):
    """µs per step of fn(steps) by CUDA events, after a warm-up call."""
    fn(10)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn(steps)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps * 1e3


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "stein_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(stein_tpu_torch/ is missing beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)

    from stein_tpu_torch import Adagrad, Adam, SVGDSampler, throughput_config
    from stein_tpu_torch import _cuda
    from stein_tpu_torch.api import _make_grad_all
    from stein_tpu_torch.models import BayesianNNModel, LinearRegressionModel
    from stein_tpu_torch.models import bayesian_nn
    from stein_tpu_torch.ops import fused_median, fused_step, svgd_tile
    from stein_tpu_torch.ops.median import (
        row_subsample_block,
        subsample_rows,
    )
    from stein_tpu_torch.ops.optimizers import AdagradState, AdamState
    from stein_tpu_torch.utils.ravel import template_unraveler

    # ---------------------------------------------------------- 1. device
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    log(f"[device] {gpu} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | count {torch.cuda.device_count()}")
    log(f"[device] tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    assert "jax" not in sys.modules, "the port imported jax"

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    lib = _cuda.library()
    log(f"[build] {time.perf_counter() - t0:.1f} s (nvcc "
        f"{lib.build_seconds:.1f} s)")
    for line in lib.build_log.splitlines():
        if any(w in line for w in ("registers", "Compiling entry", "spill")):
            log(f"[build] {line.strip()}")

    # --------------------------------------------------------- 3. kernels
    X, y, theta0 = make_data()
    f32 = torch.float32
    model = LinearRegressionModel(P)
    batch = {"X": torch.tensor(X, dtype=f32, device=dev),
             "y": torch.tensor(y, dtype=f32, device=dev)}
    theta = torch.tensor(theta0, dtype=f32, device=dev)

    # B2 on the main path's block: bitwise, cold (30 passes) and warm (8).
    D_sub = row_subsample_block(theta, MEDIAN_ROWS)
    zero = torch.zeros((), dtype=f32, device=dev)
    cold_p = b2_case("main path", D_sub, fused_median, zero)
    b2_err = 0.0   # bitwise, or b2_case failed

    def tail_inputs(theta_in, rule, phi_sq):
        """(gd, state): a step rule and a state past its first step (count
        5, second moment at the scale of phi^2), so each update is linear
        in phi instead of Adam's sign-like first step."""
        nu = torch.full((N, P), phi_sq, dtype=f32, device=dev)
        count = torch.full((), 5, dtype=torch.int32, device=dev)
        lr = torch.full((), 0.1, dtype=f32, device=dev)
        if rule == "adam":
            return (Adam(1e-1, decay=0.999),
                    AdamState(torch.zeros_like(nu), nu, count, lr))
        return Adagrad(5e-2), AdagradState(nu, count, lr)

    def run_both(theta_in, grads, med_prev, gd, state):
        sub = subsample_rows(theta_in, MEDIAN_ROWS)
        k = fused_step.fused_warm_step_tail(
            theta_in, grads, None, None, med_prev, state, gd,
            gram_in_kernel=True, theta_sub=sub)
        p = fused_step._plain_tail(theta_in, grads, sub, med_prev, state,
                                   gd, 10.0, 8, fused_step.DEFAULT_BRACKETS)
        torch.cuda.synchronize()
        return k, p

    def outputs(res):
        new_theta, st, stats = res
        return [new_theta, *[t for t in st if t.dim() == 2], *stats]

    # (i) Lattice particles: integer coordinates with every column summing
    # to 0, so the centre, the Gram and D are exact in any summation order
    # and both sides search the same D. Median and h^2 must be bitwise
    # equal; the rest differs only by the order of the K @ u sums:
    # max|a-b| / max|b| <= 1e-5.
    rng = np.random.default_rng(1)
    half = rng.integers(-3, 4, size=(N // 2, P))
    lat = torch.tensor(np.concatenate([half, -half]), dtype=f32, device=dev)
    grads = torch.tensor(rng.normal(size=(N, P)), dtype=f32, device=dev)
    med_lat = fused_median.fused_warm_median_rows(
        row_subsample_block(lat, MEDIAN_ROWS), zero, 30)
    for rule in ("adam", "adagrad"):
        gd, state = tail_inputs(lat, rule, 1.0)
        k, p = run_both(lat, grads, med_lat, gd, state)
        if k[2][0].item() != p[2][0].item() or k[2][2].item() != p[2][2].item():
            fail(f"B1 ({rule}, lattice): median/h2 {k[2][0].item()!r}/"
                 f"{k[2][2].item()!r} vs {p[2][0].item()!r}/"
                 f"{p[2][2].item()!r}")
        errs = [norm_err(a, b) for a, b in zip(outputs(k), outputs(p))]
        log(f"[kernels] B1 lattice {rule}: med bitwise, normalised errors "
            f"{['%.2e' % e for e in errs]}")
        if max(errs) > 1e-5:
            fail(f"B1 ({rule}, lattice) off by {max(errs):.3e} > 1e-5")
        if int(k[1].count) != 6 or int(p[1].count) != 6:
            fail("B1 did not advance the optimizer count")

    # (ii) The main path's own inputs (the bench's theta0, the model's
    # gradients there, the cold median as hint). D now comes from two f32
    # dot orders, so a count may flip at a threshold: the medians agree to
    # one final interval of the tight bracket, (1.09-0.92) med / 4^4
    # (6.6e-4 relative), and the rest to 1e-2 normalised (K moves by
    # ~log(n)/2 times the h^2 change).
    grad_all = _make_grad_all(model.log_p,
                              template_unraveler(model.template())[1])
    _, g0 = grad_all(theta, batch)
    b1_err = 0.0
    for rule in ("adam", "adagrad"):
        # The second moment at the scale of the clipped phi's mean square.
        gd, state = tail_inputs(theta, rule, 1.0)
        norm = fused_step._plain_tail(
            theta, g0, subsample_rows(theta, MEDIAN_ROWS), cold_p, state,
            gd, 10.0, 8, fused_step.DEFAULT_BRACKETS)[2][1].item()
        gd, state = tail_inputs(theta, rule, min(norm, 10.0) ** 2 / (N * P))
        k, p = run_both(theta, g0, cold_p, gd, state)
        med_k, med_p = k[2][0].item(), p[2][0].item()
        width = (1.09 - 0.92) * cold_p.item() / 4 ** 4
        errs = [norm_err(a, b) for a, b in zip(outputs(k), outputs(p))]
        b1_err = max(b1_err, (k[0] - p[0]).abs().max().item())
        log(f"[kernels] B1 main-path {rule}: med {med_k!r} vs {med_p!r} "
            f"(final interval {width:.3e}), normalised errors "
            f"{['%.2e' % e for e in errs]}")
        if abs(med_k - med_p) > width * 1.0001:
            fail(f"B1 ({rule}) median off by more than one interval")
        if max(errs) > 1e-2:
            fail(f"B1 ({rule}, main path) off by {max(errs):.3e} > 1e-2")

    # B3, B4, B5, B7 on the NN path's own inputs and the stated shapes.
    nn_model = BayesianNNModel(1, 100, 20, 20, prior_beta=10.0)
    Xn, yn, theta_nn0 = nn_data(NN_N)
    nn_batch = {"X": torch.tensor(Xn, dtype=f32, device=dev),
                "y": torch.tensor(yn, dtype=f32, device=dev)}
    nn_theta = torch.tensor(theta_nn0, dtype=f32, device=dev)
    errs = check_new_kernels(dev, torch, fused_median, svgd_tile,
                             bayesian_nn, subsample_rows, row_subsample_block,
                             nn_model, nn_batch, nn_theta)

    # ------------------------------------------------------ 4. main path
    counters = {"B1": fused_step.fused_warm_step_tail,
                "B2": fused_median.fused_warm_median_rows,
                "B3": svgd_tile.svgd_both_ksum,
                "B4": fused_median.dist_block,
                "B5": fused_median.fused_warm_median_from_theta,
                "B7": bayesian_nn.nn_grads}
    kw = throughput_config(N, P)
    log(f"[main] throughput_config({N}, {P}) = "
        f"{ {k: str(v) for k, v in kw.items()} }")
    sampler = SVGDSampler(N, model.log_p, model.template(), Adam(1e-1),
                          theta=theta0, device="cuda", **kw)
    reset(counters)
    t0 = time.perf_counter()
    aux = sampler.run(batch, STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read(counters)
    log(f"[main] run(batch, {STEPS}) in {wall:.2f} s (first call), "
        f"launches {launches}")
    want = dict.fromkeys(counters, 0)
    want.update(B2=1, B1=STEPS)
    if launches != want:
        fail(f"launch counts {launches}, expected {want}")
    samples = sampler.samples
    if not np.all(np.isfinite(samples)) or samples.shape != (N, P):
        fail("non-finite or misshapen samples")
    for key, v in aux.items():
        if tuple(v.shape) != (STEPS,) or not torch.isfinite(v).all():
            fail(f"aux[{key!r}] is not {STEPS} finite values")
    log(f"[main] last step: " + ", ".join(
        f"{k}={v[-1].item():.6g}" for k, v in aux.items()))

    # The first 10 steps against the same sampler on the CPU (plain
    # versions), at the JAX suite's fused_gram class: medians rtol 5e-3,
    # samples rtol 2e-4 / atol 1e-6, phi_norm rtol 1e-4.
    gpu10 = SVGDSampler(N, model.log_p, model.template(), Adam(1e-1),
                        theta=theta0, device="cuda", **kw)
    cpu10 = SVGDSampler(N, model.log_p, model.template(), Adam(1e-1),
                        theta=theta0, device="cpu", **kw)
    ag = gpu10.run(batch, 10)
    ac = cpu10.run({k: v.cpu() for k, v in batch.items()}, 10)
    med_rel = np.max(np.abs(ag["median"].cpu().numpy()
                            / ac["median"].numpy() - 1))
    norm_rel = np.max(np.abs(ag["phi_norm"].cpu().numpy()
                             / ac["phi_norm"].numpy() - 1))
    sdiff = np.abs(gpu10.samples - cpu10.samples)
    excess = np.max(sdiff - (1e-6 + 2e-4 * np.abs(cpu10.samples)))
    log(f"[main] 10 steps vs CPU: median rel {med_rel:.3e}, phi_norm rel "
        f"{norm_rel:.3e}, samples max abs {sdiff.max():.3e} (excess over "
        f"tolerance {excess:.3e})")
    if med_rel > 5e-3 or norm_rel > 1e-4 or excess > 0:
        fail("the card's first 10 steps left the CPU run's class")

    post = np.linalg.solve(X.T @ X + np.eye(P), X.T @ y).ravel()
    post_err = float(np.max(np.abs(samples.mean(0) - post)))
    log(f"[main] posterior mean max abs error {post_err:.4e} (JAX package "
        f"on CPU: {POSTERIOR_JAX}, bound {POSTERIOR_BOUND})")
    if not post_err <= POSTERIOR_BOUND:
        fail("the particle mean is not near the conjugate posterior mean")

    path_counts, nn_sampler, nn_batch, big, lr_batch = run_nn_paths(
        dev, torch, nn_model, counters)
    path_counts["main"] = launches

    # --------------------------------------------------------- 5. timing
    K = 200
    sampler.run(batch, K)   # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    sampler.run(batch, K)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / K

    plain_run = _plain_runner(sampler, batch, _make_grad_all, fused_median,
                              fused_step, row_subsample_block,
                              subsample_rows, torch)
    plain_run(10)
    torch.cuda.synchronize()
    start.record()
    plain_run(K)
    end.record()
    torch.cuda.synchronize()
    plain_step_ms = start.elapsed_time(end) / K
    log(f"[timing] {gpu}: run() {step_ms * 1e3:.2f} us/step with the "
        f"kernels, {plain_step_ms * 1e3:.2f} us/step with the plain "
        f"functions ({N * P / (step_ms * 1e-3) / 1e6:.2f}M "
        f"particle-updates/s with the kernels)")

    gd, state = tail_inputs(theta, "adam", 1e-4)
    sub = subsample_rows(theta, MEDIAN_ROWS)
    b1_ms, b1_plain = in_turns(
        lambda: fused_step._plain_tail(theta, g0, sub, cold_p, state, gd,
                                       10.0, 8, fused_step.DEFAULT_BRACKETS),
        lambda: fused_step.fused_warm_step_tail(
            theta, g0, None, None, cold_p, state, gd, gram_in_kernel=True,
            theta_sub=sub),
        50, torch)
    b2_ms, b2_plain = in_turns(
        lambda: fused_median.warm_search_on_value(D_sub, zero, 30),
        lambda: fused_median.fused_warm_median_rows(D_sub, zero, 30),
        50, torch)
    log(f"[timing] {gpu}: B1 {b1_ms * 1e3:.2f} us vs plain "
        f"{b1_plain * 1e3:.2f} us; B2 (cold, 30 passes) {b2_ms * 1e3:.2f} us "
        f"vs plain {b2_plain * 1e3:.2f} us")

    # The NN path and the large-n path, then B3, B4, B5, B7 in turns.
    nn_step_us = run_timed(lambda k: nn_sampler.run(nn_batch, k), torch,
                           200)
    nn_plain_us = run_timed(plain_pallas_runner(
        nn_sampler, nn_batch,
        lambda t, b: bayesian_nn.nn_grads_plain(
            t, b["X"], b["y"].reshape(-1), 1, 100, nn_model._consts()),
        gram=True), torch, 200)
    large_us = run_timed(lambda k: big.run(lr_batch, k), torch, 20)
    log(f"[timing] {gpu}: NN path (n={NN_N}, p={NN_P}) run() "
        f"{nn_step_us:.2f} us/step with the kernels, {nn_plain_us:.2f} "
        f"us/step with the plain functions; large-n (n={LARGE_N}, p={P}) "
        f"run() {large_us:.2f} us/step with the kernels")
    lp_nn, g_nn = nn_model.pallas_grads()(nn_theta, nn_batch)
    sub = row_subsample_block(nn_theta, 128)
    h2 = fused_median.warm_search_on_value(sub, zero, 30) / np.log(NN_N)
    c_nn = svgd_tile.column_center(nn_theta)
    rows_nn = subsample_rows(nn_theta, 128)
    med_nn = fused_median.warm_search_on_value(
        fused_median.dist_block_plain(rows_nn, nn_theta, c_nn), zero, 30)
    theta_l = torch.tensor(nn_data(NN_LARGE)[2], dtype=f32, device=dev)
    rows_l = subsample_rows(theta_l, 128)
    c_l = svgd_tile.column_center(theta_l)

    def tile_plain(theta, g, h2):
        c = svgd_tile.column_center(theta)
        ku, ks = svgd_tile.svgd_both_ksum_plain(theta, theta, g, h2, c)
        return (ku + ks * (theta - c) / h2) / theta.shape[0]

    b3_ms, b3_plain = in_turns(lambda: tile_plain(nn_theta, g_nn, h2),
                               lambda: svgd_tile.svgd_phi(nn_theta, g_nn, h2),
                               50, torch)
    theta_n = big.state.particles
    g_n = torch.randn_like(theta_n)
    h2_n = fused_median.warm_search_on_value(
        row_subsample_block(theta_n, 128), zero, 30) / np.log(LARGE_N)
    b3n_ms, b3n_plain = in_turns(lambda: tile_plain(theta_n, g_n, h2_n),
                                 lambda: svgd_tile.svgd_phi(theta_n, g_n,
                                                            h2_n), 10, torch)
    b4_ms, b4_plain = in_turns(
        lambda: fused_median.dist_block_plain(rows_l, theta_l, c_l),
        lambda: fused_median.dist_block(rows_l, theta_l, c_l), 50, torch)
    b5_ms, b5_plain = in_turns(
        lambda: fused_median.warm_search_on_value(
            fused_median.dist_block_plain(rows_nn, nn_theta, c_nn),
            med_nn * 1.01, 8),
        lambda: fused_median.fused_warm_median_from_theta(
            rows_nn, nn_theta, med_nn * 1.01, c_nn, 8), 50, torch)
    b7_ms, b7_plain = in_turns(
        lambda: bayesian_nn.nn_grads_plain(
            nn_theta, nn_batch["X"], nn_batch["y"].reshape(-1), 1, 100,
            nn_model._consts()),
        lambda: nn_model.pallas_grads()(nn_theta, nn_batch), 50, torch)
    log(f"[timing] {gpu}: B3 (m=n={NN_N}, p={NN_P}) {b3_ms * 1e3:.2f} us vs "
        f"plain {b3_plain * 1e3:.2f} us; B3 (n={LARGE_N}, p={P}) "
        f"{b3n_ms * 1e3:.2f} us vs plain {b3n_plain * 1e3:.2f} us; B4 "
        f"([128, {NN_LARGE}], p={NN_P}) {b4_ms * 1e3:.2f} us vs plain "
        f"{b4_plain * 1e3:.2f} us; B5 ([128, {NN_N}], p={NN_P}, warm) "
        f"{b5_ms * 1e3:.2f} us vs plain {b5_plain * 1e3:.2f} us; B7 "
        f"(n={NN_N}) {b7_ms * 1e3:.2f} us vs plain {b7_plain * 1e3:.2f} us")

    total = {k: sum(c[k] for c in path_counts.values()) for k in counters}

    def row(name, key, source, replaces, err, ms, plain_ms):
        return {"name": f"{name} ({key})", "route": "cuda",
                "source": f"stein_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": total[key],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

    kernels = [
        row("fused_step_tail", "B1", "stein_kernels.cu",
            "stein_tpu/ops/pallas_step.py:92", b1_err, b1_ms, b1_plain),
        row("warm_median", "B2", "warm_search.cuh",
            "stein_tpu/ops/pallas_median.py:85", b2_err, b2_ms, b2_plain),
        row("svgd_tile", "B3", "svgd_tile.cu",
            "stein_tpu/ops/pallas_svgd.py:35", errs["B3"], b3_ms, b3_plain),
        row("dist_block", "B4", "dist_block.cu",
            "stein_tpu/ops/pallas_median.py:271", errs["B4"], b4_ms,
            b4_plain),
        row("warm_median_from_theta", "B5", "stein_kernels.cu",
            "stein_tpu/ops/pallas_median.py:317", errs["B5"], b5_ms,
            b5_plain),
        row("nn_grad", "B7", "nn_grad.cu",
            "stein_tpu/models/bayesian_nn.py:171", errs["B7"], b7_ms,
            b7_plain),
    ]
    log(f"[result] launches by path {path_counts}")
    log(f"[result] nn_step_us={nn_step_us!r} nn_plain_step_us="
        f"{nn_plain_us!r} large_n_step_us={large_us!r}")
    log(f"[result] step_ms={step_ms!r} plain_step_ms={plain_step_ms!r}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _plain_runner(sampler, batch, make_grad_all, fused_median, fused_step,
                  row_subsample_block, subsample_rows, torch):
    """run() of the fused_gram sampler with the kernels' plain versions
    called on the card's tensors, for the timing comparison only."""
    grad_all = make_grad_all(sampler.log_p, sampler.unravel_fn)

    def run(n_steps):
        s = sampler.state
        theta = s.particles
        med = fused_median.warm_search_on_value(
            row_subsample_block(theta, MEDIAN_ROWS),
            torch.zeros((), device=theta.device), 30)
        opt = s.opt_state
        for _ in range(n_steps):
            _, grads = grad_all(theta, batch)
            theta, opt, (med, _, _) = fused_step._plain_tail(
                theta, grads, subsample_rows(theta, MEDIAN_ROWS), med, opt,
                sampler.gd, 10.0, 8, fused_step.DEFAULT_BRACKETS)
        return theta
    return run


if __name__ == "__main__":
    sys.exit(main())
