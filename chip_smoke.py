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
              launch chain against the plain tail; B3 (both precisions),
              B4, B5 and B7 (B7 also at every shape of the card tests)
              against theirs; the glm and logistic stages, B10, B6, and
              B1's model and D-given chains against theirs; B8/B9 (with
              the thresholds they form against grid_edges); B11 at
              four shapes, ten calls bitwise equal and so on grids of one
              and seven blocks; B12 on lattice and path inputs; at the
              stated tolerances
  4. main     the bench's p=128 Bayesian linear regression at n=1000
              (B1, B2): launch counts of run(batch, 500), finiteness, the
              first 10 steps against the CPU run, the posterior mean
              against the conjugate closed form
     main-nn  the Bayesian NN (n=1000, p=303; B7, B3, B5): run(batch,
              500), launch counts, log_p_mean rising and at step 500
              against the JAX package's, the first 10 steps against the
              CPU run; main-nn-bf16 the same with pallas_precision='bf16'
              (B3's bf16 route): counts, log_p_mean at step 500 against
              the JAX package's bf16 run
     main-nn-large  the same model at n=3000 (B7, B3, B4 then B2), 50
              steps, 5 against the CPU run
     large-n  linear regression at n=10240 (B3, B2), 50 steps, 4 against
              the plain functions on the card
     covertype-e2e  BASELINE #2 as bench.py:213-281 runs it: the
              464809-row Covertype-shaped training split on the card, 100
              particles, train_minibatched(data, 6000, 50, key=7) through
              step_impl='fused_model' (the logistic stage and B1 every
              step): counts, a second call bitwise, train_on_batches on
              minibatch_indices' batches bitwise, 10 steps against the
              CPU, held-out accuracy of the particle-mean logits > 0.9
              (beside the CPU's plain run), wall seconds and us/step
     ksd      sampler.ksd (V and U) on [main]'s (dense) and [large-n]'s
              (streaming) samplers against ksd_rbf in f64 on the card;
              [main]'s below a tenth of theta0's
     checkpoint  [main]'s configuration: save at step 250, restore into a
              fresh sampler, 250 more steps bitwise; the file's signature
              the JAX package's; train_with_recovery resumed halfway
              bitwise on the uninterrupted run
     kernel-imq  kernel=InverseMultiquadricKernel() at n=1000, p=128, 10
              steps against the CPU at the reference-semantics class
     main-glm the n=1000 linear regression through throughput_config(
              model=) (step_impl='fused_glm': the glm stage, B1, B2), and
              BASELINE #1's route (n=50, Adagrad): counts, steps against
              the CPU run, the posterior mean
     main-logreg  bench.py's logistic regression at Covertype shape
              (step_impl='fused_model': the logistic stage, B1, B2):
              counts, log_p_mean against the JAX package's, 10 steps
              against the CPU run
     main-fused  step_impl='fused' (B1 on a given D with B10, B2): counts,
              steps against the CPU run and the plain functions
     large-n-epilogue  step_impl='epilogue' at n=10240 (B3, B2, B6):
              counts, 4 steps against the plain functions on the card
     main-nn-pblock  the Bayesian NN (n=1000, p=303) in the JAX package's
              own loop for B12: 500 steps of B7 then
              fused_warm_step_pblock (the whole-D step tail): counts,
              finiteness, log_p_mean at step 500 against the JAX
              package's, the first 10 steps against the CPU loop
     large-n-sym  B11 (svgd_phi_sym) at n=10240, p=128 in
              benchmarks/sym_and_gram_bench.py's loop, 50 iterations:
              counts, each phi against B3's and the plain version's, a
              second call bitwise
     mesh     the 1-D particle mesh on a one-process NCCL group:
              throughput_config(1000, 128, mesh=) = step_impl='fused_shard'
              with median_collectives='rounds' (B8, B3): counts, 10 steps
              against the same sampler on a one-process gloo group on the
              CPU and against the single-device fused_gram sampler on the
              card, the posterior mean; mesh-grid ('grid': B9, B3),
              mesh-ring (comm='ring': B9, B3), mesh-glm (quadratic_form:
              B8, B3) and mesh-nn (the NN with custom_grads: B7, B8, B3)
  5. timing   per-step time of run() (and of the B12 and B11 loops) with
              the kernels and with the plain functions on the card, and
              each kernel against its plain version and its library call
              (CUDA events; plain, kernel, kernel, plain); a torch.profiler
              split of each fused path, of both loops and of the mesh
              paths (with the collectives' share)

With --split it stops after the build and prints only [split]: the device
time of the median kernel's Gram stage apart from its search at each
path's shape, of B2 cold, B10 and B1's and B12's chains, of B4 (with
the Gram's torch.addmm), the logistic stage, B7, B8 and B9 (kernel and
plain) at the paths' shapes, and of B11 (and its plain version, and B3's
svgd_phi) at [large-n-sym]'s input (to compare two trees in one call, run
this script's copy from each tree: the split reaches the kernels only
through their wrappers).

Every phase prints its lines; a failed check raises and the script exits
non-zero. The line before the last is the kernel table as JSON (each
kernel's launches on the paths, max abs error against its plain version,
ms, plain ms, its bound on the H100 and what sets it, and the time of one
PyTorch call computing the same function where there is one), the last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or without the package beside the script, it exits
with code 2 and prints no result.
"""

import contextlib
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
# as the particles spread (the weight precision shrinks). At step 500 each
# path is held to the JAX package's own run of the same configuration (CPU,
# interpret mode; tests/test_torch_reference_values.py recomputes both):
# [main-nn] to throughput_config(1000, 303, model=) (B7 as custom_grads, the
# streaming tile, the 128-row fused_gram median), which reads -17.879913 at
# step 1 and -16.256598 at step 10; [mesh-nn] to the same on a one-device
# mesh (fused_shard, 256 median rows). Both within 1e-4 relative: the NN's
# other tails land 2e-4 to 1.3e-3 away (B12's loop -40.90076), so a looser
# bound would not tell one median route from another.
NN_LOGP_JAX = -40.86991500854492
NN_MESH_LOGP_JAX = -40.923118591308594
# [main-nn-bf16]: [main-nn] with pallas_precision='bf16' (interpret mode
# rounds the tile's operands to bf16 as the card does); -16.257341 at step
# 10. The port's plain versions on the CPU land 4.6e-6 from it.
NN_BF16_LOGP_JAX = -40.87063217163086
NN_LOGP_RTOL = 1e-4


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


def adagrad_eps_regime(phi1, lr, eps=1e-6):
    """The same for Adagrad, whose first step lr phi / (eps + |phi|) has
    the slope lr eps / (eps + |phi|)^2 in phi (1e5 at phi = 0, lr 0.1)."""
    return lr * eps / (eps + np.abs(phi1)) ** 2 > 10


def bf16_excess(a, b):
    """Excess of a over the JAX suite's bf16 class around b: rtol 0.05,
    atol 5e-3 of max|b| (tests/test_pallas.py:91-93)."""
    return float(np.max(np.abs(a - b)
                        - (5e-3 * np.abs(b).max() + 0.05 * np.abs(b))))


# The fused_gram class (medians, phi_norm, then the samples' rtol / atol)
# and the reference-semantics class (tests/test_torch_sampler.py's REF_TOL).
FUSED_GRAM_CLASS = (5e-3, 1e-4, 2e-4, 1e-6)
REFERENCE_CLASS = (1e-5, 1e-5, 1e-5, 1e-6)


def check_class(label, what, got, want, steps, lr, eps_regime=None,
                samples_excess=None, tol=FUSED_GRAM_CLASS):
    """`got` against `want`, the run on `what` (dicts of numpy arrays:
    phi1, Adam's mu after step 1, i.e. the first clipped phi; samples,
    median and phi_norm after `steps` steps) at the fused_gram class:
    medians rtol 5e-3, phi_norm rtol 1e-4, phi1 and the samples rtol 2e-4
    / atol 1e-6 (or the class `tol` names). The samples in Adam's eps
    regime are held through phi1
    only, and that regime may hold at most 1 coordinate in 1000 (measured
    on the H100: 7.3e-5 at the NN shape, 7.5e-5 at n=3000, 1.6e-4 at
    n=10240, p=128). Adagrad runs pass adagrad_eps_regime, and |phi1|;
    bf16 runs pass bf16_excess, the class of their samples."""
    med_tol, norm_tol, rtol, atol = tol

    def excess(a, b):
        return float(np.max(np.abs(a - b) - (atol + rtol * np.abs(b))))

    med_rel = np.max(np.abs(got["median"] / want["median"] - 1))
    norm_rel = np.max(np.abs(got["phi_norm"] / want["phi_norm"] - 1))
    ill = (eps_regime or adam_eps_regime)(want["phi1"], lr)
    phi_ex = excess(got["phi1"], want["phi1"])
    s_ex = (samples_excess or excess)(got["samples"][~ill],
                                      want["samples"][~ill])
    ill_err = (np.abs(got["phi1"] - want["phi1"])[ill].max() if ill.any()
               else 0.0)
    log(f"[{label}] {steps} steps vs {what}: median rel {med_rel:.3e}, "
        f"phi_norm rel {norm_rel:.3e}; phi at step 1 excess over the class "
        f"{phi_ex:.3e} "
        f"({int(ill.sum())} coordinates in Adam's eps regime, their phi max "
        f"abs error {ill_err:.3e}); samples max abs "
        f"{np.abs(got['samples'] - want['samples']).max():.3e}, excess over "
        f"the class outside the eps regime {s_ex:.3e}")
    if (med_rel > med_tol or norm_rel > norm_tol or phi_ex > 0 or s_ex > 0
            or ill.mean() > 1e-3):
        fail(f"{label}: the first {steps} steps left the reference's class")


def sampler_trial(make, batch, steps, drive=None):
    """check_class's dict for make(): one sampler's first step, another's
    `steps` steps; drive(sampler, batch, k) runs k steps (run() by
    default)."""
    drive = drive or (lambda s_, b, k: s_.run(b, k))
    first = make()
    drive(first, batch, 1)
    s = make()
    aux = drive(s, batch, steps)
    opt = first.state.opt_state
    phi1 = opt.mu if hasattr(opt, "mu") else opt.hist.sqrt()
    return {"phi1": phi1.cpu().numpy(),
            "samples": s.samples, "median": aux["median"].cpu().numpy(),
            "phi_norm": aux["phi_norm"].cpu().numpy()}


def compare_with_cpu(make, batch, steps, label, lr, eps_regime=None):
    """The first `steps` steps of make("cuda") against make("cpu")."""
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    check_class(label, "the CPU", sampler_trial(lambda: make("cuda"), batch,
                                                steps),
                sampler_trial(lambda: make("cpu"), cpu_batch, steps), steps,
                lr, eps_regime)


def b2_case(label, D, fused_median, zero, brackets=None):
    """B2 bitwise against its plain version on the block D, cold (30
    passes) and warm (8 passes, hint 1.01 x the cold median), with the
    default brackets or the given ones. Returns the plain cold median."""
    br = {} if brackets is None else {"brackets": brackets}
    cold_k = fused_median.fused_warm_median_rows(D, zero, 30, **br)
    cold_p = fused_median.warm_search_on_value(D, zero, 30, **br)
    warm_k = fused_median.fused_warm_median_rows(D, cold_p * 1.01, 8, **br)
    warm_p = fused_median.warm_search_on_value(D, cold_p * 1.01, 8, **br)
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
    # of the same width and at a second (f, H, B), then at every shape of
    # the card tests (n 1, 7, 1000, 3000; H 33, 100, 128; f 1, 3; B 1, 20,
    # 64: one particle, ragged blocks, H past a warp, B past the
    # 20-observation chunk; and n 7, 1000 at H 200, 300, f 1, 3, B 20, 64:
    # teams of 7 and 8 warps, several units a thread; their inputs from a
    # generator of their own); the JAX suite's bounds: logp rtol 2e-5 /
    # atol 1e-5, grads atol 2e-5 max|g|; two calls bitwise.
    rng = np.random.default_rng(0)
    cases = [("main path", nn_model, nn_theta, nn_batch)]
    shapes = [((NN_N, 20, 1, 100), rng), ((600, 12, 3, 50), rng)]
    grid_rng = np.random.default_rng(7)
    shapes += [((n, B, f, H), grid_rng) for n in (1, 7, NN_N, NN_LARGE)
               for H in (33, 100, 128) for f in (1, 3) for B in (1, 20, 64)]
    shapes += [((n, B, f, H), grid_rng) for n in (7, NN_N) for H in (200, 300)
               for f in (1, 3) for B in (20, 64)]
    for (n, B, f, H), gen in shapes:
        model = type(nn_model)(f, H, n_train=5 * B, n_batch=B,
                               prior_beta=10.0)
        p = f * H + 2 * H + 3
        theta = torch.tensor(gen.normal(size=(n, p)) * 0.3, dtype=f32,
                             device=dev)
        X = gen.uniform(size=(B, f))
        y = (np.cos(10 * X[:, :1]) * (5 * X[:, :1])
             + gen.normal(size=(B, 1)) * 0.1)
        batch = {"X": torch.tensor(X, dtype=f32, device=dev),
                 "y": torch.tensor(y, dtype=f32, device=dev)}
        cases.append((f"n={n} B={B} f={f} H={H}", model, theta, batch))
    worst = (-np.inf, None)
    for label, model, theta, batch in cases:
        lp, g = model.pallas_grads()(theta, batch)
        again = model.pallas_grads()(theta, batch)
        lp0, g0 = bayesian_nn.nn_grads_plain(
            theta, batch["X"], batch["y"].reshape(-1), model.n_feats,
            model.n_hidden, model._consts())
        lp_ex = ((lp - lp0).abs() - (1e-5 + 2e-5 * lp0.abs())).max().item()
        g_err = (g - g0).abs().max().item()
        g_bound = 2e-5 * g0.abs().max().item()
        repeat = torch.equal(lp, again[0]) and torch.equal(g, again[1])
        if label == "main path" or not repeat or lp_ex > 0 or g_err > g_bound:
            log(f"[kernels] B7 {label}: logp excess over rtol 2e-5/atol 1e-5 "
                f"{lp_ex:.3e}, grads max abs {g_err:.3e} (bound "
                f"{g_bound:.3e}), repeat bitwise {repeat}")
        if lp_ex > 0 or g_err > g_bound or not repeat:
            fail(f"B7 ({label}) disagrees with its plain version or itself")
        worst = max(worst, (g_err / g_bound if g_bound else 0.0, label))
        if label == "main path":
            errs["B7"] = max((lp - lp0).abs().max().item(), g_err)
            g_path = g
    log(f"[kernels] B7 at {len(cases) - 1} more shapes: all within the "
        f"bounds, repeat bitwise; largest grads error {worst[0]:.3e} of its "
        f"bound ({worst[1]})")

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
    bf16_cases = []
    lat = lattice(NN_N, NN_P, dev, torch)
    lat_g = torch.tensor(rng.normal(size=(NN_N, NN_P)), dtype=f32,
                         device=dev)
    b3_case(f"lattice m=n={NN_N} p={NN_P}", lat, lat, lat_g, 1e-5)
    for m, n, p in ((LARGE_N, LARGE_N, 128), (3000, 3000, 640),
                    (300, NN_N, NN_P)):
        cols = torch.tensor(rng.normal(size=(n, p)), dtype=f32, device=dev)
        grads = torch.tensor(rng.normal(size=(n, p)), dtype=f32, device=dev)
        b3_case(f"m={m} n={n} p={p}", cols[:m], cols, grads, 1e-4)
        if p != 640:
            bf16_cases.append((f"m={m} n={n} p={p}", cols[:m], cols, grads))

    # B3's bf16 route (pallas_precision='bf16') against its plain version
    # (the same bf16 casts, then f32 products): <= 1e-3 normalised. Both
    # round the same f32 values, but another f32 summation order moves S,
    # and so K, by an ulp, which can carry a K entry across a bf16 rounding
    # boundary (2^-8 of that term): measured 5.1e-6 to 4.2e-4 on the H100.
    # Against the f32 plain version at the JAX suite's bf16 class, rtol 0.05
    # and atol 5e-3 of max|phi|; two calls bitwise equal. The 1e-3 bound
    # alone would pass an f32 tile at the main path's shape (there the bf16
    # casts move phi by ~2.4e-4 normalised), so the kernel must also lie at
    # most half as far from the bf16 plain version as from the f32 one.
    def b3_bf16_case(label, rows, cols, grads):
        sub = row_subsample_block(cols, 128)
        h2 = fused_median.warm_search_on_value(sub, zero, 30) / np.log(
            cols.shape[0])
        got = svgd_tile.svgd_phi_rect(rows, cols, grads, h2,
                                      precision="bf16")
        again = svgd_tile.svgd_phi_rect(rows, cols, grads, h2,
                                        precision="bf16")
        c = svgd_tile.column_center(cols)
        want = {}
        for prec in ("bf16", "f32"):
            ku, ks = svgd_tile.svgd_both_ksum_plain(rows, cols, grads, h2, c,
                                                    prec)
            want[prec] = (ku + ks * (rows - c) / h2) / cols.shape[0]
        torch.cuda.synchronize()
        err = norm_err(got, want["bf16"])
        w32 = want["f32"]
        err32 = norm_err(got, w32)
        ex = ((got - w32).abs() - (5e-3 * w32.abs().max() + 0.05 * w32.abs())
              ).max().item()
        log(f"[kernels] B3 bf16 {label}: normalised error vs the bf16 plain "
            f"version {err:.3e} (bound 1e-03 and half the next), vs the f32 "
            f"plain version {err32:.3e} (excess over rtol 0.05 / atol 5e-3 "
            f"{ex:.3e}), repeat bitwise {torch.equal(got, again)}")
        if (err > 1e-3 or err > 0.5 * err32 or ex > 0
                or not torch.equal(got, again)):
            fail(f"B3 bf16 {label} disagrees with its plain versions or "
                 "itself")
        return (got - want["bf16"]).abs().max().item()

    errs["B3-bf16"] = b3_bf16_case(f"main path m=n={NN_N} p={NN_P}",
                                   nn_theta, nn_theta, g_path)
    b3_bf16_case(f"lattice m=n={NN_N} p={NN_P}", lat, lat, lat_g)
    for case in bf16_cases:
        b3_bf16_case(*case)

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


def _counter(c):
    """(wrapper, attribute) of a launch count: a wrapper's ``launches``, or
    another count it keeps (the tile's ``bf16_launches``)."""
    return c if isinstance(c, tuple) else (c, "launches")


def reset(counters):
    for c in counters.values():
        setattr(*_counter(c), 0)


def read(counters):
    return {k: getattr(*_counter(c)) for k, c in counters.items()}


def run_nn_paths(dev, torch, nn_model, counters):
    """[main-nn], [main-nn-large] and [large-n]; returns each path's
    launch counts, the NN path's sampler and batch, the large-n path's,
    the bf16 NN sampler and the n=3000 one (the NN batch)."""
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
    log(f"[main-nn] log_p_mean step 10 {lp[9].item():.6g}, step {NN_STEPS} "
        f"{lp[-1].item()!r}; JAX package's run of this configuration: "
        f"{NN_LOGP_JAX} (relative gap "
        f"{abs(lp[-1].item() / NN_LOGP_JAX - 1):.3e}, bound {NN_LOGP_RTOL:g})")
    if not lp[9].item() > lp[0].item():
        fail("[main-nn] log_p_mean did not rise over the first 10 steps")
    if abs(lp[-1].item() / NN_LOGP_JAX - 1) > NN_LOGP_RTOL:
        fail(f"[main-nn] log_p_mean at step {NN_STEPS} is not within "
             f"{NN_LOGP_RTOL:g} of the JAX package's")
    compare_with_cpu(lambda d: nn_sampler(NN_N, theta0, d), batch, 10,
                     "main-nn", 0.1)

    # [main-nn-bf16]: the same with pallas_precision='bf16', B3's bf16
    # route; log_p_mean at step 500 against the JAX package's bf16 run, and
    # 10 steps against the CPU run of the same sampler (the plain bf16 tile).
    kw16 = dict(kw, pallas_precision="bf16")

    def nn16_sampler(device):
        return SVGDSampler(NN_N, nn_model.log_p, nn_model.template(),
                           Adam(0.1, decay=0.999), theta=theta0,
                           device=device, **kw16)

    nn16 = nn16_sampler("cuda")
    reset(counters)
    aux16 = nn16.run(batch, NN_STEPS)
    torch.cuda.synchronize()
    bf16_counts = check_counts("main-nn-bf16", counters, {
        "B7": NN_STEPS, "B3": NN_STEPS, "B3-bf16": NN_STEPS,
        "B5": NN_STEPS + 1})
    check_finite("main-nn-bf16", nn16, aux16, NN_STEPS)
    lp16 = aux16["log_p_mean"][-1].item()
    log(f"[main-nn-bf16] log_p_mean step 10 "
        f"{aux16['log_p_mean'][9].item():.6g}, step {NN_STEPS} {lp16!r}; JAX "
        f"package's bf16 run: {NN_BF16_LOGP_JAX} (relative gap "
        f"{abs(lp16 / NN_BF16_LOGP_JAX - 1):.3e}, bound {NN_LOGP_RTOL:g}); "
        f"the f32 path {lp[-1].item()!r}")
    if abs(lp16 / NN_BF16_LOGP_JAX - 1) > NN_LOGP_RTOL:
        fail(f"[main-nn-bf16] log_p_mean at step {NN_STEPS} is not within "
             f"{NN_LOGP_RTOL:g} of the JAX package's bf16 run")
    # 10 steps against the CPU run of the same bf16 sampler: phi at step 1,
    # the medians and phi_norm at the fused_gram class; the samples at the
    # JAX suite's bf16 class (a K entry that rounds to the other bf16
    # neighbour on the card moves the trajectory by more than the f32
    # class allows: 1.7e-4 over it after 10 steps on the H100). The f32
    # sampler's CPU run must leave that class, or the check could not tell
    # the routes apart.
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    want16 = sampler_trial(lambda: nn16_sampler("cpu"), cpu_batch, 10)
    check_class("main-nn-bf16", "the CPU (bf16)",
                sampler_trial(lambda: nn16_sampler("cuda"), batch, 10),
                want16, 10, 0.1, samples_excess=bf16_excess)
    want32 = sampler_trial(lambda: nn_sampler(NN_N, theta0, "cpu"),
                           cpu_batch, 10)
    ill = adam_eps_regime(want16["phi1"], 0.1)
    ctl = bf16_excess(want32["samples"][~ill], want16["samples"][~ill])
    log(f"[main-nn-bf16] control: the f32 sampler's CPU run against the "
        f"bf16 one, samples excess over the bf16 class {ctl:.3e} (must be "
        f"> 0)")
    if not ctl > 0:
        fail("[main-nn-bf16] the f32 run lies inside the bf16 class: the "
             "10-step check cannot tell the routes apart")

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
    compare_with_plain(
        "large-n", lr_sampler, lr_batch,
        plain_pallas_runner(lr_sampler(), lr_batch, _make_grad_all(
            lr_model.log_p, big.unravel_fn), gram=False), 4, 0.1)
    return ({"main-nn": nn_counts, "main-nn-bf16": bf16_counts,
             "main-nn-large": large_counts, "large-n": n_counts}, sampler,
            batch, big, lr_batch, nn16, large)


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


# ------------------------------------------------ single-device tails
# The JAX package's values below are recomputed on the CPU, from these
# recipes, by tests/test_torch_reference_values.py.

GLM_STEPS, GLM50_N, GLM50_STEPS = 500, 50, 500
# The JAX package's own fused_glm run of [main-glm]'s recipe (CPU, interpret
# mode, 500 steps): max |particle mean - posterior mean|. The port's plain
# versions on the CPU land at 0.00942; the bound is 4x the JAX value.
POSTERIOR_GLM_JAX = 0.007205101663071298
# BASELINE #1's route (n=50, Adagrad(0.1)) is chaotic: the JAX package's own
# xla and fused_glm paths part by up to this max abs difference of the
# samples after 10 steps (CPU; 9.8e-6 after 3), leaving the fused_gram class
# from step 4. The port is held to the class for 3 steps and to this spread
# for 10.
GLM50_SPREAD_JAX = 0.0010896921157836914
GLM50_CLASS_STEPS = 3
# step_impl='fused' subtracts uncentred K @ theta / h^2 and ksum theta / h^2
# (the JAX kernel's tc = theta), so f32 roundings grow with |mean theta| /
# spread as the particles leave the origin: on [main-fused]'s recipe the
# JAX package's own fused and xla paths part by this max abs difference
# after 10 steps (CPU), 2.3e-6 past the fused_gram class (1.2e-6 after 5,
# inside it). The port is held to the class for 5 steps and to this spread
# for 10.
FUSED_SPREAD_JAX = 7.264316082000732e-06
FUSED_CLASS_STEPS = 5
LOGREG_N, LOGREG_D, LOGREG_OBS, LOGREG_TRAIN = 1000, 54, 50, 581012
LOGREG_STEPS = 500
# log_p_mean at step 500 of bench.py's logreg recipe through
# throughput_config(1000, 55, model=...) with median_passes=16,
# warm_passes=6: the JAX package on the CPU (fused_model, interpret mode)
# reads -436663.66 at step 1, -207332.25 at step 10 and this at step 500;
# the port's plain versions on the CPU -139.94336. The card is held to 1e-4
# relative (its measured gap is 1.4e-7; the CPU's 2.4e-6).
LOGREG_LOGP_JAX = -139.94369506835938
# The JAX package's own fused_shard runs of [mesh]'s and [mesh-glm]'s
# recipes on a 1-device mesh (CPU, interpret mode, 500 steps): max |particle
# mean - posterior mean|. The mesh paths are held to 4x these.
POSTERIOR_MESH_JAX = 0.007894717227018955
POSTERIOR_MESH_GLM_JAX = 0.007850189669081131
MESH_STEPS = 500
# The ring shape of B9's check: a 4-process mesh at n=1000 holds n_loc =
# 250 columns (not a multiple of the 32-column tile) and m_loc = 64 rows.
RING_M, RING_N = 64, 250
# The H100 SXM's published peaks: f32 outside the tensor cores, TF32 and
# bf16 on the tensor cores (dense), and device memory.
PEAK_F32_FLOPS, PEAK_BYTES = 67e12, 3.35e12
PEAK_TF32_FLOPS, PEAK_BF16_FLOPS = 495e12, 989e12


def bound(nbytes, ops, tf32_ops=0, bf16_ops=0):
    """(ms, 'bytes' or 'operations'): the least time the card could take,
    the larger of the bytes over the memory rate and the operations over
    the rates of the route that runs them: ``ops`` f32 on the CUDA cores,
    ``tf32_ops`` and ``bf16_ops`` on the tensor cores (3xTF32 issues three
    TF32 products for each f32 one: pass 3x the product's FLOP)."""
    t_b = nbytes / PEAK_BYTES * 1e3
    t_o = (ops / PEAK_F32_FLOPS + tf32_ops / PEAK_TF32_FLOPS
           + bf16_ops / PEAK_BF16_FLOPS) * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def device_us(fn, reps, torch):
    """µs of device time per call of fn(), or None where this run cannot
    read it. The calls are queued behind a spin kernel (torch.cuda._sleep)
    and timed by CUDA events around them, so the card runs them back to
    back, its own gaps between launches included and the host's excluded.
    A reading counts only if the host queued every call before the spin
    ended (the start event still pending); else fewer calls are tried
    (a full launch queue also blocks the host), then None."""
    fn()
    torch.cuda.synchronize()
    for calls in dict.fromkeys((reps, max(1, reps // 10), 1)):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        # Twice the calls' wall time at up to 2 GHz: the spin outlasts the
        # host's queueing of the same calls.
        cycles = int(4e9 * (time.perf_counter() - t0)) + 10 ** 6
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) * 1e3 / calls
    return None


def redesign_split(dev, torch, gpu, reps=50):
    """[split]: device µs (device_us) of the kernels this slice
    redesigned, at each path's shape. The median kernel's Gram stage apart
    from its search: on the same block and hint (warm, 8 passes), the
    kernel with its Gram stage (stein_warm_from_theta, the centre given)
    against the search alone (stein_warm_median on the plain version's D),
    beside the Gram's library yardstick (one torch.addmm of the centred
    operands into the norm sum, TF32 off); B2 cold (30 passes) alone; B10
    (u given) at n=1000, p=128 and 303; B1's fused_gram chain and B12's
    (n=1000, p=303). Returns {label: µs or a tuple of them}."""
    from stein_tpu_torch.ops import fused_median, fused_step, svgd_tile
    from stein_tpu_torch.ops.median import subsample_rows

    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)
    theta_lr = torch.tensor(make_data()[2], dtype=f32, device=dev)
    theta_nn = torch.tensor(nn_data(NN_N)[2], dtype=f32, device=dev)
    out = {}
    for label, th, m in (("B1", theta_lr, MEDIAN_ROWS),
                         ("glm", theta_lr, 128), ("B5", theta_nn, 128),
                         ("B12", theta_nn, NN_N)):
        rows = subsample_rows(th, m)
        rows = th if rows is None else rows
        c = svgd_tile.column_center(th)
        D = fused_median.dist_block_plain(rows, th, c)
        hint = fused_median.warm_search_on_value(D, zero, 30) * 1.01
        rc, cc = rows - c, th - c
        rsq = ((rc * rc).sum(1, keepdim=True) + (cc * cc).sum(1)[None, :])

        def both(rows=rows, th=th, c=c, hint=hint):
            return fused_median.fused_warm_median_from_theta(rows, th, hint,
                                                             c, 8)

        def search(D=D, hint=hint):
            return fused_median.fused_warm_median_rows(D, hint, 8)

        dv = (device_us(both, reps, torch), device_us(search, reps, torch),
              device_us(lambda rsq=rsq, rc=rc, cc=cc: torch.addmm(
                  rsq, rc, cc.T, alpha=-2.0), reps, torch))
        out[label] = dv
        gram = None if None in dv[:2] else dv[0] - dv[1]
        log(f"[split] {gpu}: median_kernel [{rows.shape[0]}, {th.shape[0]}] "
            f"p={th.shape[1]} ({label}'s shape), warm 8 passes: Gram + search "
            f"{dv[0]} us, search alone {dv[1]} us, so the Gram stage {gram} "
            f"us; the Gram's torch.addmm {dv[2]} us (device)")
    D = fused_median.dist_block_plain(
        subsample_rows(theta_lr, MEDIAN_ROWS), theta_lr,
        svgd_tile.column_center(theta_lr))
    out["B2 cold"] = device_us(
        lambda: fused_median.fused_warm_median_rows(D, zero, 30), reps, torch)
    rng = np.random.default_rng(9)
    for label, th in (("B10 p=128", theta_lr), ("B10 p=303", theta_nn)):
        D = fused_median.dist_block_plain(th, th, svgd_tile.column_center(th))
        h2 = fused_median.warm_search_on_value(D, zero, 30) / np.log(N)
        u = torch.tensor(rng.normal(size=tuple(th.shape)), dtype=f32,
                         device=dev) - th / h2
        out[label] = device_us(
            lambda D=D, u=u, h2=h2: svgd_tile.svgd_both_ksum_on_D(D, u, h2),
            reps, torch)
    for label, th, rows in (("B1 chain", theta_lr, MEDIAN_ROWS),
                            ("B12 chain", theta_nn, None)):
        n, p = th.shape
        g = torch.tensor(rng.normal(size=(n, p)), dtype=f32, device=dev)
        gd, state = opt_state(n, p, "adam", 1.0, dev, torch)
        med = fused_median.warm_search_on_value(
            fused_median.dist_block_plain(th, th, th.mean(0)), zero, 30)
        if rows is None:
            def step(th=th, g=g, med=med, state=state, gd=gd):
                return fused_step.fused_warm_step_pblock(th, g, med, state,
                                                         gd)
        else:
            sub = subsample_rows(th, rows)

            def step(th=th, g=g, med=med, state=state, gd=gd, sub=sub):
                return fused_step.fused_warm_step_tail(
                    th, g, None, None, med, state, gd, gram_in_kernel=True,
                    theta_sub=sub)
        out[label] = device_us(step, reps, torch)
    log(f"[split] {gpu}: device us: B2 cold (30 passes, [{MEDIAN_ROWS}, {N}]) "
        f"{out['B2 cold']}; B10 ([{N}, {N}] x [{N}, 128] / x [{N}, {NN_P}], "
        f"u given) {out['B10 p=128']} / {out['B10 p=303']}; B1's fused_gram "
        f"chain (n={N}, p={P}, m={MEDIAN_ROWS}) {out['B1 chain']}; B12's "
        f"chain (n={NN_N}, p={NN_P}) {out['B12 chain']}")
    return out


def bracket_inputs(theta, m, dev, torch):
    """A shard's bracket-pass inputs on the particles theta: m median rows
    (every (n // m)-th particle, as the [mesh] paths' checks take them, in
    a contiguous copy as the path's gather makes them), the centre, the
    cold median of their block as the hint, and hi_bound = 4 max |theta_i
    - c|^2 with the callers' headroom."""
    from stein_tpu_torch.ops import fused_median as fm
    from stein_tpu_torch.ops import svgd_tile

    rows = theta[::theta.shape[0] // m][:m].contiguous()
    c = svgd_tile.column_center(theta)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    med = fm.warm_search_on_value(fm.dist_block_plain(rows, theta, c), zero,
                                  30)
    hib = 4.0 * torch.max(torch.sum((theta - c) ** 2, dim=1)) * 1.0001 \
        + 1e-30
    return rows, theta, med, c, hib


def pass_split(dev, torch, gpu, reps=50):
    """[split]: device µs (device_us) of B4, the logistic stage, B7, B8 and
    B9, kernel and plain, at the paths' shapes: B4 at [main-nn-large]'s
    [128, 3000] p=303 on the NN recipe's particles and on lattice
    particles, beside the Gram's torch.addmm alone (the centred operands
    into the norm sum); the logistic stage at [main-logreg]'s n=1000,
    p=55, N=50; B7 at [main-nn]'s n=1000 and [main-nn-large]'s n=3000
    (B=20, f=1, H=100, the NN recipe's particles); B8 at [mesh]'s [256,
    1000] p=128, [mesh-nn]'s p=303 and a 4-rank shard's [64, 1000] p=128;
    B9 at [256, 1000] p=128, g1=8, through its wrapper, beside grid_edges
    alone (the torch ops that formed B9's thresholds before its launch
    until the kernel formed them itself). Returns {label: (kernel µs,
    plain µs)}, and B4's addmm under "B4 addmm"."""
    from stein_tpu_torch.models import (
        BayesianNNModel,
        LogisticRegressionModel,
        bayesian_nn,
    )
    from stein_tpu_torch.ops import fused_median as fm
    from stein_tpu_torch.ops import svgd_tile
    from stein_tpu_torch.ops.median import DEFAULT_BRACKETS, subsample_rows

    f32 = torch.float32
    out = {}
    for kind, th in (
            ("lattice", lattice(NN_LARGE, NN_P, dev, torch)),
            ("NN particles", torch.tensor(nn_data(NN_LARGE)[2], dtype=f32,
                                          device=dev))):
        rows = subsample_rows(th, 128)
        c = svgd_tile.column_center(th)
        out[f"B4 [128, {NN_LARGE}] p={NN_P} {kind}"] = (
            device_us(lambda: fm.dist_block(rows, th, c), reps, torch),
            device_us(lambda: fm.dist_block_plain(rows, th, c), reps, torch))
    # The yardstick on the NN particles' operands (the loop's last).
    rc, cc = rows - c, th - c
    rsq = (rc * rc).sum(1, keepdim=True) + (cc * cc).sum(1)[None, :]
    out["B4 addmm"] = (device_us(lambda: torch.addmm(rsq, rc, cc.T,
                                                     alpha=-2.0),
                                 reps, torch), None)
    Xl, yl, theta_l0 = logreg_data()
    ikm = LogisticRegressionModel(LOGREG_D, LOGREG_TRAIN, LOGREG_OBS
                                  ).inkernel_model(
        {"X": torch.tensor(Xl, dtype=f32, device=dev),
         "y": torch.tensor(yl, dtype=f32, device=dev)})
    l_args = (torch.tensor(theta_l0, dtype=f32, device=dev), *ikm.operands)
    out[f"logistic n={LOGREG_N} p={LOGREG_D + 1} N={LOGREG_OBS}"] = (
        device_us(lambda: ikm.grad_fn(*l_args), reps, torch),
        device_us(lambda: ikm.grad_fn.plain(*l_args), reps, torch))
    model = BayesianNNModel(1, 100, 20, 20, prior_beta=10.0)
    grad_all, consts = model.pallas_grads(), model._consts()
    for n in (NN_N, NN_LARGE):
        X, y, th = nn_data(n)
        theta = torch.tensor(th, dtype=f32, device=dev)
        batch = {"X": torch.tensor(X, dtype=f32, device=dev),
                 "y": torch.tensor(y, dtype=f32, device=dev)}
        out[f"B7 n={n}"] = (
            device_us(lambda: grad_all(theta, batch), reps, torch),
            device_us(lambda: bayesian_nn.nn_grads_plain(
                theta, batch["X"], batch["y"].reshape(-1), 1, 100, consts),
                reps, torch))
    theta_lr = torch.tensor(make_data()[2], dtype=f32, device=dev)
    theta_nn = torch.tensor(nn_data(NN_N)[2], dtype=f32, device=dev)
    for label, th, m in ((f"B8 [{MEDIAN_ROWS}, {N}] p={P}", theta_lr,
                          MEDIAN_ROWS),
                         (f"B8 [{MEDIAN_ROWS}, {NN_N}] p={NN_P}", theta_nn,
                          MEDIAN_ROWS),
                         (f"B8 [64, {N}] p={P}", theta_lr, 64)):
        rows, cols, med, c, _ = bracket_inputs(th, m, dev, torch)
        out[label] = (
            device_us(lambda: fm.fused_bracket_pass(rows, cols, med, c),
                      reps, torch),
            device_us(lambda: fm.fused_bracket_pass_plain(rows, cols, med, c),
                      reps, torch))
    args = bracket_inputs(theta_lr, MEDIAN_ROWS, dev, torch)
    label = f"B9 [{MEDIAN_ROWS}, {N}] p={P} g1=8"
    out[label] = (
        device_us(lambda: fm.fused_bracket_grid_pass(*args, g1=8), reps,
                  torch),
        device_us(lambda: fm.fused_bracket_grid_pass_plain(*args, g1=8), reps,
                  torch))
    out["grid_edges g1=8"] = (device_us(lambda: fm.grid_edges(
        args[2], args[4], DEFAULT_BRACKETS, 8), reps, torch), None)
    for k, (kern, plain) in out.items():
        log(f"[split] {gpu}: {k} device us {kern} (plain {plain})")
    return out


def sym_split(dev, torch, gpu, reps=20):
    """[split]: device µs (device_us) of B11 at [large-n-sym]'s input (n=10240,
    p=128, h^2 = 1), reached only through svgd_phi_sym(theta, grads, h2),
    beside its plain version and B3's svgd_phi on the same input (the same
    phi, the full grid of tiles). Returns {label: µs}."""
    from stein_tpu_torch.ops import svgd_tile

    theta, grads = sym_data(dev, torch)
    h2 = torch.ones((), device=dev)
    out = {"B11": device_us(lambda: svgd_tile.svgd_phi_sym(theta, grads, h2),
                            reps, torch),
           "B11 plain": device_us(
               lambda: svgd_tile.svgd_phi_sym_plain(theta, grads, h2), reps,
               torch),
           "B3": device_us(lambda: svgd_tile.svgd_phi(theta, grads, h2),
                           reps, torch)}
    log(f"[split] {gpu}: B11 (n={SYM_N}, p={SYM_P}, [large-n-sym]'s input) "
        f"device us {out['B11']} (plain {out['B11 plain']}); B3's svgd_phi "
        f"on the same input {out['B3']}")
    return out


def logreg_data(seed=7):
    """bench.py's bench_logreg recipe (bench.py:189-196): 50 observations
    of 54 features from numpy seed 7, labels from a random hyperplane,
    theta0 = 0.1 N(0, I) [1000, 55] from the same generator."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(LOGREG_OBS, LOGREG_D))
    y = (X @ rng.normal(size=(LOGREG_D, 1)) > 0).astype(np.float64)
    theta0 = rng.normal(size=(LOGREG_N, LOGREG_D + 1)) * 0.1
    return X, y, theta0


def opt_state(n, p, rule, phi_sq, dev, torch):
    """(gd, state) past the first step (count 5, the second moment at the
    scale of phi^2), so each update is linear in phi."""
    from stein_tpu_torch import Adagrad, Adam
    from stein_tpu_torch.ops.optimizers import AdagradState, AdamState

    nu = torch.full((n, p), phi_sq, dtype=torch.float32, device=dev)
    count = torch.full((), 5, dtype=torch.int32, device=dev)
    lr = torch.full((), 0.1, dtype=torch.float32, device=dev)
    if rule == "adam":
        return (Adam(1e-1, decay=0.999),
                AdamState(torch.zeros_like(nu), nu, count, lr))
    return Adagrad(5e-2), AdagradState(nu, count, lr)


def model_stage_case(label, stage, plain, args, dev, torch):
    """A model stage against its plain version: logp rtol 2e-5 (atol 1e-5
    of max|logp|), grads <= 2e-5 max|g|, two calls bitwise. Returns the
    max abs error."""
    g, lp = stage(*args)
    g2, lp2 = stage(*args)
    g0, lp0 = plain(*args)
    torch.cuda.synchronize()
    lp_ex = ((lp - lp0).abs() - (1e-5 * lp0.abs().max()
                                 + 2e-5 * lp0.abs())).max().item()
    g_err = (g - g0).abs().max().item()
    g_bound = 2e-5 * g0.abs().max().item()
    same = torch.equal(g, g2) and torch.equal(lp, lp2)
    log(f"[kernels] {label}: logp excess over rtol 2e-5 {lp_ex:.3e}, grads "
        f"max abs {g_err:.3e} (bound {g_bound:.3e}), repeat bitwise {same}")
    if lp_ex > 0 or g_err > g_bound or not same:
        fail(f"{label} disagrees with its plain version or itself")
    return max(g_err, (lp - lp0).abs().max().item())


def check_tail_kernels(dev, torch, theta, g0, batch, lg_theta, lg_batch):
    """The glm and logistic stages, B10, B6 and B1's model and D-given
    chains against their plain versions on the card, on lattice particles
    and on the paths' own inputs. Returns (errors, inputs for timing)."""
    from stein_tpu_torch import _cuda
    from stein_tpu_torch.models import (
        LinearRegressionModel,
        LogisticRegressionModel,
    )
    from stein_tpu_torch.ops import fused_median, fused_step, model_grad
    from stein_tpu_torch.ops import svgd_tile
    from stein_tpu_torch.ops.median import (
        _strided_rows,
        row_subsample_block,
        subsample_rows,
    )
    from stein_tpu_torch.ops.rbf import pairwise_sq_dists

    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)
    errs, inputs = {}, {}
    rng = np.random.default_rng(5)

    # The glm stage on [main-glm]'s inputs and at n=50 (BASELINE #1).
    A, b, _ = LinearRegressionModel(P).quadratic_form(
        LinearRegressionModel(P).sufficient_batch(batch))
    glm = fused_step.InKernelModel((A, b.reshape(1, P)),
                                   model_grad.GlmGrad())
    inputs["glm"] = (theta, A, b.reshape(1, P))
    errs["glm"] = model_stage_case(
        f"glm stage n={N} p={P} (main-glm path)", model_grad.glm_grads,
        model_grad.glm_grads_plain, inputs["glm"], dev, torch)
    model_stage_case(f"glm stage n={GLM50_N} p={P}", model_grad.glm_grads,
                     model_grad.glm_grads_plain,
                     (theta[:GLM50_N], A, b.reshape(1, P)), dev, torch)

    # The logistic stage on [main-logreg]'s inputs and at a ragged shape.
    lmodel = LogisticRegressionModel(LOGREG_D, LOGREG_TRAIN, LOGREG_OBS)
    ikm = lmodel.inkernel_model(lg_batch)
    inputs["logistic"] = (lg_theta, *ikm.operands)
    inputs["logistic_fn"] = ikm.grad_fn
    errs["logistic"] = model_stage_case(
        f"logistic stage n={LOGREG_N} p={LOGREG_D + 1} N={LOGREG_OBS} "
        "(main-logreg path)", ikm.grad_fn, ikm.grad_fn.plain,
        inputs["logistic"], dev, torch)
    Xr = rng.normal(size=(33, 200))
    small = LogisticRegressionModel(200, 3300, 33).inkernel_model(
        {"X": torch.tensor(Xr, dtype=f32, device=dev),
         "y": torch.tensor((Xr[:, :1] > 0) * 1.0, dtype=f32, device=dev)})
    small_theta = torch.tensor(rng.normal(size=(97, 201)) * 0.1, dtype=f32,
                               device=dev)
    model_stage_case("logistic stage n=97 p=201 N=33", small.grad_fn,
                     small.grad_fn.plain, (small_theta, *small.operands),
                     dev, torch)

    # B10 on [main-fused]'s D and u, and at a ragged shape with p > 128:
    # <= 1e-5 normalised, two calls bitwise.
    D = pairwise_sq_dists(theta)
    h2 = fused_median.warm_search_on_value(
        _strided_rows(D, MEDIAN_ROWS), zero, 30) / np.log(N)
    u = g0 - theta / h2
    inputs["B10"] = (D, u, h2)
    cases = [(f"[{N}, {N}] x [{N}, {P}] (main-fused path)", D, u, h2)]
    t_r = torch.tensor(rng.normal(size=(777, 300)), dtype=f32, device=dev)
    D_r = pairwise_sq_dists(t_r)[:333].contiguous()
    h2_r = fused_median.warm_search_on_value(D_r, zero, 30) / np.log(777)
    cases.append(("[333, 777] x [777, 300]", D_r,
                  torch.randn_like(t_r) - t_r / h2_r, h2_r))
    for label, D_, u_, h2_ in cases:
        ku, ks = svgd_tile.svgd_both_ksum_on_D(D_, u_, h2_)
        ku2, ks2 = svgd_tile.svgd_both_ksum_on_D(D_, u_, h2_)
        ku0, ks0 = svgd_tile.svgd_both_ksum_on_D_plain(D_, u_, h2_)
        torch.cuda.synchronize()
        err = max(norm_err(ku, ku0), norm_err(ks, ks0))
        same = torch.equal(ku, ku2) and torch.equal(ks, ks2)
        log(f"[kernels] B10 {label}: normalised error {err:.3e} (bound "
            f"1e-05), repeat bitwise {same}")
        if err > 1e-5 or not same:
            fail(f"B10 {label} disagrees with its plain version or itself")
        errs.setdefault("B10", max((ku - ku0).abs().max().item(),
                                   (ks - ks0).abs().max().item()))
    # B10 at B12's shape as B12's chain runs it: u = g - (theta - c) / h^2
    # formed in the kernel about the centre, on the centred D of the NN
    # path's particles; the same bounds. At n=1000 the grid must cover the
    # 132 SMs at p = 128 and 303.
    th_nn = torch.tensor(nn_data(NN_N)[2], dtype=f32, device=dev)
    c_nn = svgd_tile.column_center(th_nn)
    D_nn = fused_median.dist_block_plain(th_nn, th_nn, c_nn)
    h2_nn = fused_median.warm_search_on_value(D_nn, zero, 30) / np.log(NN_N)
    args = (D_nn, torch.tensor(rng.normal(size=(NN_N, NN_P)), dtype=f32,
                               device=dev), th_nn, c_nn, h2_nn)
    ku, ks = svgd_tile.svgd_both_ksum_on_D_about(*args)
    ku2, ks2 = svgd_tile.svgd_both_ksum_on_D_about(*args)
    ku0, ks0 = svgd_tile.svgd_both_ksum_on_D_about_plain(*args)
    torch.cuda.synchronize()
    err = max(norm_err(ku, ku0), norm_err(ks, ks0))
    same = torch.equal(ku, ku2) and torch.equal(ks, ks2)
    lib = _cuda.library().lib
    grid = {p_: lib.stein_on_d_blocks(N, N, p_) for p_ in (P, NN_P)}
    log(f"[kernels] B10 [{NN_N}, {NN_N}] x [{NN_N}, {NN_P}], u formed about "
        f"the centre (B12's form): normalised error {err:.3e} (bound 1e-05), "
        f"repeat bitwise {same}; grid blocks at n={N} by p {grid}")
    if err > 1e-5 or not same:
        fail("B10 (u formed about the centre) disagrees with its plain "
             "version or itself")
    if min(grid.values()) < 132:
        fail(f"B10's grid does not cover the 132 SMs: {grid}")

    # B6 at [10240, 128], Adam and Adagrad, the clip active: rtol 2e-6 /
    # atol 1e-7 (the JAX suite's epilogue bound).
    t_n = torch.tensor(rng.normal(size=(LARGE_N, P)), dtype=f32, device=dev)
    ku_n = torch.tensor(rng.normal(size=(LARGE_N, P)), dtype=f32, device=dev)
    ks_n = torch.tensor(rng.uniform(1, 2, (LARGE_N, 1)), dtype=f32,
                        device=dev)
    c_n = svgd_tile.column_center(t_n)
    h2_n = torch.full((), 0.7, device=dev)
    norm_n = torch.full((), 40.0, device=dev)
    errs["B6"] = 0.0
    for rule in ("adam", "adagrad"):
        gd, state = opt_state(LARGE_N, P, rule, 1e-4, dev, torch)
        args = (ku_n, ks_n, t_n, c_n, h2_n, norm_n, state, gd, 10.0, LARGE_N)
        got = fused_step.fused_epilogue(*args)
        want = fused_step.fused_epilogue_plain(*args)
        torch.cuda.synchronize()
        ex = max(((a - b).abs() - (1e-7 + 2e-6 * b.abs())).max().item()
                 for a, b in zip([got[0], *got[1]], [want[0], *want[1]]))
        log(f"[kernels] B6 [{LARGE_N}, {P}] {rule}: excess over rtol 2e-6 / "
            f"atol 1e-7 {ex:.3e}")
        if ex > 0 or int(got[1].count) != 6:
            fail(f"B6 ({rule}) disagrees with its plain version")
        errs["B6"] = max(errs["B6"], (got[0] - want[0]).abs().max().item())
        if rule == "adam":
            inputs["B6"] = args

    # B1's model and D-given chains against _plain_tail's forms. Lattice
    # particles (glm with an integer A and b, so its gradients are exact
    # too): median and h^2 bitwise, the rest <= 1e-5 normalised. The paths'
    # own inputs: the median within one final interval of the tight
    # bracket, the rest <= 1e-2 normalised.
    lat = lattice(N, P, dev, torch)
    A_int = torch.tensor(rng.integers(-2, 3, size=(P, P)), dtype=f32,
                         device=dev)
    b_int = torch.tensor(rng.integers(-3, 4, size=(1, P)), dtype=f32,
                         device=dev)
    glm_int = fused_step.InKernelModel((A_int + A_int.T, b_int),
                                       model_grad.GlmGrad())
    lat_l = lattice(LOGREG_N, LOGREG_D + 1, dev, torch)
    g_lat = torch.tensor(rng.normal(size=(N, P)), dtype=f32, device=dev)
    D_lat = pairwise_sq_dists(lat)
    chains = [
        ("glm lattice", lat, None, glm_int, None, 128, True),
        ("glm main-glm path", theta, None, glm, None, 128, False),
        ("logistic lattice", lat_l, None, ikm, None, 128, True),
        ("logistic main-logreg path", lg_theta, None, ikm, None, 128, False),
        ("D-given lattice", lat, g_lat, None, D_lat, MEDIAN_ROWS, True),
        ("D-given main-fused path", theta, g0, None, D, MEDIAN_ROWS, False),
    ]
    errs["B1 chains"], inputs["chains"] = 0.0, {}
    for label, th, grads, model, D_, rows, exact in chains:
        n, p = th.shape
        sub = None if D_ is not None else subsample_rows(th, rows)
        D_sub = None if D_ is None else _strided_rows(D_, rows)
        med_prev = fused_median.warm_search_on_value(
            D_sub if D_ is not None else row_subsample_block(th, rows), zero,
            30)
        if not exact:
            inputs["chains"][label] = (th, grads, model, D_, D_sub, sub,
                                       med_prev)
        for rule in ("adam", "adagrad"):
            gd, state = opt_state(n, p, rule, 1.0, dev, torch)
            k = fused_step.fused_warm_step_tail(
                th, grads, D_, D_sub, med_prev, state, gd,
                gram_in_kernel=D_ is None, theta_sub=sub, model=model)
            q = fused_step._plain_tail(
                th, grads, sub, med_prev, state, gd, 10.0, 8,
                fused_step.DEFAULT_BRACKETS, D=D_, D_sub=D_sub, model=model)
            torch.cuda.synchronize()
            med_k, med_q = k[2][0].item(), q[2][0].item()
            width = (1.09 - 0.92) * med_prev.item() / 4 ** 4
            es = [norm_err(a, b) for a, b in
                  zip([k[0], *k[1], *k[2]], [q[0], *q[1], *q[2]])]
            log(f"[kernels] B1 {label} {rule}: med {med_k!r} vs {med_q!r}, "
                f"normalised errors {['%.2e' % e for e in es]}")
            if len(k[2]) != len(q[2]) or int(k[1].count) != 6:
                fail(f"B1 {label}: wrong stats or optimizer count")
            if exact and (med_k != med_q
                          or k[2][2].item() != q[2][2].item()):
                fail(f"B1 {label} ({rule}): median/h2 not bitwise")
            if abs(med_k - med_q) > width * 1.0001:
                fail(f"B1 {label} ({rule}): median off by more than one "
                     "interval")
            if max(es) > (1e-5 if exact else 1e-2):
                fail(f"B1 {label} ({rule}) off by {max(es):.3e}")
            errs["B1 chains"] = max(errs["B1 chains"],
                                    (k[0] - q[0]).abs().max().item())
    return errs, inputs


def check_counts(label, counters, want_nonzero):
    """The counts of the run just read against want_nonzero (others 0)."""
    got = read(counters)
    want = dict.fromkeys(counters, 0)
    want.update(want_nonzero)
    log(f"[{label}] launches {got}")
    if got != want:
        fail(f"[{label}] launch counts {got}, expected {want}")
    return got


def check_finite(label, sampler, aux, steps):
    if not np.all(np.isfinite(sampler.samples)):
        fail(f"[{label}] non-finite samples")
    for key, v in aux.items():
        if tuple(v.shape) != (steps,) or not bool(v.isfinite().all()):
            fail(f"[{label}] aux[{key!r}] is not {steps} finite values")


def run_tail_paths(dev, torch, counters, X, y, theta0, batch):
    """[main-glm] (and BASELINE #1's route), [main-logreg], [main-fused] and
    [large-n-epilogue]. Returns each path's launch counts and, for the
    timing, each path's (sampler, batch, plain runner)."""
    from stein_tpu_torch import Adagrad, Adam, SVGDSampler, throughput_config
    from stein_tpu_torch.api import _make_grad_all
    from stein_tpu_torch.models import (
        LinearRegressionModel,
        LogisticRegressionModel,
    )
    from stein_tpu_torch.utils.ravel import template_unraveler

    f32 = torch.float32
    lin = LinearRegressionModel(P)
    suff = lin.sufficient_batch(batch)
    lr_grads = _make_grad_all(lin.log_p, template_unraveler(lin.template())[1])
    counts, timed = {}, {}

    def run_path(label, sampler, b, steps, want):
        reset(counters)
        t0 = time.perf_counter()
        aux = sampler.run(b, steps)
        torch.cuda.synchronize()
        log(f"[{label}] run(batch, {steps}) in "
            f"{time.perf_counter() - t0:.2f} s (first call)")
        counts[label] = check_counts(label, counters, want)
        check_finite(label, sampler, aux, steps)
        log(f"[{label}] last step: " + ", ".join(
            f"{k}={v[-1].item():.6g}" for k, v in aux.items()))
        return aux

    # [main-glm]: the bench's LR recipe through throughput_config(model=).
    kw = throughput_config(N, P, model=lin)
    log(f"[main-glm] throughput_config({N}, {P}, model=...) = "
        f"{ {k: (v if not callable(v) else 'fn') for k, v in kw.items()} }")

    def glm_sampler(device):
        return SVGDSampler(N, lin.log_p, lin.template(), Adam(1e-1),
                           theta=theta0, device=device, **kw)

    s = glm_sampler("cuda")
    run_path("main-glm", s, suff, GLM_STEPS,
             dict(glm=GLM_STEPS, B1=GLM_STEPS, B2=1))
    compare_with_cpu(glm_sampler, suff, 10, "main-glm", 0.1)
    post = np.linalg.solve(X.T @ X + np.eye(P), X.T @ y).ravel()
    post_err = float(np.max(np.abs(s.samples.mean(0) - post)))
    log(f"[main-glm] posterior mean max abs error {post_err:.4e} (JAX "
        f"package on CPU: {POSTERIOR_GLM_JAX}, bound "
        f"{4 * POSTERIOR_GLM_JAX})")
    if not post_err <= 4 * POSTERIOR_GLM_JAX:
        fail("[main-glm] the particle mean is not near the posterior mean")
    timed["main-glm"] = (s, suff, plain_tail_runner(
        s, suff, 128, kw, lambda th, b: {"model": glm_model(lin, b)}))

    # BASELINE #1's route (bench.py:335-350): n=50, Adagrad(0.1).
    theta50 = np.random.default_rng(3).normal(size=(GLM50_N, P)) * 0.01
    kw50 = throughput_config(GLM50_N, P, model=lin)

    def glm50_sampler(device):
        return SVGDSampler(GLM50_N, lin.log_p, lin.template(), Adagrad(0.1),
                           theta=theta50, device=device, **kw50)

    run_path("main-glm n=50", glm50_sampler("cuda"), suff, GLM50_STEPS,
             dict(glm=GLM50_STEPS, B1=GLM50_STEPS))
    compare_with_cpu(glm50_sampler, suff, GLM50_CLASS_STEPS, "main-glm n=50",
                     0.1, adagrad_eps_regime)
    compare_spread("main-glm n=50", glm50_sampler, suff, 10,
                   GLM50_SPREAD_JAX, "xla vs fused_glm")

    # [main-logreg]: bench.py's logreg recipe through throughput_config.
    lmodel = LogisticRegressionModel(LOGREG_D, LOGREG_TRAIN, LOGREG_OBS)
    Xl, yl, theta_l = logreg_data()
    lbatch = {"X": torch.tensor(Xl, dtype=f32, device=dev),
              "y": torch.tensor(yl, dtype=f32, device=dev)}
    kwl = throughput_config(LOGREG_N, LOGREG_D + 1, model=lmodel)
    kwl.update(median_passes=16, warm_passes=6)
    log(f"[main-logreg] throughput_config({LOGREG_N}, {LOGREG_D + 1}, "
        "model=...) + median_passes=16, warm_passes=6 = "
        f"{ {k: (v if not callable(v) else 'fn') for k, v in kwl.items()} }")

    def logreg_sampler(device):
        return SVGDSampler(LOGREG_N, lmodel.log_p, lmodel.template(),
                           Adam(1e-1), theta=theta_l, device=device, **kwl)

    s = logreg_sampler("cuda")
    aux = run_path("main-logreg", s, lbatch, LOGREG_STEPS,
                   dict(logistic=LOGREG_STEPS, B1=LOGREG_STEPS, B2=1))
    lp = aux["log_p_mean"][-1].item()
    log(f"[main-logreg] log_p_mean step 1 {aux['log_p_mean'][0].item():.6g}, "
        f"step {LOGREG_STEPS} {lp!r}; JAX package: {LOGREG_LOGP_JAX} "
        f"(relative gap {abs(lp / LOGREG_LOGP_JAX - 1):.3e}, bound 1e-4)")
    if abs(lp / LOGREG_LOGP_JAX - 1) > 1e-4:
        fail("[main-logreg] log_p_mean at the last step is not within 1e-4 "
             "of the JAX package's")
    compare_with_cpu(logreg_sampler, lbatch, 10, "main-logreg", 0.1)
    timed["main-logreg"] = (s, lbatch, plain_tail_runner(
        s, lbatch, 128, kwl,
        lambda th, b: {"model": lmodel.inkernel_model(b)}))

    # [main-fused]: the LR recipe with step_impl='fused' (D given).
    kwf = dict(throughput_config(N, P), step_impl="fused")

    def fused_sampler(device):
        return SVGDSampler(N, lin.log_p, lin.template(), Adam(1e-1),
                           theta=theta0, device=device, **kwf)

    s = fused_sampler("cuda")
    run_path("main-fused", s, batch, STEPS, dict(B1=STEPS, B10=STEPS, B2=1))
    compare_with_cpu(fused_sampler, batch, FUSED_CLASS_STEPS, "main-fused",
                     0.1)
    compare_with_plain(
        "main-fused", lambda: fused_sampler("cuda"), batch,
        plain_tail_runner(fused_sampler("cuda"), batch, MEDIAN_ROWS, kwf,
                          lambda th, b: d_given(th, b, lr_grads)),
        FUSED_CLASS_STEPS, 0.1)
    compare_spread("main-fused", fused_sampler, batch, 10, FUSED_SPREAD_JAX,
                   "xla vs fused")
    timed["main-fused"] = (s, batch, plain_tail_runner(
        s, batch, MEDIAN_ROWS, kwf, lambda th, b: d_given(th, b, lr_grads)))

    # [large-n-epilogue]: [large-n]'s recipe with step_impl='epilogue' (B3,
    # B2, then B6); its first 4 steps against the plain functions on the
    # card under [large-n]'s rule.
    theta_n = np.random.default_rng(3).normal(size=(LARGE_N, P)) * 0.01
    kwe = dict(throughput_config(LARGE_N, P), step_impl="epilogue")

    def epi_sampler():
        return SVGDSampler(LARGE_N, lin.log_p, lin.template(), Adam(1e-1),
                           theta=theta_n, device="cuda", **kwe)

    s = epi_sampler()
    run_path("large-n-epilogue", s, batch, LARGE_STEPS,
             dict(B3=LARGE_STEPS, B2=LARGE_STEPS + 1, B6=LARGE_STEPS))
    compare_with_plain(
        "large-n-epilogue", epi_sampler, batch,
        plain_pallas_runner(epi_sampler(), batch, lr_grads, gram=False), 4,
        0.1)
    timed["large-n-epilogue"] = (s, batch, plain_pallas_runner(
        s, batch, lr_grads, gram=False))
    return counts, timed


# ---------------------------------------- the rest of the sampler (A2-A4)

# BASELINE #2 as bench.py:213-281 runs it: Covertype's 581012 rows, the
# 4/5 training split resident on the card, 100 particles, minibatch 50,
# 6000 Adam iterations through train_minibatched (step_impl='fused_model').
COV_ROWS, COV_D, COV_N, COV_BATCH, COV_STEPS = 581012, 54, 100, 50, 6000
COV_TRAIN = COV_ROWS * 4 // 5
COV_KEY = 7
# The rule of tests/test_sampler.py:658 for the particle-mean logits.
COV_ACCURACY = 0.9
# The KSD on the card (f32) against ksd_rbf in f64 on the same particles
# and scores. The f32 D = r + r^T - 2 T T^T loses about three digits to
# cancellation near the posterior ([main]: |theta|^2 ~ 128 against
# D ~ 0.25), so each K entry carries ~4e-4 relative error of either sign;
# the bound is 5x that.
KSD_RTOL = 2e-3
CKPT_STEPS = 250
IMQ_STEPS = 10


def covertype_data(torch, dev):
    """bench.py:237-243's draw (numpy seed 13): X [464809, 54] f32, w
    [54, 1], y = (X w > 0), resident on the card; then, from the same
    generator, a held-out set of the other 116203 rows labelled by the same
    w (numpy, for the accuracy check)."""
    rng = np.random.default_rng(13)
    X = rng.normal(size=(COV_TRAIN, COV_D)).astype(np.float32)
    w = rng.normal(size=(COV_D, 1))
    y = (X @ w > 0).astype(np.float32)
    Xh = rng.normal(size=(COV_ROWS - COV_TRAIN, COV_D)).astype(np.float32)
    yh = (Xh @ w > 0).ravel()
    return ({"X": torch.from_numpy(X).to(dev),
             "y": torch.from_numpy(y).to(dev)}, Xh, yh)


class MinibatchLoop:
    """sampler.train_minibatched(data, k, COV_BATCH, COV_KEY) behind
    run()'s interface, for profile_split and run_timed."""

    def __init__(self, sampler, data):
        self.sampler, self.data = sampler, data

    def run(self, batch, k):
        del batch
        return self.sampler.train_minibatched(self.data, k, COV_BATCH,
                                              COV_KEY)


def timed_call(fn, torch):
    """(fn()'s result, wall seconds, seconds by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, start.elapsed_time(end) / 1e3


def held_out_accuracy(sampler, model, Xh, yh, dev, torch):
    """The share of held-out labels that the particle-mean logits
    (function_posterior(..., axis=0)) get right."""
    mean_logits = sampler.function_posterior(
        model.logits, {"X": torch.from_numpy(Xh).to(dev)}, axis=0)
    return float(np.mean((mean_logits > 0) == yh))


def run_covertype(dev, torch, counters, gpu):
    """[covertype-e2e]. Returns its launch counts and the loop to
    profile."""
    from stein_tpu_torch import Adam, SVGDSampler
    from stein_tpu_torch.api import minibatch_indices
    from stein_tpu_torch.models import LogisticRegressionModel

    t_phase = time.perf_counter()
    data, Xh, yh = covertype_data(torch, dev)
    model = LogisticRegressionModel(COV_D, n_train=COV_TRAIN,
                                    n_batch=COV_BATCH)
    theta0 = np.random.default_rng(5).normal(size=(COV_N, COV_D + 1)) * 0.01
    cfg = dict(median="bisect", median_passes=16, warm_median=True,
               warm_passes=6, median_impl="fused", step_impl="fused_model",
               inkernel_model=model.inkernel_model)

    def make(device):
        return SVGDSampler(COV_N, model.log_p, model.template(), Adam(1e-1),
                           theta=theta0, device=device, **cfg)

    log(f"[covertype-e2e] data X [{COV_TRAIN}, {COV_D}] f32 and y on the "
        f"card ({(data['X'].numel() + data['y'].numel()) * 4 / 1e6:.1f} MB), "
        f"held-out {Xh.shape[0]} rows; n={COV_N}, Adam(0.1), {cfg}")
    a = make("cuda")
    reset(counters)
    aux, wall, ev = timed_call(lambda: a.train_minibatched(
        data, COV_STEPS, COV_BATCH, COV_KEY), torch)
    # The logistic stage and B1 every step. The carry's cold seed searches
    # the [100, 100] block, 10^4 entries, below the quad-ary regime (more
    # than 10^5) where B2 takes the search in both packages
    # (fused_median.fused_block_ok): the plain search seeds it, so B2
    # launches no time on this path.
    counts = check_counts("covertype-e2e", counters,
                          {"logistic": COV_STEPS, "B1": COV_STEPS})
    check_finite("covertype-e2e", a, aux, COV_STEPS)
    log(f"[covertype-e2e] {gpu}: train_minibatched(data, {COV_STEPS}, "
        f"{COV_BATCH}, key={COV_KEY}) first call {wall:.3f} s wall, "
        f"{ev * 1e6 / COV_STEPS:.2f} us/step by CUDA events; last step: "
        + ", ".join(f"{k}={v[-1].item():.6g}" for k, v in aux.items()))

    # A second call from the same state and key: bitwise the same.
    b = make("cuda")
    aux_b, wall_b, ev_b = timed_call(lambda: b.train_minibatched(
        data, COV_STEPS, COV_BATCH, COV_KEY), torch)
    log(f"[covertype-e2e] {gpu}: second call {wall_b:.3f} s wall for "
        f"{COV_STEPS} iterations, {ev_b * 1e6 / COV_STEPS:.2f} us/step by "
        "CUDA events")
    if not (np.array_equal(a.samples, b.samples) and all(
            torch.equal(aux[k], aux_b[k]) for k in aux)):
        fail("[covertype-e2e] two calls from the same state and key differ")

    # train_on_batches on the batches minibatch_indices draws for the key:
    # bitwise the same run.
    idx = minibatch_indices(COV_KEY, COV_STEPS, COV_BATCH, COV_TRAIN, dev)
    batches = {k: v[idx] for k, v in data.items()}
    c = make("cuda")
    aux_c, wall_c, ev_c = timed_call(lambda: c.train_on_batches(batches),
                                     torch)
    same = np.array_equal(a.samples, c.samples) and all(
        torch.equal(aux[k], aux_c[k]) for k in aux)
    log(f"[covertype-e2e] train_on_batches on the same {COV_STEPS} gathered "
        f"batches: bitwise equal {same}; {wall_c:.3f} s wall, "
        f"{ev_c * 1e6 / COV_STEPS:.2f} us/step by CUDA events (no gather)")
    if not same:
        fail("[covertype-e2e] train_minibatched differs from "
             "train_on_batches on its own indices")

    # The first 10 steps against the CPU run of the same batches, at the
    # fused_gram class (the model stage and B1's chain against their plain
    # versions).
    def drive(s_, b_, k):
        return s_.train_on_batches({kk: v[:k] for kk, v in b_.items()})
    cpu_batches = {k: v.cpu() for k, v in batches.items()}
    check_class("covertype-e2e", "the CPU",
                sampler_trial(lambda: make("cuda"), batches, 10, drive),
                sampler_trial(lambda: make("cpu"), cpu_batches, 10, drive),
                10, 0.1)

    # Held-out accuracy of the particle-mean logits, on the card and for
    # the CPU's plain run of the same 6000 batches.
    acc = held_out_accuracy(a, model, Xh, yh, dev, torch)
    cpu = make("cpu")
    t0 = time.perf_counter()
    cpu.train_on_batches(cpu_batches)
    cpu_wall = time.perf_counter() - t0
    acc_cpu = held_out_accuracy(cpu, model, Xh, yh, "cpu", torch)
    log(f"[covertype-e2e] held-out accuracy {acc!r} on the card, "
        f"{acc_cpu!r} for the CPU's plain run of the same batches "
        f"({cpu_wall:.1f} s on the host); bound > {COV_ACCURACY}")
    if not acc > COV_ACCURACY:
        fail(f"[covertype-e2e] held-out accuracy {acc} <= {COV_ACCURACY}")
    del batches, cpu_batches
    log(f"[covertype-e2e] phase {time.perf_counter() - t_phase:.1f} s")
    return counts, MinibatchLoop(a, data)


def check_ksd(label, sampler, batch, torch):
    """sampler.ksd (V and U) against ksd_rbf in f64 on the card on the same
    particles and scores. Returns the V-statistic."""
    from stein_tpu_torch.ops.diagnostics import KSD_DENSE_MAX_N, ksd_rbf

    theta = sampler.state.particles
    v = sampler.ksd(batch)
    u = sampler.ksd(batch, u_statistic=True)
    grads = sampler._score_fn(theta, batch)   # the scores ksd used
    t64, g64 = theta.double(), grads.double()
    v64 = ksd_rbf(t64, g64).item()
    u64 = ksd_rbf(t64, g64, u_statistic=True).item()
    rel = max(abs(v / v64 - 1), abs(u / u64 - 1))
    form = "dense" if theta.shape[0] <= KSD_DENSE_MAX_N else "streaming"
    log(f"[ksd] {label} (n={theta.shape[0]}, {form}): V {v!r} vs f64 "
        f"{v64!r}, U {u!r} vs f64 {u64!r}; max relative gap {rel:.3e} "
        f"(bound {KSD_RTOL:g})")
    if not (np.isfinite(v) and np.isfinite(u)) or rel > KSD_RTOL:
        fail(f"[ksd] {label}: the card's KSD is off the f64 one")
    return v


def run_slice_phases(dev, torch, counters, gpu, main_make, main_sampler,
                     batch, big, lr_batch):
    """[ksd] on [main]'s and [large-n]'s samplers after their runs,
    [checkpoint] and [kernel-imq] on [main]'s configuration. Returns each
    path's launch counts."""
    from stein_tpu_torch import InverseMultiquadricKernel
    from stein_tpu_torch.utils.recovery import train_with_recovery

    counts = {}
    t_phase = time.perf_counter()
    reset(counters)
    v_main = check_ksd("main", main_sampler, batch, torch)
    check_ksd("large-n", big, lr_batch, torch)
    v0 = main_make("cuda").ksd(batch)
    log(f"[ksd] main: KSD at theta0 {v0!r}, after {STEPS} steps {v_main!r} "
        "(must be below a tenth)")
    if not 0 <= v_main < v0 / 10:
        fail("[ksd] the KSD did not fall below a tenth of theta0's")
    # ksd is plain PyTorch (the JAX package computes it outside any
    # kernel): no kernel of the port launches.
    counts["ksd"] = check_counts("ksd", counters, {})
    log(f"[ksd] phase {time.perf_counter() - t_phase:.1f} s")

    # [checkpoint]: 250 steps, save, 250 more; a fresh sampler restores and
    # runs the same 250: bitwise equal. train_with_recovery stopped at the
    # halfway checkpoint and resumed in a fresh sampler ends bitwise on the
    # uninterrupted run.
    t_phase = time.perf_counter()
    work = os.path.join(HERE, "build", "chip_smoke_ckpt")
    os.makedirs(work, exist_ok=True)
    for name in os.listdir(work):
        os.remove(os.path.join(work, name))
    path = os.path.join(work, "main.npz")
    reset(counters)
    s1 = main_make("cuda")
    s1.run(batch, CKPT_STEPS)
    s1.save(path)
    s1.run(batch, CKPT_STEPS)
    s2 = main_make("cuda")
    s2.restore(path)
    restored_step = int(s2.state.step)
    s2.run(batch, CKPT_STEPS)
    with np.load(path) as f:
        meta = [str(x) for x in f["__meta__"]]
    want_sig = (".particles|.opt_state.mu|.opt_state.nu|.opt_state.count|"
                ".opt_state.learning_rate|.step")

    def make_batches(start, k):
        return {key: v.expand(k, *v.shape) for key, v in batch.items()}
    ref = main_make("cuda")
    train_with_recovery(ref, 2 * CKPT_STEPS, make_batches,
                        os.path.join(work, "ref.npz"), ckpt_every=CKPT_STEPS)
    rec_path = os.path.join(work, "recovery.npz")
    half = main_make("cuda")
    train_with_recovery(half, CKPT_STEPS, make_batches, rec_path,
                        ckpt_every=CKPT_STEPS)
    resumed = main_make("cuda")
    executed = train_with_recovery(resumed, 2 * CKPT_STEPS, make_batches,
                                   rec_path, ckpt_every=CKPT_STEPS)
    torch.cuda.synchronize()
    # run: s1 2 calls, s2 1; train_with_recovery: ref 2 chunks, half 1,
    # resumed 1. B2 seeds each call's carry.
    counts["checkpoint"] = check_counts("checkpoint", counters, {
        "B1": 7 * CKPT_STEPS, "B2": 7})
    same = np.array_equal(s1.samples, s2.samples) and all(
        torch.equal(x, y) for x, y in zip(s1.state.opt_state,
                                          s2.state.opt_state))
    same_rec = np.array_equal(resumed.samples, ref.samples)
    log(f"[checkpoint] save at step {CKPT_STEPS}, restored step "
        f"{restored_step}, {CKPT_STEPS} more steps bitwise equal {same}; "
        f"__meta__ {meta}; train_with_recovery resumed at step "
        f"{CKPT_STEPS} ran {executed} steps, bitwise equal to the "
        f"uninterrupted run {same_rec}")
    if not (same and same_rec and executed == CKPT_STEPS
            and restored_step == CKPT_STEPS):
        fail("[checkpoint] a restored run differs from the saved one")
    if meta != ["2", want_sig]:
        fail(f"[checkpoint] __meta__ {meta} is not the JAX package's")
    log(f"[checkpoint] phase {time.perf_counter() - t_phase:.1f} s")

    # [kernel-imq]: kernel=InverseMultiquadricKernel() at [main]'s shape
    # (plain PyTorch on the card, as the JAX package computes the generic
    # path outside any kernel), 10 steps against the CPU run at the
    # reference-semantics class.
    t_phase = time.perf_counter()

    def imq(device):
        return main_make(device, kernel=InverseMultiquadricKernel())
    reset(counters)
    got = sampler_trial(lambda: imq("cuda"), batch, IMQ_STEPS)
    counts["kernel-imq"] = check_counts("kernel-imq", counters, {})
    check_class("kernel-imq", "the CPU", got,
                sampler_trial(lambda: imq("cpu"),
                              {k: v.cpu() for k, v in batch.items()},
                              IMQ_STEPS),
                IMQ_STEPS, 0.1, tol=REFERENCE_CLASS)
    if not np.all(np.isfinite(got["samples"])):
        fail("[kernel-imq] non-finite samples")
    log(f"[kernel-imq] phase {time.perf_counter() - t_phase:.1f} s")
    return counts


# ------------------------------------------------------------ the mesh

def check_bracket_kernels(dev, torch, theta, nn_theta):
    """B8 and B9 against their plain versions on the card: on lattice
    particles D, mm and the counts bitwise; on the [mesh] paths' own inputs
    ([256, 1000] x 128 and x 303), a 4-rank shard's [64, 1000], the ring
    shape and one row against one column (p 1 and 303) D <= 1e-5
    normalised, and the counts and mm those of the kernel's own D, bitwise;
    two calls bitwise; the thresholds the kernel forms bitwise those of
    grid_edges (g1 1, 8, 16; hints and bounds down to subnormals and up to
    the f32 range's end) and of the bracket endpoints. Returns (max abs
    errors, the timing inputs)."""
    from stein_tpu_torch.ops import fused_median as fm
    from stein_tpu_torch.ops import svgd_tile
    from stein_tpu_torch.ops.median import DEFAULT_BRACKETS, count_le

    rng = np.random.default_rng(6)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    errs, inputs = {"B8": 0.0, "B9": 0.0}, {}
    ring_cols = torch.tensor(rng.normal(size=(RING_N, P)) * 0.01,
                             dtype=torch.float32, device=dev)
    cases = [("lattice", lattice(N, P, dev, torch), None, True),
             (f"[mesh] path [{MEDIAN_ROWS}, {N}] p={P}", theta, None, False),
             (f"[mesh-nn] path [{MEDIAN_ROWS}, {NN_N}] p={NN_P}", nn_theta,
              None, False),
             (f"ring shape [{RING_M}, {RING_N}] p={P}", ring_cols,
              torch.tensor(rng.normal(size=(RING_M, P)) * 0.01,
                           dtype=torch.float32, device=dev), False),
             (f"4-rank shard [64, {N}] p={P}", theta, theta[::N // 64][:64],
              False)]
    for p in (1, NN_P):
        one = torch.tensor(rng.normal(size=(2, p)), dtype=torch.float32,
                           device=dev)
        cases.append((f"[1, 1] p={p}", one[:1], one[1:], False))
    for label, cols, rows, exact in cases:
        if rows is None:
            rows = cols[::cols.shape[0] // MEDIAN_ROWS][:MEDIAN_ROWS]
        c = svgd_tile.column_center(cols)
        med = fm.warm_search_on_value(fm.dist_block_plain(rows, cols, c),
                                      zero, 30)
        hib = 4.0 * torch.max(torch.sum((cols - c) ** 2, dim=1)) * 1.0001 \
            + 1e-30
        out8 = fm.fused_bracket_pass(rows, cols, med, c)
        again8 = fm.fused_bracket_pass(rows, cols, med, c)
        out9 = fm.fused_bracket_grid_pass(rows, cols, med, c, hib, g1=8)
        again9 = fm.fused_bracket_grid_pass(rows, cols, med, c, hib, g1=8)
        torch.cuda.synchronize()
        D, mm, cnts = out8
        Dp, mmp, cp = fm.fused_bracket_pass_plain(rows, cols, med, c)
        _, gp = fm.fused_bracket_grid_pass_plain(rows, cols, med, c, hib,
                                                 g1=8)
        own = (torch.equal(cnts, count_le(D, fm._bracket_ends(
                   med, DEFAULT_BRACKETS)))
               and torch.equal(mm, torch.stack(
                   [-torch.clamp(D.min(), max=0.0), D.max()]))
               and torch.equal(out9[1], count_le(out9[0], fm.grid_edges(
                   med, hib, DEFAULT_BRACKETS, 8)))
               and torch.equal(out9[0], D))
        repeat = all(torch.equal(a, b) for a, b in
                     zip((*out8, *out9), (*again8, *again9)))
        err = norm_err(D, Dp)
        log(f"[kernels] B8/B9 {label}: D normalised error {err:.3e}, "
            f"bitwise {torch.equal(D, Dp)}; counts and mm of the kernel's "
            f"own D {own}; repeat bitwise {repeat}; B8 counts "
            f"{cnts.tolist()} vs plain {cp.tolist()}")
        if not (own and repeat) or err > 1e-5 or (exact and not (
                torch.equal(D, Dp) and torch.equal(mm, mmp)
                and torch.equal(cnts, cp) and torch.equal(out9[1], gp))):
            fail(f"B8/B9 ({label}) disagree with their plain versions or "
                 "themselves")
        if not exact:
            e = (D - Dp).abs().max().item()
            errs["B8"] = max(errs["B8"], e)
            errs["B9"] = max(errs["B9"], e)
        if label.startswith("[mesh] path"):
            inputs = {"B8": (rows, cols, med, c),
                      "B9": (rows, cols, med, c, hib)}

    # The thresholds the kernel formed, bitwise (as int32: the NaN of an
    # inf - inf at the f32 range's end included).
    rows, cols, med0, c, hib0 = bracket_inputs(theta, 64, dev, torch)
    big = float(np.finfo(np.float32).max)
    tiny = float(np.finfo(np.float32).smallest_subnormal)
    scalars = [(None, None), (0.0, 0.0), (tiny, 7 * tiny), (2.5e-39, 1e-38),
               (1e30, 3e38), (0.731, 0.99 * big), (0.5 * big, big)]
    bad = []
    for med, hib in scalars:
        med = med0 if med is None else torch.tensor(med, device=dev)
        hib = hib0 if hib is None else torch.tensor(hib, device=dev)
        for g1 in (1, 8, 16):
            D, _, cnts, thr = fm._launch_bracket(rows, cols, c, med,
                                                 DEFAULT_BRACKETS, hib, g1)
            edges = fm.grid_edges(med, hib, DEFAULT_BRACKETS, g1)
            if not (torch.equal(thr.view(torch.int32),
                                edges.view(torch.int32))
                    and torch.equal(cnts, count_le(D, edges))):
                bad.append((med.item(), hib.item(), g1))
        _, _, _, thr8 = fm._launch_bracket(rows, cols, c, med,
                                           DEFAULT_BRACKETS)
        if not torch.equal(thr8.view(torch.int32), fm._bracket_ends(
                med, DEFAULT_BRACKETS).view(torch.int32)):
            bad.append((med.item(), "B8"))
    log(f"[kernels] B8/B9 thresholds formed in the kernel at "
        f"{len(scalars)} (med_prev, hi_bound) pairs x g1 1, 8, 16: bitwise "
        f"grid_edges' and the bracket endpoints: {not bad}")
    if bad:
        fail(f"B8/B9's thresholds differ from grid_edges at {bad}")
    return errs, inputs


@contextlib.contextmanager
def plain_kernels():
    """The mesh paths' kernels swapped for their plain versions (on the
    card's tensors) while the block runs: B8, B9, B3 and B7."""
    from stein_tpu_torch.models import bayesian_nn
    from stein_tpu_torch.ops import fused_median as fm
    from stein_tpu_torch.ops import svgd_tile
    from stein_tpu_torch.parallel import sharded_fused

    def nn_plain(theta, batch, f, H, consts):
        return bayesian_nn.nn_grads_plain(
            theta, batch["X"], batch["y"].reshape(-1), f, H, consts)

    swaps = [(sharded_fused, "fused_bracket_pass",
              fm.fused_bracket_pass_plain),
             (sharded_fused, "fused_bracket_grid_pass",
              fm.fused_bracket_grid_pass_plain),
             (svgd_tile, "svgd_both_ksum", svgd_tile.svgd_both_ksum_plain),
             (bayesian_nn, "nn_grads", nn_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def run_mesh_paths(dev, torch, counters, X, y, theta0, batch, nn_model):
    """[mesh], [mesh-grid], [mesh-ring], [mesh-glm] and [mesh-nn] on a
    one-process NCCL group (the CPU comparisons on a one-process gloo group
    of the same process). Returns each path's launch counts and, for the
    timing, each path's (sampler, batch), and the NCCL mesh."""
    import torch.distributed as dist

    from stein_tpu_torch import Adam, SVGDSampler, throughput_config
    from stein_tpu_torch.models import LinearRegressionModel
    from stein_tpu_torch.parallel import collectives as coll
    from stein_tpu_torch.parallel import particle_mesh, setup_distributed

    setup_distributed("nccl", store=dist.HashStore(), world_size=1, rank=0,
                      device_id=dev)
    mesh = particle_mesh()
    cpu_mesh = particle_mesh(dist.new_group(backend="gloo"))
    t0 = time.perf_counter()
    coll.psum(torch.ones(1, device=dev), mesh)   # NCCL's lazy set-up
    torch.cuda.synchronize()
    log(f"[mesh] {mesh}; first NCCL collective "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    lin = LinearRegressionModel(P)
    suff = lin.sufficient_batch(batch)
    counts, timed = {}, {}

    def sampler_for(n, model, theta, cfg):
        def make(device):
            m = mesh if device == "cuda" else cpu_mesh
            return SVGDSampler(n, model.log_p, model.template(),
                               Adam(0.1, decay=0.999 if model is nn_model
                                    else 1.0),
                               theta=theta, device=device,
                               **dict(cfg, mesh=m))
        return make

    def run_path(label, make, b, want, lr=0.1):
        s = make("cuda")
        reset(counters)
        t0 = time.perf_counter()
        aux = s.run(b, MESH_STEPS)
        torch.cuda.synchronize()
        log(f"[{label}] run(batch, {MESH_STEPS}) in "
            f"{time.perf_counter() - t0:.2f} s (first call)")
        counts[label] = check_counts(label, counters, want)
        check_finite(label, s, aux, MESH_STEPS)
        log(f"[{label}] last step: " + ", ".join(
            f"{k}={v[-1].item():.6g}" for k, v in aux.items()))
        compare_with_cpu(make, b, 10, label, lr)
        timed[label] = (s, b)
        return s, aux

    def posterior(label, s, bound_jax):
        post = np.linalg.solve(X.T @ X + np.eye(P), X.T @ y).ravel()
        err = float(np.max(np.abs(s.samples.mean(0) - post)))
        log(f"[{label}] posterior mean max abs error {err:.4e} (JAX "
            f"package's fused_shard on CPU: {bound_jax}, bound "
            f"{4 * bound_jax})")
        if not err <= 4 * bound_jax:
            fail(f"[{label}] the particle mean is not near the posterior")

    cfg = throughput_config(N, P, mesh=mesh)
    log(f"[mesh] throughput_config({N}, {P}, mesh=) = "
        f"{ {k: str(v) for k, v in cfg.items() if k != 'mesh'} }")
    if cfg.get("step_impl") != "fused_shard" or \
            cfg.get("median_collectives") != "rounds":
        fail("[mesh] throughput_config did not pick fused_shard/rounds")
    make = sampler_for(N, lin, theta0, cfg)
    s, _ = run_path("mesh", make, batch, dict(B8=MESH_STEPS, B3=MESH_STEPS))
    posterior("mesh", s, POSTERIOR_MESH_JAX)
    single = throughput_config(N, P)
    check_class("mesh", "the single-device fused_gram sampler on the card",
                sampler_trial(lambda: make("cuda"), batch, 10),
                sampler_trial(lambda: SVGDSampler(
                    N, lin.log_p, lin.template(), Adam(0.1), theta=theta0,
                    device="cuda", **single), batch, 10), 10, 0.1)

    run_path("mesh-grid", sampler_for(
        N, lin, theta0, dict(cfg, median_collectives="grid")), batch,
        dict(B9=MESH_STEPS, B3=MESH_STEPS))
    run_path("mesh-ring", sampler_for(
        N, lin, theta0, dict(cfg, median_collectives="grid", comm="ring")),
        batch, dict(B9=MESH_STEPS, B3=MESH_STEPS))

    cfg_glm = throughput_config(N, P, mesh=mesh, model=lin)
    if "quadratic_form" not in cfg_glm:
        fail("[mesh-glm] throughput_config(model=) gave no quadratic_form")
    s, _ = run_path("mesh-glm", sampler_for(N, lin, theta0, cfg_glm), suff,
                    dict(B8=MESH_STEPS, B3=MESH_STEPS))
    posterior("mesh-glm", s, POSTERIOR_MESH_GLM_JAX)

    Xn, yn, theta_nn = nn_data(NN_N)
    nn_batch = {"X": torch.tensor(Xn, dtype=torch.float32, device=dev),
                "y": torch.tensor(yn, dtype=torch.float32, device=dev)}
    cfg_nn = throughput_config(NN_N, NN_P, mesh=mesh, model=nn_model)
    if "custom_grads" not in cfg_nn:
        fail("[mesh-nn] throughput_config(model=) gave no custom_grads")
    _, aux = run_path("mesh-nn", sampler_for(NN_N, nn_model, theta_nn,
                                             cfg_nn), nn_batch,
                      dict(B7=MESH_STEPS, B8=MESH_STEPS, B3=MESH_STEPS))
    lp = aux["log_p_mean"][-1].item()
    log(f"[mesh-nn] log_p_mean step {MESH_STEPS} {lp!r}; JAX package's "
        f"one-device mesh run: {NN_MESH_LOGP_JAX} (relative gap "
        f"{abs(lp / NN_MESH_LOGP_JAX - 1):.3e}, bound {NN_LOGP_RTOL:g})")
    if abs(lp / NN_MESH_LOGP_JAX - 1) > NN_LOGP_RTOL:
        fail(f"[mesh-nn] log_p_mean is not within {NN_LOGP_RTOL:g} of the "
             "JAX package's")
    return counts, timed, mesh


def profile_split(label, sampler, batch, steps, torch, gpu):
    """torch.profiler over `steps` steps of sampler.run after 10 warm-up
    steps: wall and device time per step, the device's busy share, and the
    kernels by device time (self device time per step, launches per step).
    Prints "not captured" when the profiler reports no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sampler.run(batch, 10)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sampler.run(batch, steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) / steps * 1e6
    rows = []
    for e in prof.key_averages():   # the kernels' own events only
        t = (getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0) or 0)
        if getattr(e, "device_type", None) == DeviceType.CUDA and t > 0:
            rows.append((t / steps, e.key, e.count / steps))
    rows.sort(reverse=True)
    dev_us = sum(r[0] for r in rows)
    if not rows:
        log(f"[profile] {gpu}: {label}: device time not captured by "
            "torch.profiler")
        return
    coll_us = sum(r[0] for r in rows if "nccl" in r[1].lower())
    log(f"[profile] {gpu}: {label}: wall {wall_us:.1f} us/step under the "
        f"profiler; device {dev_us:.1f} us/step; busy {dev_us / wall_us:.3f}"
        f"; device launches {sum(r[2] for r in rows):.1f}/step; collectives "
        f"(NCCL kernels) {coll_us:.1f} us/step, share "
        f"{coll_us / dev_us:.3f} of device time")
    shown = rows[:10] + [r for r in rows[10:] if "stein" in r[1]]
    log(f"[profile] {label} kernels (us/step, launches/step; the ten "
        "largest, then the port's own): " + "; ".join(
            f"{k[:48]} {t:.1f} ({c:.0f})" for t, k, c in shown))


def compare_spread(label, make, batch, steps, spread, paths):
    """`steps` steps of make("cuda") against make("cpu"): the samples' max
    abs difference within the spread of the JAX package's own two paths."""
    a, c = make("cuda"), make("cpu")
    a.run(batch, steps)
    c.run({k: v.cpu() for k, v in batch.items()}, steps)
    diff = float(np.abs(a.samples - c.samples).max())
    log(f"[{label}] {steps} steps vs the CPU: samples max abs {diff:.3e} "
        f"(the JAX package's own {paths} spread {spread})")
    if not diff <= spread:
        fail(f"[{label}] {steps} steps left the JAX package's own spread")


def glm_model(lin, batch):
    from stein_tpu_torch.ops.fused_step import InKernelModel
    from stein_tpu_torch.ops.model_grad import GlmGrad

    A, b, const = lin.quadratic_form(batch)
    return InKernelModel((A, b.reshape(1, -1)), GlmGrad(), const)


def d_given(theta, batch, grad_all):
    from stein_tpu_torch.ops.median import _strided_rows
    from stein_tpu_torch.ops.rbf import pairwise_sq_dists

    D = pairwise_sq_dists(theta)
    return {"grads": grad_all(theta, batch)[1], "D": D,
            "D_sub": _strided_rows(D, MEDIAN_ROWS)}


def plain_tail_runner(sampler, batch, rows, cfg, step_kw):
    """run() of a fused-tail sampler with every kernel's plain version
    called on the card's tensors: the cold median by the plain search on
    the strided block, then per step _plain_tail with step_kw(theta,
    batch)'s gradients, D or model. run(k) starts from the sampler's state
    and returns (theta, optimizer state, [median], [phi_norm]) after k
    steps; the sampler is not advanced."""
    import torch
    from stein_tpu_torch.ops import fused_median, fused_step
    from stein_tpu_torch.ops.median import row_subsample_block, subsample_rows

    def run(n_steps):
        s = sampler.state
        theta, opt = s.particles, s.opt_state
        med = fused_median.warm_search_on_value(
            row_subsample_block(theta, rows),
            torch.zeros((), device=theta.device),
            cfg.get("median_passes", 30))
        meds, norms = [], []
        for _ in range(n_steps):
            kw = step_kw(theta, batch)
            sub = None if "D" in kw else subsample_rows(theta, rows)
            theta, opt, stats = fused_step._plain_tail(
                theta, kw.pop("grads", None), sub, med, opt, sampler.gd,
                10.0, cfg.get("warm_passes", 8), fused_step.DEFAULT_BRACKETS,
                **kw)
            med = stats[0]
            meds.append(med)
            norms.append(stats[1])
        return theta, opt, meds, norms
    return run


def compare_with_plain(label, make, batch, runner, steps, lr):
    """The first `steps` steps of make() against runner (a plain runner of
    another sampler from the same state) on the card, at the class."""
    import torch

    _, opt1, _, _ = runner(1)
    theta_k, _, meds, norms = runner(steps)
    check_class(label, "the plain functions on the card",
                sampler_trial(make, batch, steps),
                {"phi1": opt1.mu.cpu().numpy(),
                 "samples": theta_k.cpu().numpy(),
                 "median": torch.stack(meds).cpu().numpy(),
                 "phi_norm": torch.stack(norms).cpu().numpy()}, steps, lr)


# --------------------------------------------- B11 and B12, entry points
# Neither is reached from SVGDSampler (the JAX sampler has no option for
# them either): each path calls its function as the JAX package's own
# test and benchmark do.

PBLOCK_STEPS = 500
# The mean log_p of the 500th gradient call of [main-nn-pblock]'s loop in
# the JAX package (pallas_grads(interpret=True) then fused_warm_step_pblock(
# interpret=True) under jax.jit, CPU): -17.879913 at step 1, -16.245863 at
# step 10; tests/test_torch_reference_values.py recomputes it. The port is
# held to 1e-4 relative: other tails of this NN land about 2e-4 from it
# ([mesh-nn] -40.892), so a looser bound would not tell B12's full-n^2
# median from a row subsample.
NN_PBLOCK_LOGP_JAX = -40.900760650634766
# [large-n-sym]: benchmarks/sym_and_gram_bench.py:108-138's loop, theta
# <- theta + 1e-6 phi(theta) from theta0 = 0.1 N(0, I), grads N(0, I)
# (numpy seed 0), h^2 = 1.
SYM_N, SYM_P, SYM_ITERS = 10240, 128, 50


class PblockLoop:
    """[main-nn-pblock]'s loop: per step logp, grads = B7 at theta, then
    theta, opt, (med, phi_norm, h2) = B12, med starting at 0 (the cold
    search); Adam(0.1, decay=0.999). ``plain`` runs each kernel's plain
    version on the same tensors. run(batch, k) advances the loop k steps
    and returns the per-step log_p mean, median and phi_norm."""

    def __init__(self, model, theta0, device, plain=False):
        import torch
        from types import SimpleNamespace

        from stein_tpu_torch import Adam

        self.model, self.plain = model, plain
        self.gd = Adam(0.1, decay=0.999)
        theta = torch.tensor(theta0, dtype=torch.float32, device=device)
        self.state = SimpleNamespace(particles=theta, opt_state=self.gd.init(
            tuple(theta.shape), device=device))
        self.med = torch.zeros((), device=device)
        self.grad_fn = model.pallas_grads()

    def run(self, batch, steps):
        import torch
        from stein_tpu_torch.models import bayesian_nn
        from stein_tpu_torch.ops import fused_step

        theta, opt, med = self.state.particles, self.state.opt_state, self.med
        out = {"log_p_mean": [], "median": [], "phi_norm": []}
        for _ in range(steps):
            if self.plain:
                logp, grads = bayesian_nn.nn_grads_plain(
                    theta, batch["X"], batch["y"].reshape(-1),
                    self.model.n_feats, self.model.n_hidden,
                    self.model._consts())
                theta, opt, stats = fused_step._plain_tail(
                    theta, grads, None, med, opt, self.gd, 10.0, 8,
                    fused_step.DEFAULT_BRACKETS)
            else:
                logp, grads = self.grad_fn(theta, batch)
                theta, opt, stats = fused_step.fused_warm_step_pblock(
                    theta, grads, med, opt, self.gd)
            med = stats[0]
            out["log_p_mean"].append(logp.mean())
            out["median"].append(stats[0])
            out["phi_norm"].append(stats[1])
        self.state.particles, self.state.opt_state, self.med = theta, opt, med
        return {k: torch.stack(v) for k, v in out.items()}

    @property
    def samples(self):
        return self.state.particles.cpu().numpy()


class SymLoop:
    """[large-n-sym]'s loop: theta <- theta + 1e-6 phi_fn(theta, grads,
    h2). run(batch, k) takes k iterations (batch is unused)."""

    def __init__(self, theta, grads, h2, phi_fn):
        self.theta, self.grads, self.h2, self.phi_fn = theta, grads, h2, \
            phi_fn

    def run(self, batch, steps):
        for _ in range(steps):
            self.theta = self.theta + 1e-6 * self.phi_fn(self.theta,
                                                          self.grads, self.h2)


def sym_data(dev, torch):
    rng = np.random.default_rng(0)
    theta0 = rng.normal(size=(SYM_N, SYM_P)) * 0.1
    grads = rng.normal(size=(SYM_N, SYM_P))
    return (torch.tensor(theta0, dtype=torch.float32, device=dev),
            torch.tensor(grads, dtype=torch.float32, device=dev))


def check_sym_pblock_kernels(dev, torch, nn_model, nn_batch, nn_theta):
    """B11 and B12 against their plain versions on the card. Returns (the
    max abs error of each on its path's inputs, the timing inputs)."""
    from stein_tpu_torch.ops import fused_median, fused_step, svgd_tile
    from stein_tpu_torch.ops.median import row_subsample_block

    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)
    rng = np.random.default_rng(9)
    errs, inputs = {}, {}

    # B11: the [large-n-sym] path's first input; n=1000, p=303 on the NN
    # path's particles and gradients (n not a multiple of the 128-row
    # tile); n=3000, p=64; and off the origin (|theta| 3.9-5.0: B11 does
    # not centre; 1e-4, the CPU tests' bound). Near the origin 1e-5
    # normalised (the JAX suite's B11 bound). Two calls bitwise.
    def h2_of(theta):
        return fused_median.warm_search_on_value(
            row_subsample_block(theta, 128), zero, 30) / np.log(
                theta.shape[0])

    def sym_case(label, theta, grads, h2, bound):
        got = svgd_tile.svgd_phi_sym(theta, grads, h2)
        again = svgd_tile.svgd_phi_sym(theta, grads, h2)
        want = svgd_tile.svgd_phi_sym_plain(
            theta, grads, torch.as_tensor(h2, dtype=f32, device=dev))
        torch.cuda.synchronize()
        err = norm_err(got, want)
        log(f"[kernels] B11 {label}: normalised error {err:.3e} (bound "
            f"{bound:g}), repeat bitwise {torch.equal(got, again)}")
        if err > bound or not torch.equal(got, again):
            fail(f"B11 {label} disagrees with its plain version or itself")
        return (got - want).abs().max().item()

    theta_s, grads_s = sym_data(dev, torch)
    errs["B11"] = sym_case(f"large-n-sym path n={SYM_N} p={SYM_P}", theta_s,
                           grads_s, 1.0, 1e-5)
    inputs["B11"] = (theta_s, grads_s, 1.0)
    _, g_nn = nn_model.pallas_grads()(nn_theta, nn_batch)
    h2_nn = h2_of(nn_theta)
    sym_case(f"ragged n={NN_N} p={NN_P} (the NN path's inputs)", nn_theta,
             g_nn, h2_nn, 1e-5)
    # Ten calls, and grids of one and of seven blocks (SYM_BLOCKS), give
    # the same bits: each slice adds its contributions in slot order
    # whatever block takes whatever unit.
    for label, th, g, h2 in (
            (f"large-n-sym path n={SYM_N} p={SYM_P}", theta_s, grads_s, 1.0),
            (f"ragged n={NN_N} p={NN_P}", nn_theta, g_nn, h2_nn)):
        first = svgd_tile.svgd_phi_sym(th, g, h2)
        ten = all(torch.equal(first, svgd_tile.svgd_phi_sym(th, g, h2))
                  for _ in range(9))
        grid, by_grid = svgd_tile.SYM_BLOCKS, {}
        try:
            for blocks in (1, 7):
                svgd_tile.SYM_BLOCKS = blocks
                by_grid[blocks] = torch.equal(
                    first, svgd_tile.svgd_phi_sym(th, g, h2))
        finally:
            svgd_tile.SYM_BLOCKS = grid
        log(f"[kernels] B11 {label}: ten calls bitwise equal {ten}; grids of "
            f"1 and 7 blocks bitwise equal to the full grid {by_grid}")
        if not ten or not all(by_grid.values()):
            fail(f"B11 {label}: phi depends on the call or on the grid")
    t3 = torch.tensor(rng.normal(size=(3000, 64)) * 0.3, dtype=f32,
                      device=dev)
    sym_case("n=3000 p=64", t3, torch.randn_like(t3), h2_of(t3), 1e-5)
    t_off = torch.tensor(rng.normal(size=(300, 130)) * 0.3 + 0.25,
                         dtype=f32, device=dev)
    sym_case("off the origin n=300 p=130", t_off, torch.randn_like(t_off),
             h2_of(t_off), 1e-4)

    # B12 against _plain_tail with every row kept, Adam and Adagrad. On
    # lattice particles (D exact in any order) cold and warm: median and
    # h^2 bitwise, the rest <= 1e-5 normalised. On the path's own inputs
    # (theta0, B7's gradients there, the plain cold median as hint): the
    # median within one final interval of the tight bracket, (1.09 - 0.92)
    # hint / 4^4, the rest <= 1e-2 normalised (as B1's checks).
    lat = lattice(NN_N, NN_P, dev, torch)
    g_lat = torch.tensor(rng.normal(size=(NN_N, NN_P)), dtype=f32,
                         device=dev)
    c_nn = nn_theta.mean(0, keepdim=True)
    hint = fused_median.warm_search_on_value(
        fused_median.dist_block_plain(nn_theta, nn_theta, c_nn), zero, 30)
    cases = [("lattice cold", lat, g_lat, zero, True),
             ("lattice warm", lat, g_lat, None, True),
             ("main-nn-pblock path", nn_theta, g_nn, hint, False)]
    errs["B12"] = 0.0
    for label, th, g, med_prev, exact in cases:
        for rule in ("adam", "adagrad"):
            gd, state = opt_state(NN_N, NN_P, rule, 1.0, dev, torch)
            if med_prev is None:   # warm: 1.01 x the cold median
                med_prev = q[2][0] * 1.01
            k = fused_step.fused_warm_step_pblock(th, g, med_prev, state, gd)
            q = fused_step._plain_tail(th, g, None, med_prev, state, gd,
                                       10.0, 8, fused_step.DEFAULT_BRACKETS)
            torch.cuda.synchronize()
            med_k, med_q = k[2][0].item(), q[2][0].item()
            es = [norm_err(a, b) for a, b in
                  zip([k[0], *k[1], *k[2]], [q[0], *q[1], *q[2]])]
            log(f"[kernels] B12 {label} {rule}: med {med_k!r} vs {med_q!r}, "
                f"h2 {k[2][2].item()!r} vs {q[2][2].item()!r}, normalised "
                f"errors {['%.2e' % e for e in es]}")
            if int(k[1].count) != 6:
                fail(f"B12 {label} ({rule}): optimizer count not advanced")
            if exact and (med_k != med_q or k[2][2].item() != q[2][2].item()):
                fail(f"B12 {label} ({rule}): median/h2 not bitwise")
            if not exact:
                width = (1.09 - 0.92) * med_prev.item() / 4 ** 4
                if abs(med_k - med_q) > width * 1.0001:
                    fail(f"B12 {label} ({rule}): median off by more than "
                         "one interval")
                errs["B12"] = max(errs["B12"],
                                  (k[0] - q[0]).abs().max().item())
                if rule == "adam":
                    inputs["B12"] = (th, g, med_prev, state, gd)
            if max(es) > (1e-5 if exact else 1e-2):
                fail(f"B12 {label} ({rule}) off by {max(es):.3e}")
    return errs, inputs


def run_entry_paths(dev, torch, nn_model, counters):
    """[main-nn-pblock] (B7, B12) and [large-n-sym] (B11). Returns each
    path's launch counts and, for the timing, each path's (loop, batch,
    plain loop)."""
    from stein_tpu_torch.ops import fused_step, svgd_tile

    counts, timed = {}, {}
    X, y, theta0 = nn_data(NN_N)
    batch = {"X": torch.tensor(X, dtype=torch.float32, device=dev),
             "y": torch.tensor(y, dtype=torch.float32, device=dev)}
    if not fused_step.pblock_step_fits(NN_N, NN_P):
        fail(f"[main-nn-pblock] pblock_step_fits({NN_N}, {NN_P}) is False")
    loop = PblockLoop(nn_model, theta0, dev)
    reset(counters)
    t0 = time.perf_counter()
    aux = loop.run(batch, PBLOCK_STEPS)
    torch.cuda.synchronize()
    log(f"[main-nn-pblock] {PBLOCK_STEPS} steps of B7 then "
        f"fused_warm_step_pblock (n={NN_N}, p={NN_P}; pblock_step_fits "
        f"True) in {time.perf_counter() - t0:.2f} s (first call)")
    counts["main-nn-pblock"] = check_counts(
        "main-nn-pblock", counters, dict(B7=PBLOCK_STEPS, B12=PBLOCK_STEPS))
    check_finite("main-nn-pblock", loop, aux, PBLOCK_STEPS)
    lp = aux["log_p_mean"]
    log(f"[main-nn-pblock] log_p_mean step 1 {lp[0].item():.6g}, step 10 "
        f"{lp[9].item():.6g}, step {PBLOCK_STEPS} {lp[-1].item()!r}; JAX "
        f"package: {NN_PBLOCK_LOGP_JAX}; last step: median "
        f"{aux['median'][-1].item():.6g}, phi_norm "
        f"{aux['phi_norm'][-1].item():.6g}")
    if abs(lp[-1].item() / NN_PBLOCK_LOGP_JAX - 1) > 1e-4:
        fail(f"[main-nn-pblock] log_p_mean at step {PBLOCK_STEPS} is not "
             "within 1e-4 of the JAX package's")
    compare_with_cpu(lambda d: PblockLoop(nn_model, theta0, d), batch, 10,
                     "main-nn-pblock", 0.1)
    timed["main-nn-pblock"] = (
        PblockLoop(nn_model, theta0, dev), batch,
        PblockLoop(nn_model, theta0, dev, plain=True))

    # [large-n-sym]: SYM_ITERS iterations through B11, then each phi
    # against B3's on the same theta (1e-5 normalised: theta lies near the
    # origin, tests/test_pallas.py:117-118's bound) and against the plain
    # version, and a second call bitwise.
    theta, grads = sym_data(dev, torch)
    thetas, phis = [], []
    reset(counters)
    t0 = time.perf_counter()
    for _ in range(SYM_ITERS):
        thetas.append(theta)
        phis.append(svgd_tile.svgd_phi_sym(theta, grads, 1.0))
        theta = theta + 1e-6 * phis[-1]
    torch.cuda.synchronize()
    log(f"[large-n-sym] {SYM_ITERS} iterations of theta + 1e-6 "
        f"svgd_phi_sym(theta) (n={SYM_N}, p={SYM_P}, h2 1) in "
        f"{time.perf_counter() - t0:.2f} s (first call)")
    counts["large-n-sym"] = check_counts("large-n-sym", counters,
                                         dict(B11=SYM_ITERS))
    if not bool(theta.isfinite().all()) or not all(
            bool(p.isfinite().all()) for p in phis):
        fail("[large-n-sym] non-finite output")
    h2 = torch.ones((), device=dev)
    e3 = ep = 0.0
    same = True
    for th, phi in zip(thetas, phis):
        e3 = max(e3, norm_err(phi, svgd_tile.svgd_phi(th, grads, h2)))
        ep = max(ep, norm_err(phi, svgd_tile.svgd_phi_sym_plain(th, grads,
                                                                h2)))
        same = same and torch.equal(phi, svgd_tile.svgd_phi_sym(th, grads,
                                                                1.0))
    log(f"[large-n-sym] every phi: normalised error vs B3 {e3:.3e}, vs the "
        f"plain version {ep:.3e} (bound 1e-05), second call bitwise {same}")
    if e3 > 1e-5 or ep > 1e-5 or not same:
        fail("[large-n-sym] phi disagrees with B3, its plain version or "
             "itself")
    del thetas, phis
    theta0, grads = sym_data(dev, torch)
    timed["large-n-sym"] = {
        name: SymLoop(theta0, grads, h2, fn) for name, fn in (
            ("B11", svgd_tile.svgd_phi_sym), ("B3", svgd_tile.svgd_phi),
            ("plain", svgd_tile.svgd_phi_sym_plain))}
    return counts, timed


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
    from stein_tpu_torch.ops import (
        fused_median,
        fused_step,
        model_grad,
        svgd_tile,
    )
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
    if "--split" in sys.argv[1:]:
        redesign_split(dev, torch, gpu)
        pass_split(dev, torch, gpu)
        sym_split(dev, torch, gpu)
        return 0

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
    # The kernel's limit of 8 brackets: 16 counts in the first sweep, then
    # 15 (two rounds) a sweep; 30 cold passes are 15 rounds, the last alone.
    b2_case("main path, 8 brackets", D_sub, fused_median, zero,
            tuple((1.0 - 0.1 * (i + 1), 1.0 + 0.15 * (i + 1))
                  for i in range(8)))
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

    # The glm and logistic stages, B10, B6 and B1's model and D-given chains.
    Xl, yl, theta_l0 = logreg_data()
    lg_batch = {"X": torch.tensor(Xl, dtype=f32, device=dev),
                "y": torch.tensor(yl, dtype=f32, device=dev)}
    lg_theta = torch.tensor(theta_l0, dtype=f32, device=dev)
    tail_errs, tail_in = check_tail_kernels(dev, torch, theta, g0, batch,
                                            lg_theta, lg_batch)
    bracket_errs, bracket_in = check_bracket_kernels(dev, torch, theta,
                                                     nn_theta)
    entry_errs, entry_in = check_sym_pblock_kernels(dev, torch, nn_model,
                                                    nn_batch, nn_theta)

    # ------------------------------------------------------ 4. main path
    counters = {"B1": fused_step.fused_warm_step_tail,
                "B2": fused_median.fused_warm_median_rows,
                "B3": svgd_tile.svgd_both_ksum,
                "B3-bf16": (svgd_tile.svgd_both_ksum, "bf16_launches"),
                "B4": fused_median.dist_block,
                "B5": fused_median.fused_warm_median_from_theta,
                "B6": fused_step.fused_epilogue,
                "B7": bayesian_nn.nn_grads,
                "B10": svgd_tile.svgd_both_ksum_on_D,
                "B8": fused_median.fused_bracket_pass,
                "B9": fused_median.fused_bracket_grid_pass,
                "B11": svgd_tile.svgd_phi_sym,
                "B12": fused_step.fused_warm_step_pblock,
                "glm": model_grad.glm_grads,
                "logistic": model_grad.logistic_grads}
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

    (path_counts, nn_sampler, nn_batch, big, lr_batch, nn16,
     nn_large) = run_nn_paths(
        dev, torch, nn_model, counters)
    path_counts["main"] = launches

    def main_make(device, **over):
        """[main]'s sampler from theta0; ``over`` replaces
        throughput_config's options."""
        return SVGDSampler(N, model.log_p, model.template(), Adam(1e-1),
                           theta=theta0, device=device, **(over or kw))

    cov_counts, cov_loop = run_covertype(dev, torch, counters, gpu)
    path_counts["covertype-e2e"] = cov_counts
    path_counts.update(run_slice_phases(dev, torch, counters, gpu,
                                        main_make, sampler, batch, big,
                                        lr_batch))
    tail_counts, tail_timed = run_tail_paths(dev, torch, counters, X, y,
                                             theta0, batch)
    path_counts.update(tail_counts)
    entry_counts, entry_timed = run_entry_paths(dev, torch, nn_model,
                                                counters)
    path_counts.update(entry_counts)
    mesh_counts, mesh_timed, mesh = run_mesh_paths(
        dev, torch, counters, X, y, theta0, batch, nn_model)
    path_counts.update(mesh_counts)

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

    plain_run = plain_tail_runner(sampler, batch, MEDIAN_ROWS, kw,
                                  lambda th, b: {"grads": grad_all(th, b)[1]})
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
    nn16_us = run_timed(lambda k: nn16.run(nn_batch, k), torch, 200)
    log(f"[timing] {gpu}: NN path (n={NN_N}, p={NN_P}) run() "
        f"{nn_step_us:.2f} us/step with the kernels, {nn_plain_us:.2f} "
        f"us/step with the plain functions; large-n (n={LARGE_N}, p={P}) "
        f"run() {large_us:.2f} us/step with the kernels; NN path with "
        f"pallas_precision='bf16' {nn16_us:.2f} us/step")
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

    def tile_plain(theta, g, h2, precision="f32"):
        c = svgd_tile.column_center(theta)
        ku, ks = svgd_tile.svgd_both_ksum_plain(theta, theta, g, h2, c,
                                                precision)
        return (ku + ks * (theta - c) / h2) / theta.shape[0]

    # B3 at the NN shape and at n=10240, p=128, in both precisions: the
    # kernel against the plain version of the same precision in turns (CUDA
    # events, the wrapper's host work included), then the device time of
    # the kernel's three launches (prep, tile, reduce; the centre given).
    theta_n = big.state.particles
    g_n = torch.randn_like(theta_n)
    h2_n = fused_median.warm_search_on_value(
        row_subsample_block(theta_n, 128), zero, 30) / np.log(LARGE_N)
    b3_t = {}
    for shape, (th_, g_, h2_, reps) in (
            ("nn", (nn_theta, g_nn, h2, 50)),
            ("large", (theta_n, g_n, h2_n, 10))):
        c_ = svgd_tile.column_center(th_)
        for prec in ("f32", "bf16"):
            ms, plain_ms = in_turns(
                lambda: tile_plain(th_, g_, h2_, prec),
                lambda: svgd_tile.svgd_phi(th_, g_, h2_, precision=prec),
                reps, torch)
            dev_us = device_us(lambda: svgd_tile.svgd_phi(
                th_, g_, h2_, center=c_, precision=prec), reps, torch)
            b3_t[shape, prec] = (ms, plain_ms, dev_us)
    b3_ms, b3_plain, _ = b3_t["nn", "f32"]
    b3n_ms, b3n_plain, _ = b3_t["large", "f32"]
    log(f"[timing] {gpu}: B3 by precision (us by events vs plain of the "
        "same precision; device us): " + "; ".join(
            f"{'n=%d p=%d' % ((NN_N, NN_P) if k[0] == 'nn' else (LARGE_N, P))}"
            f" {k[1]} {v[0] * 1e3:.2f} vs {v[1] * 1e3:.2f} (device "
            f"{v[2] if v[2] is None else round(v[2], 2)})"
            for k, v in b3_t.items()))
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

    # This slice's paths (plain, kernel, kernel, plain) and kernels.
    path_us = {}
    for label, (s_, b_, plain) in tail_timed.items():
        reps = 20 if label == "large-n-epilogue" else 200
        p1 = run_timed(plain, torch, reps)
        k1 = run_timed(lambda k: s_.run(b_, k), torch, reps)
        k2 = run_timed(lambda k: s_.run(b_, k), torch, reps)
        p2 = run_timed(plain, torch, reps)
        path_us[label] = ((k1 + k2) / 2, (p1 + p2) / 2)
        log(f"[timing] {gpu}: {label} run() {path_us[label][0]:.2f} us/step "
            f"with the kernels, {path_us[label][1]:.2f} us/step with the "
            "plain functions")
    th_g, A_g, b_g = tail_in["glm"]
    glm_ms, glm_plain = in_turns(
        lambda: model_grad.glm_grads_plain(th_g, A_g, b_g),
        lambda: model_grad.glm_grads(th_g, A_g, b_g), 50, torch)
    glm_lib = cuda_ms(lambda: torch.addmm(b_g, th_g, A_g, alpha=-1), 50,
                      torch)
    # The glm stage's row holds device times (device_us): the events above
    # are mostly the host's dispatch at this size.
    glm_dev = {name: device_us(fn, 50, torch) for name, fn in (
        ("kernel", lambda: model_grad.glm_grads(th_g, A_g, b_g)),
        ("plain", lambda: model_grad.glm_grads_plain(th_g, A_g, b_g)),
        ("addmm", lambda: torch.addmm(b_g, th_g, A_g, alpha=-1)))}
    log(f"[timing] {gpu}: glm stage (n={N}, p={P}) device us: kernel "
        f"{glm_dev['kernel']}, plain {glm_dev['plain']}, torch.addmm "
        f"{glm_dev['addmm']}")
    glm_by = "events"
    if None not in glm_dev.values():
        glm_ms, glm_plain, glm_lib = (glm_dev["kernel"] / 1e3,
                                      glm_dev["plain"] / 1e3,
                                      glm_dev["addmm"] / 1e3)
        glm_by = "device"
    lfn, l_args = tail_in["logistic_fn"], tail_in["logistic"]
    logi_ms, logi_plain = in_turns(lambda: lfn.plain(*l_args),
                                   lambda: lfn(*l_args), 50, torch)
    D10, u10, h2_10 = tail_in["B10"]
    b10_ms, b10_plain = in_turns(
        lambda: svgd_tile.svgd_both_ksum_on_D_plain(D10, u10, h2_10),
        lambda: svgd_tile.svgd_both_ksum_on_D(D10, u10, h2_10), 50, torch)
    e_args = tail_in["B6"]
    b6_ms, b6_plain = in_turns(
        lambda: fused_step.fused_epilogue_plain(*e_args),
        lambda: fused_step.fused_epilogue(*e_args), 50, torch)
    b2_lib = cuda_ms(lambda: torch.kthvalue(D_sub.reshape(-1),
                                            (D_sub.numel() + 1) // 2), 50,
                     torch)
    log(f"[timing] {gpu}: glm stage (n={N}, p={P}) {glm_ms * 1e3:.2f} us vs "
        f"plain {glm_plain * 1e3:.2f} us, torch.addmm {glm_lib * 1e3:.2f} "
        f"us; logistic stage (n={LOGREG_N}, p={LOGREG_D + 1}, "
        f"N={LOGREG_OBS}) {logi_ms * 1e3:.2f} us vs plain "
        f"{logi_plain * 1e3:.2f} us; B10 ([{N}, {N}] x [{N}, {P}]) "
        f"{b10_ms * 1e3:.2f} us vs plain {b10_plain * 1e3:.2f} us; B6 "
        f"([{LARGE_N}, {P}], Adam) {b6_ms * 1e3:.2f} us vs plain "
        f"{b6_plain * 1e3:.2f} us; B2's torch.kthvalue {b2_lib * 1e3:.2f} us")
    for label, chain in tail_in["chains"].items():
        th_c, g_c, m_c, D_c, Ds_c, sub_c, med_c = chain
        gd_c, st_c = opt_state(th_c.shape[0], th_c.shape[1], "adam", 1e-4,
                               dev, torch)
        k_ms, p_ms = in_turns(
            lambda: fused_step._plain_tail(
                th_c, g_c, sub_c, med_c, st_c, gd_c, 10.0, 8,
                fused_step.DEFAULT_BRACKETS, D=D_c, D_sub=Ds_c, model=m_c),
            lambda: fused_step.fused_warm_step_tail(
                th_c, g_c, D_c, Ds_c, med_c, st_c, gd_c,
                gram_in_kernel=D_c is None, theta_sub=sub_c, model=m_c),
            50, torch)
        log(f"[timing] {gpu}: B1 chain, {label}: {k_ms * 1e3:.2f} us vs "
            f"plain {p_ms * 1e3:.2f} us")

    # [main-nn-pblock] and [large-n-sym] (plain, kernel, kernel, plain;
    # [large-n-sym] also B3's loop), then B11 and B12 against their plain
    # versions.
    pb_loop, pb_batch, pb_plain = entry_timed["main-nn-pblock"]
    p1 = run_timed(lambda k: pb_plain.run(pb_batch, k), torch, 200)
    k1 = run_timed(lambda k: pb_loop.run(pb_batch, k), torch, 200)
    k2 = run_timed(lambda k: pb_loop.run(pb_batch, k), torch, 200)
    p2 = run_timed(lambda k: pb_plain.run(pb_batch, k), torch, 200)
    path_us["main-nn-pblock"] = ((k1 + k2) / 2, (p1 + p2) / 2)
    log(f"[timing] {gpu}: main-nn-pblock (n={NN_N}, p={NN_P}) "
        f"{path_us['main-nn-pblock'][0]:.2f} us/step with the kernels, "
        f"{path_us['main-nn-pblock'][1]:.2f} us/step with the plain "
        "functions")
    sym_loops = entry_timed["large-n-sym"]
    sym_us = {}
    for name in ("plain", "B11", "B3", "B3", "B11", "plain"):
        t = run_timed(lambda k: sym_loops[name].run(None, k), torch, 10)
        sym_us.setdefault(name, []).append(t)
    sym_us = {k: sum(v) / len(v) for k, v in sym_us.items()}
    path_us["large-n-sym"] = (sym_us["B11"], sym_us["plain"])
    log(f"[timing] {gpu}: large-n-sym (n={SYM_N}, p={SYM_P}) "
        f"{sym_us['B11']:.2f} us/iteration with B11, {sym_us['B3']:.2f} with "
        f"B3, {sym_us['plain']:.2f} with the plain version")
    th_s, g_s, h2_s = entry_in["B11"]
    h2_st = torch.full((), h2_s, device=dev)
    b11_ms, b11_plain = in_turns(
        lambda: svgd_tile.svgd_phi_sym_plain(th_s, g_s, h2_st),
        lambda: svgd_tile.svgd_phi_sym(th_s, g_s, h2_s), 10, torch)
    # B11 on a grid of one block: one SM takes every unit in ticket order
    # and never waits on a slot; over the SM count, the full grid's time
    # without its slot waits and its tail.
    grid, svgd_tile.SYM_BLOCKS = svgd_tile.SYM_BLOCKS, 1
    try:
        one_us = device_us(lambda: svgd_tile.svgd_phi_sym(th_s, g_s, h2_s), 2,
                           torch)
    finally:
        svgd_tile.SYM_BLOCKS = grid
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"[timing] {gpu}: B11 (n={SYM_N}, p={SYM_P}) on one block: "
        f"{one_us} us device, / {sms} SMs = "
        f"{None if one_us is None else one_us / sms} us")
    b12_args = entry_in["B12"]
    b12_ms, b12_plain = in_turns(
        lambda: fused_step._plain_tail(
            b12_args[0], b12_args[1], None, b12_args[2], b12_args[3],
            b12_args[4], 10.0, 8, fused_step.DEFAULT_BRACKETS),
        lambda: fused_step.fused_warm_step_pblock(*b12_args), 50, torch)
    log(f"[timing] {gpu}: B11 (n={SYM_N}, p={SYM_P}) {b11_ms * 1e3:.2f} us "
        f"vs plain {b11_plain * 1e3:.2f} us; B12 (n={NN_N}, p={NN_P}, Adam) "
        f"{b12_ms * 1e3:.2f} us vs plain {b12_plain * 1e3:.2f} us")

    # The kernels this slice redesigned by device time (device_us),
    # kernel and plain, which their rows hold (their events above include
    # the wrapper's host work, ~30-250 us): the median kernel's split, then
    # each row's call.
    split = redesign_split(dev, torch, gpu)
    gd_t, st_t = tail_inputs(theta, "adam", 1e-4)
    sub_t = subsample_rows(theta, MEDIAN_ROWS)
    dev_t = {key: (device_us(kern, 20, torch), device_us(plain, 20, torch))
             for key, kern, plain in (
        ("B1", lambda: fused_step.fused_warm_step_tail(
            theta, g0, None, None, cold_p, st_t, gd_t, gram_in_kernel=True,
            theta_sub=sub_t),
         lambda: fused_step._plain_tail(theta, g0, sub_t, cold_p, st_t, gd_t,
                                        10.0, 8, fused_step.DEFAULT_BRACKETS)),
        ("B2", lambda: fused_median.fused_warm_median_rows(D_sub, zero, 30),
         lambda: fused_median.warm_search_on_value(D_sub, zero, 30)),
        ("B5", lambda: fused_median.fused_warm_median_from_theta(
            rows_nn, nn_theta, med_nn * 1.01, c_nn, 8),
         lambda: fused_median.warm_search_on_value(
            fused_median.dist_block_plain(rows_nn, nn_theta, c_nn),
            med_nn * 1.01, 8)),
        ("B10", lambda: svgd_tile.svgd_both_ksum_on_D(D10, u10, h2_10),
         lambda: svgd_tile.svgd_both_ksum_on_D_plain(D10, u10, h2_10)),
        ("B12", lambda: fused_step.fused_warm_step_pblock(*b12_args),
         lambda: fused_step._plain_tail(
             b12_args[0], b12_args[1], None, b12_args[2], b12_args[3],
             b12_args[4], 10.0, 8, fused_step.DEFAULT_BRACKETS)),
        # The rows timed by events above, the same calls.
        ("B3", lambda: svgd_tile.svgd_phi(nn_theta, g_nn, h2),
         lambda: tile_plain(nn_theta, g_nn, h2)),
        ("B3-bf16", lambda: svgd_tile.svgd_phi(nn_theta, g_nn, h2,
                                               precision="bf16"),
         lambda: tile_plain(nn_theta, g_nn, h2, "bf16")),
        ("B6", lambda: fused_step.fused_epilogue(*e_args),
         lambda: fused_step.fused_epilogue_plain(*e_args)),
        ("B11", lambda: svgd_tile.svgd_phi_sym(th_s, g_s, h2_s),
         lambda: svgd_tile.svgd_phi_sym_plain(th_s, g_s, h2_st)))}
    log(f"[timing] {gpu}: device us, kernel vs plain: " + "; ".join(
        f"{k} {v[0]} vs {v[1]}" for k, v in dev_t.items()))
    gram_lib = split["B5"][2]

    # The mesh paths (plain, kernel, kernel, plain), B8 and B9.
    for label, (s_, b_) in mesh_timed.items():
        def plain(k, s_=s_, b_=b_):
            with plain_kernels():
                s_.run(b_, k)
        p1 = run_timed(plain, torch, 200)
        k1 = run_timed(lambda k: s_.run(b_, k), torch, 200)
        k2 = run_timed(lambda k: s_.run(b_, k), torch, 200)
        p2 = run_timed(plain, torch, 200)
        path_us[label] = ((k1 + k2) / 2, (p1 + p2) / 2)
        log(f"[timing] {gpu}: {label} run() {path_us[label][0]:.2f} us/step "
            f"with the kernels, {path_us[label][1]:.2f} us/step with the "
            "plain functions")
    b8_ms, b8_plain = in_turns(
        lambda: fused_median.fused_bracket_pass_plain(*bracket_in["B8"]),
        lambda: fused_median.fused_bracket_pass(*bracket_in["B8"]), 50, torch)
    b9_ms, b9_plain = in_turns(
        lambda: fused_median.fused_bracket_grid_pass_plain(
            *bracket_in["B9"], g1=8),
        lambda: fused_median.fused_bracket_grid_pass(*bracket_in["B9"], g1=8),
        50, torch)
    # One-process NCCL collectives: wall µs per call on the host clock
    # (the step's host cost), the device's share is in [profile].
    from stein_tpu_torch.parallel import collectives as coll
    cnt = torch.zeros(3, dtype=torch.int32, device=dev)
    coll_us = {}
    for name, fn in (("psum [3] int32", lambda: coll.psum(cnt, mesh)),
                     (f"all_gather [{N}, {P}]",
                      lambda: coll.all_gather(theta, mesh))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        coll_us[name] = (time.perf_counter() - t0) / 200 * 1e6
    log(f"[timing] {gpu}: one-process NCCL, wall per call: " + "; ".join(
        f"{k} {v:.2f} us" for k, v in coll_us.items()))
    log(f"[timing] {gpu}: B8 ([{MEDIAN_ROWS}, {N}], p={P}) {b8_ms * 1e3:.2f} "
        f"us vs plain {b8_plain * 1e3:.2f} us; B9 (g1=8) {b9_ms * 1e3:.2f} us "
        f"vs plain {b9_plain * 1e3:.2f} us")
    # B4, the logistic stage, B7, B8 and B9 by device time at the paths'
    # shapes ([split]).
    pass_us = pass_split(dev, torch, gpu)
    b4_lib = pass_us["B4 addmm"][0]
    for key, label in (("B4", f"B4 [128, {NN_LARGE}] p={NN_P} NN particles"),
                       ("logistic", f"logistic n={LOGREG_N} p={LOGREG_D + 1} "
                                    f"N={LOGREG_OBS}"),
                       ("B7", f"B7 n={NN_N}"),
                       ("B8", f"B8 [{MEDIAN_ROWS}, {N}] p={P}"),
                       ("B9", f"B9 [{MEDIAN_ROWS}, {N}] p={P} g1=8")):
        dev_t[key] = pass_us[label]

    # Each row's ms and plain_ms, and what measured them (ms_by): device
    # time where device_us could read both, else events.
    row_ms = {"B1": (b1_ms, b1_plain), "B2": (b2_ms, b2_plain),
              "B3": (b3_ms, b3_plain), "B3-bf16": b3_t["nn", "bf16"][:2],
              "B4": (b4_ms, b4_plain), "B5": (b5_ms, b5_plain),
              "B6": (b6_ms, b6_plain), "B7": (b7_ms, b7_plain),
              "B8": (b8_ms, b8_plain), "B9": (b9_ms, b9_plain),
              "B10": (b10_ms, b10_plain), "B11": (b11_ms, b11_plain),
              "B12": (b12_ms, b12_plain),
              "logistic": (logi_ms, logi_plain)}
    row_ms = {k: (*v, "events") for k, v in row_ms.items()}
    for key, (k_us, p_us) in dev_t.items():
        if k_us is not None and p_us is not None:
            row_ms[key] = (k_us / 1e3, p_us / 1e3, "device")

    profile_split("main (fused_gram)", sampler, batch, 20, torch, gpu)
    profile_split("main-nn", nn_sampler, nn_batch, 20, torch, gpu)
    profile_split("main-nn-bf16", nn16, nn_batch, 20, torch, gpu)
    profile_split("main-nn-large", nn_large, nn_batch, 10, torch, gpu)
    profile_split("large-n", big, lr_batch, 10, torch, gpu)
    for label, (s_, b_) in mesh_timed.items():
        profile_split(label, s_, b_, 20, torch, gpu)
    for label, (s_, b_, _) in tail_timed.items():
        profile_split(label, s_, b_, 10 if label == "large-n-epilogue" else 20,
                      torch, gpu)
    profile_split("main-nn-pblock", pb_loop, pb_batch, 20, torch, gpu)
    profile_split("covertype-e2e", cov_loop, None, 20, torch, gpu)
    profile_split("large-n-sym", sym_loops["B11"], None, 10, torch, gpu)

    total = {k: sum(c[k] for c in path_counts.values()) for k in counters}

    def row(name, key, source, replaces, err, ms, plain_ms, nbytes, ops,
            library_ms=None, tf32_ops=0, bf16_ops=0, ms_by="events"):
        bound_ms, bound_by = bound(nbytes, ops, tf32_ops, bf16_ops)
        return {"name": f"{name} ({key})", "route": "cuda",
                "source": f"stein_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": total[key],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "ms_by": ms_by, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms}

    # Bytes: each input read once, each output written once (f32); ops:
    # the products (2 per multiply-add), exponentials and search compares
    # that this run's shapes need. m = median rows; the search needs, per
    # entry, 2 compares (range) + 2 per bracket (warm; a cold search has no
    # hint to bracket) + 3 per quad-ary round, the same whether the kernel
    # counts two rounds a sweep or one (the fold's 12 extra counts a sweep
    # are its own choice). The median kernel's Gram, B10's contraction and
    # the tile's two products run 3xTF32 on the tensor cores: three TF32
    # products each.
    n, p, m = N, P, MEDIAN_ROWS
    sweeps_warm, sweeps_cold = 2 + 6 + 3 * 4, 2 + 3 * 15
    nn_n, nn_p, r5 = NN_N, NN_P, 128
    kernels = [
        row("fused_step_tail", "B1", "stein_kernels.cu",
            "stein_tpu/ops/pallas_step.py:92", b1_err, *row_ms["B1"][:2],
            4 * (7 * n * p + m * p), n * n + sweeps_warm * m * n,
            tf32_ops=3 * (2 * m * n * p + 4 * n * n * p),
            ms_by=row_ms["B1"][2]),
        row("warm_median", "B2", "warm_search.cuh",
            "stein_tpu/ops/pallas_median.py:85", b2_err, *row_ms["B2"][:2],
            4 * m * n, sweeps_cold * m * n, b2_lib, ms_by=row_ms["B2"][2]),
        # B3: 4 n^2 p FLOP on the tensor cores, three TF32 products each
        # (3xTF32) or one bf16, and n^2 exponentials; bytes: the timed
        # svgd_phi(theta, g) reads theta (rows and columns alike) and g once
        # and writes phi.
        row("svgd_tile", "B3", "svgd_tile.cu",
            "stein_tpu/ops/pallas_svgd.py:35", errs["B3"], *row_ms["B3"][:2],
            4 * (3 * nn_n * nn_p + nn_p), nn_n ** 2,
            tf32_ops=3 * 4 * nn_n * nn_n * nn_p, ms_by=row_ms["B3"][2]),
        row("svgd_tile, pallas_precision='bf16'", "B3-bf16", "svgd_tile.cu",
            "stein_tpu/ops/pallas_svgd.py:35", errs["B3-bf16"],
            *row_ms["B3-bf16"][:2], 4 * (3 * nn_n * nn_p + nn_p), nn_n ** 2,
            bf16_ops=4 * nn_n * nn_n * nn_p, ms_by=row_ms["B3-bf16"][2]),
        # B4: the [m, n] Gram on the tensor cores (3xTF32), the centred
        # rows and columns and their norms on the CUDA cores; bytes: rows,
        # columns and centre in, D out. Its yardstick: the Gram's one
        # torch.addmm, as B5's.
        row("dist_block", "B4", "dist_block.cu",
            "stein_tpu/ops/pallas_median.py:271", errs["B4"],
            *row_ms["B4"][:2],
            4 * (r5 * nn_p + NN_LARGE * nn_p + nn_p + r5 * NN_LARGE),
            3 * (r5 + NN_LARGE) * nn_p,
            None if b4_lib is None else b4_lib / 1e3,
            tf32_ops=3 * 2 * r5 * NN_LARGE * nn_p, ms_by=row_ms["B4"][2]),
        # B5's yardstick: the Gram stage's one torch.addmm (the centred
        # operands into the norm sum); no library call does the search.
        row("warm_median_from_theta", "B5", "stein_kernels.cu",
            "stein_tpu/ops/pallas_median.py:317", errs["B5"],
            *row_ms["B5"][:2],
            4 * (r5 * nn_p + nn_n * nn_p + nn_p), sweeps_warm * r5 * nn_n,
            None if gram_lib is None else gram_lib / 1e3,
            tf32_ops=3 * 2 * r5 * nn_n * nn_p, ms_by=row_ms["B5"][2]),
        row("epilogue", "B6", "stein_kernels.cu",
            "stein_tpu/ops/pallas_step.py:241", tail_errs["B6"],
            *row_ms["B6"][:2], 4 * (7 * LARGE_N * P + LARGE_N + P),
            25 * LARGE_N * P, ms_by=row_ms["B6"][2]),
        row("nn_grad", "B7", "nn_grad.cu",
            "stein_tpu/models/bayesian_nn.py:171", errs["B7"],
            *row_ms["B7"][:2], 4 * (2 * nn_n * nn_p + nn_n + 40),
            20 * 100 * nn_n * 14, ms_by=row_ms["B7"][2]),
        row("svgd_on_d", "B10", "svgd_on_d.cu",
            "stein_tpu/ops/pallas_svgd.py:217", tail_errs["B10"],
            *row_ms["B10"][:2], 4 * (n * n + 2 * n * p + n), 3 * n * n,
            tf32_ops=3 * 2 * n * n * p, ms_by=row_ms["B10"][2]),
        row("glm_grad, B1's model stage", "glm", "model_grad.cu",
            "stein_tpu/ops/pallas_step.py:78", tail_errs["glm"], glm_ms,
            glm_plain, 4 * (2 * n * p + p * p + p + n),
            2 * n * p * p + 4 * n * p, glm_lib, ms_by=glm_by),
        row("logistic_grad, B1's model stage", "logistic", "model_grad.cu",
            "stein_tpu/models/logistic_regression.py:120",
            tail_errs["logistic"], *row_ms["logistic"][:2],
            4 * (2 * LOGREG_N * (LOGREG_D + 1) + LOGREG_OBS * (LOGREG_D + 3)
                 + 2 * (LOGREG_D + 1) + LOGREG_N),
            4 * LOGREG_N * LOGREG_OBS * (LOGREG_D + 1)
            + 10 * LOGREG_N * LOGREG_OBS, ms_by=row_ms["logistic"][2]),
        # B8/B9: the [m, n] Gram (2 m n p) on the tensor cores, three TF32
        # products each (3xTF32); on the CUDA cores the centred rows and
        # columns and their norms (3 (m + n) p), one compare per entry and
        # threshold (6 endpoints, or the 36 grid edges at g1=8) plus the
        # range's 2; bytes: rows, columns, centre and the scalars in, D
        # and the counts out.
        row("bracket_pass", "B8", "bracket_pass.cu",
            "stein_tpu/ops/pallas_median.py:91", bracket_errs["B8"],
            *row_ms["B8"][:2], 4 * (m * p + n * p + p + 1 + m * n + 2 + 6),
            3 * (m + n) * p + 8 * m * n, tf32_ops=3 * 2 * m * n * p,
            ms_by=row_ms["B8"][2]),
        row("bracket_grid_pass", "B9", "bracket_pass.cu",
            "stein_tpu/ops/pallas_median.py:198", bracket_errs["B9"],
            *row_ms["B9"][:2], 4 * (m * p + n * p + p + 2 + m * n + 36),
            3 * (m + n) * p + 36 * m * n, tf32_ops=3 * 2 * m * n * p,
            ms_by=row_ms["B9"][2]),
        # B11: the fewest operations of this phi, which equals (K @ (g -
        # theta / h^2) + ksum theta / h^2) / n, a contraction p wide (B3's
        # rule): the upper tiles' n^2 / 2 pairs take p multiply-adds for D
        # and p for each side of K @ u, on the tensor cores as three TF32
        # products each (3xTF32), plus one exponential each; bytes: theta
        # and grads in, phi out.
        row("svgd_phi_sym", "B11", "svgd_sym.cu",
            "stein_tpu/ops/pallas_svgd.py:289", entry_errs["B11"],
            *row_ms["B11"][:2], 4 * 3 * SYM_N * SYM_P, SYM_N * SYM_N // 2,
            tf32_ops=3 * 3 * SYM_N * SYM_N * SYM_P, ms_by=row_ms["B11"][2]),
        # B12: the full [n, n] Gram (2 n^2 p) and K @ u (2 n^2 p) on the
        # tensor cores, the exponentials and the warm search's compares
        # over all n^2 entries; bytes: theta, grads and Adam's two moments
        # in, theta and the moments out.
        row("fused_warm_step_pblock", "B12", "stein_kernels.cu",
            "stein_tpu/ops/pallas_step.py:619", entry_errs["B12"],
            *row_ms["B12"][:2], 4 * 7 * nn_n * nn_p,
            nn_n ** 2 + sweeps_warm * nn_n ** 2,
            tf32_ops=3 * 4 * nn_n * nn_n * nn_p, ms_by=row_ms["B12"][2]),
    ]
    log(f"[result] launches by path {path_counts}")
    log(f"[result] nn_step_us={nn_step_us!r} nn_plain_step_us="
        f"{nn_plain_us!r} large_n_step_us={large_us!r} nn_bf16_step_us="
        f"{nn16_us!r}")
    log(f"[result] step_ms={step_ms!r} plain_step_ms={plain_step_ms!r}")
    log(f"[result] tail paths (us/step, kernels vs plain) {path_us!r}; "
        f"B1 chains max abs error {tail_errs['B1 chains']!r}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run():
    """main(), then the process group's end, so that the exit code is the
    script's own."""
    try:
        return main()
    finally:
        if "torch" in sys.modules:
            import torch.distributed as dist
            if dist.is_available() and dist.is_initialized():
                dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(run())
