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
              against theirs; B3's two routes (mma.sync, wgmma) at the
              benchmark cells' shapes and three more, each against its
              plain version, device µs beside the 3xTF32 bound and the
              route tile_route picks (the "B3 route" lines); the glm and logistic stages, B10, B6, and
              B1's model and D-given chains against theirs; B8/B9 (with
              the thresholds they form against grid_edges); B11 at
              four shapes, ten calls bitwise equal and so on grids of one
              and seven blocks; B12 on lattice and path inputs; the bin
              count (csrc/bin_count.cu, fed by the Gram) bitwise against
              its plain version at the binned paths' blocks, two levels,
              one and two windows, 4096/2048/1 bins (and past the shared
              memory), a lattice with NaN, infinities and an overflowing
              2 g, f32, bf16 and f64; the linear models' data products
              (csrc/data_product.cu, both entry points, f32 and bf16 on
              the tensor cores) at the paths' row counts and the
              transpose's split edges against torch.matmul, and
              row-invariant: blocks of rows at every offset bitwise the
              full launch's; HMMA instructions in their SASS; at the
              stated tolerances
  4. main     the bench's p=128 Bayesian linear regression at n=1000
              (B1, B2; the data products of its torch.func gradients):
              launch counts of run(batch, 500), finiteness, the
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
              B8, B3) and mesh-nn (the NN with custom_grads: B7, B8, B3);
              mesh-binned and mesh-ring-binned (median='binned' with the
              tile, gathered and around the ring: B3, the bin count);
              mesh2d,
              mesh2d-grid and mesh2d-nn on a 1x1 2-D mesh through
              throughput_config(model_axis=) (B10 every step): counts, 10
              steps against the CPU gloo run, [mesh2d]'s log_p_mean and
              posterior against the JAX package's; B10 on the 2-D step's
              own D rows and u
     median-binned, median-subsample  SVGDSampler(median='binned' |
              'subsample', kernel_impl='pallas') at large_particle.py's
              default size (n=10240, p=64; B3, and the bin count 80 a
              binned step): counts, 4 steps against the plain functions on
              the card, the binned median bitwise the plain count's and
              the per-window sweep's (each middle rank refined on its own,
              the plain count), against the exact median of the full D and
              the CPU's, the subsample median against a full sort of its
              block, us/step
     meshL    bench_torch.py's large-n mesh rows (n=8192, p=64, fused_shard,
              1024-wide tiles, 64 median rows) on the one-process NCCL
              mesh, 'rounds' (B8, B3) and meshL-grid ('grid': B9, B3):
              counts, finiteness, 4 steps against the plain functions on
              the card
     examples every CLI of examples_torch/ on the card at its default
              sizes (regression_neural_network with --prior-beta 10,
              large_particle also with --median binned, production_run
              again from its checkpoint): the
              printed acceptance numbers and each CLI's kernel launches
     fidelity tests/test_torch_fidelity.py's card cases in a subprocess
              (the f32 step against the f64 oracle at the JAX suite's
              bounds): every case passed, none skipped
     bench    bench_torch.py in a subprocess: its JSON line holds every
              key of bench.py's line, each value positive
  5. timing   per-step time of run() (and of the B12 and B11 loops) with
              the kernels and with the plain functions on the card, and
              each kernel against its plain version and its library call
              (CUDA events; plain, kernel, kernel, plain); a torch.profiler
              split of each fused path, of both loops and of the mesh
              paths (with the collectives' share)
  6. graph    every sampler path's steps replayed from CUDA graphs
              (utils/graphs.py; every entry point above replays them)
              against the eager loop (SVGDSampler._eager) from the same
              state: bitwise, with the same launch counts; wall us/step of
              both in turns, and under the profiler device us/step, busy
              share and kernel launches a step of both; the main path's
              first call and step at chunk lengths 16, 32 and 64; for the
              three binned paths a chunk's graph's node count, capture and
              instantiation seconds. The plain functions of [timing] and
              [meshL] run through the eager loop. Before [bench],
              [graph-tests] runs tests/test_torch_cuda.py's graph cases in
              a subprocess (every single-card path and one-process mesh
              path, the binned ones included, each entry point, graph
              against eager, bitwise): all 27 must pass. [teardown]: in a
              subprocess (60 s limit) a one-process NCCL mesh captures a
              run, then frees its graphs (graphs.release) and destroys the
              group; in another it exits with neither (the graphs freed
              from atexit): both exit 0. [recovery]: [main]'s
              configuration through train_with_recovery (256 steps, a
              checkpoint every 64) in three subprocesses (120 s limit
              each): one exits 17 at the first checkpoint, the relaunch
              resumes from it (executed 192, graphs replayed), and its
              state and aux are bitwise those of an uninterrupted run;
              the walls of the first step's parts (the library's load,
              the first cuBLAS call, the first and second torch.func
              gradient), the restore and the first capture after it.
              [statistical]: tests/test_torch_statistical.py's card cases
              in a subprocess (tests/test_statistical.py's analytic
              targets, f64 and bf16, through run's graphs): all 5 must
              pass.

With --data-product it stops after the build and prints only the data
products' [kernels] lines (the checks and the SASS route) and their
[timing] lines (device µs in turns with torch.matmul at [main]'s,
[large-n]'s and a 4-card shard's shapes).

With --tile it stops after the build and prints only B7 at the Year
network's shape (against its plain version, device µs beside its bound)
and the [kernels] B3 route lines: the tile's three routes (mma.sync, wgmma
and wide, with the wide route's Gram launch alone) at the benchmark cells'
shapes and more, each against its plain version, their device µs beside
the 3xTF32 bound, and the route tile_route picks.

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


def binned_sweep():
    """tests/binned_sweep.py (torch and the port only): the binned median's
    per-window reference sweep."""
    tests = os.path.join(HERE, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import binned_sweep as sweep

    return sweep


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


# [kernels] B3 route: the tile's three routes at the benchmark cells' shapes,
# [main-nn-large]'s, the two smallest paths', the mesh paths' blocks below
# [1000, 1000] (n=1000 on 4 ranks and on 2, and one between), meshL's
# ring arm and widths between the NN's and the Year network's ([m, n], p,
# B3's exponent order or B1's).
TILE_ROUTE_SHAPES = (
    ("linreg-p128.n10240", 10240, 10240, 128, True),
    ("linreg-p128.n1000, B1's order", 1000, 1000, 128, False),
    ("bnn-1x100x1.n1000", 1000, 1000, 303, True),
    ("mesh4 rank", 2048, 8192, 64, True),
    ("main-nn-large", 3000, 3000, 303, True),
    ("covertype-e2e, B1's order", 100, 100, 55, False),
    ("main-glm n=50, B1's order", 50, 50, 128, False),
    ("mesh n=1000, 4 ranks", 250, 1000, 128, True),
    ("mesh n=1000, 2 ranks", 500, 1000, 128, True),
    ("between 1", 512, 1024, 128, True),
    ("between 2", 700, 700, 128, True),
    ("between 3", 768, 1024, 128, True),
    ("between 4", 800, 800, 128, True),
    ("between 5", 900, 900, 128, True),
    ("meshL ring arm", 2048, 2048, 64, True),
    ("bnn-year-90x100x1.n2048", 2048, 2048, 9203, True),
    ("wide 1", 2048, 2048, 256, True),
    ("wide 2", 2048, 2048, 512, True),
    ("wide 3", 2048, 2048, 1024, True),
    ("wide 4", 2048, 2048, 2048, True),
    ("wide 5", 2048, 2048, 4096, True),
    ("wide 6", 1000, 1000, 640, True),
    ("wide 7", 1000, 1000, 1024, True),
    ("wide 8", 1000, 1000, 160, True),
    ("wide 9", 1000, 1000, 192, True),
    ("wide 10", 2048, 2048, 160, True),
    ("mesh-nn n=1000, 4 ranks", 250, 1000, 303, True),
    ("large-n 1", 10240, 10240, 192, True),
    ("large-n 2", 10240, 10240, 303, True),
    ("large-n 3, mesh rank", 2560, 10240, 303, True),
)


def tile_routes(dev, torch, gpu, reps=20):
    """[kernels] B3 route lines: at each of TILE_ROUTE_SHAPES, the three
    routes of the tile (ops/svgd_tile.py: mma.sync, wgmma only where p <=
    WGMMA_ROUTE_MAX_P, and wide) against the plain version (ku and ksum
    <= 1e-4 normalised for mma.sync and wide, 1e-5 for wgmma), a second
    call bitwise, device us (device_us) beside the 3xTF32 bound (three TF32
    products of 4 m n p FLOP at 495 TFLOP/s), and the route tile_route
    picks. Returns {label: (mma.sync us, wgmma us or None, wide us)}."""
    from stein_tpu_torch.ops import fused_median, svgd_tile
    from stein_tpu_torch.ops.median import row_subsample_block

    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)
    names = {svgd_tile.MMA_SYNC: "mma.sync", svgd_tile.WGMMA: "wgmma",
             svgd_tile.WIDE: "wide"}
    out = {}
    for label, m, n, p, div_h2 in TILE_ROUTE_SHAPES:
        rng = np.random.default_rng(m + p)
        cols = torch.tensor(rng.normal(size=(n, p)), dtype=f32, device=dev)
        grads = torch.tensor(rng.normal(size=(n, p)), dtype=f32, device=dev)
        rows = cols[:m].contiguous()
        c = svgd_tile.column_center(cols)
        h2 = fused_median.warm_search_on_value(
            row_subsample_block(cols, 128), zero, 30) / np.log(n)
        want = svgd_tile.svgd_both_ksum_plain(rows, cols, grads, h2, c,
                                              "f32", div_h2)
        us, errs = [], []
        for route, bound in ((svgd_tile.MMA_SYNC, 1e-4),
                             (svgd_tile.WGMMA, 1e-5),
                             (svgd_tile.WIDE, 1e-4)):
            if route == svgd_tile.WGMMA and p > svgd_tile.WGMMA_ROUTE_MAX_P:
                us.append(None)
                errs.append(None)
                continue

            def call(route=route):
                return svgd_tile._tile(rows, cols, grads, h2, c, None, "f32",
                                       div_h2, route)
            got, again = call(), call()
            torch.cuda.synchronize()
            err = max(norm_err(got[0], want[0]), norm_err(got[1], want[1]))
            if err > bound or not all(torch.equal(a, b)
                                      for a, b in zip(got, again)):
                fail(f"B3 route {names[route]} at {label} disagrees with its "
                     f"plain version ({err:.3e}, bound {bound:g}) or itself")
            errs.append(err)
            us.append(device_us(call, reps, torch))
        gram_us = device_us(
            lambda: svgd_tile._launch_phi_gram(rows, cols, c), reps, torch)
        del want
        bound_us = 3 * 4 * m * n * p / PEAK_TF32_FLOPS * 1e6
        fmt = ["not read" if t is None else f"{t:.2f}" for t in us]
        no_wg = errs[1] is None
        if no_wg:
            fmt[1] = f"not run (p > {svgd_tile.WGMMA_ROUTE_MAX_P})"
        log(f"[kernels] B3 route {label} [{m}, {n}] p={p}: device us "
            f"mma.sync {fmt[0]}, wgmma {fmt[1]}, wide {fmt[2]} (its Gram "
            + ("not read" if gram_us is None else f"{gram_us:.2f}")
            + f"; 3xTF32 bound {bound_us:.1f}); normalised errors "
            f"{errs[0]:.3e} / "
            + ("-" if no_wg else f"{errs[1]:.3e}")
            + f" / {errs[2]:.3e}, repeats bitwise; tile_route picks "
            f"{names[svgd_tile.tile_route(m, n, p)]} | {gpu}")
        out[label] = tuple(us)
    return out


def year_b7(dev, torch, gpu, reps=20):
    """[kernels] B7 year line: B7 at the Year network's shape (n = 2048,
    a 100-row batch of f = 90 features, H = 100) against its plain version
    (logp rtol 2e-5 / atol 1e-5, grads 2e-5 max|g|, the card tests'
    tolerances), a second call bitwise, and its device us beside its bound:
    3 B (2 f H + 4 H) operations a particle at the f32 rate, or theta's and
    the gradients' bytes."""
    from stein_tpu_torch.models import BayesianNNModel, bayesian_nn

    n, B, f, H = 2048, 100, 90, 100
    rng = np.random.default_rng(90)
    model = BayesianNNModel(f, H, n_train=463715, n_batch=B, prior_beta=0.1)
    p = f * H + 2 * H + 3
    theta = torch.tensor(rng.normal(size=(n, p)) * 0.1, dtype=torch.float32,
                         device=dev)
    batch = {"X": torch.tensor(rng.normal(size=(B, f)), dtype=torch.float32,
                               device=dev),
             "y": torch.tensor(rng.normal(size=(B, 1)), dtype=torch.float32,
                               device=dev)}
    grad = model.pallas_grads()
    lp, g = grad(theta, batch)
    again = grad(theta, batch)
    lp_ref, g_ref = bayesian_nn.nn_grads_plain(
        theta, batch["X"], batch["y"].reshape(-1), f, H, model._consts())
    lp_err = ((lp - lp_ref).abs() / (1e-5 + 2e-5 * lp_ref.abs())).max().item()
    g_err = norm_err(g, g_ref)
    if (lp_err > 1.0 or g_err > 2e-5 or not torch.equal(lp, again[0])
            or not torch.equal(g, again[1])):
        fail(f"B7 at the Year shape disagrees with its plain version "
             f"(logp {lp_err:.3e} of its tolerance, grads {g_err:.3e}) or "
             "itself")
    us = device_us(lambda: grad(theta, batch), reps, torch)
    t_b, by = bound(2 * n * p * 4, n * B * 3 * (2 * f * H + 4 * H))
    log(f"[kernels] B7 year [{n}, {p}], B={B}, f={f}, H={H}: device us "
        f"{'not read' if us is None else f'{us:.2f}'} (bound "
        f"{t_b * 1e3:.2f} by {by}); logp {lp_err:.3e} of its tolerance, "
        f"grads {g_err:.3e} normalised, repeats bitwise | {gpu}")


def year_median(dev, torch, gpu):
    """[kernels] B4/B2/B5 year lines: the Year cell's median block ([128,
    2048] rows of its 0.1 N(0, 1) draw against all, p = 9,203). B4 against
    the plain Gram (bitwise on lattice particles, <= 1e-5 normalised on the
    draw); B2 bitwise against its plain search on the plain block, cold and
    warm, and its cold median within one final interval of the full range
    of the median's order statistic (torch.kthvalue); B5 against the plain search on
    the plain block at check_new_kernels' bounds."""
    from stein_tpu_torch.ops import fused_median, svgd_tile
    from stein_tpu_torch.ops.median import subsample_rows

    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)
    n, p = 2048, 90 * 100 + 2 * 100 + 3
    draw = torch.tensor(np.random.default_rng(9203).normal(size=(n, p))
                        * 0.1, dtype=f32, device=dev)
    for kind, theta in (("lattice", lattice(n, p, dev, torch)),
                        ("Year draw", draw)):
        rows = subsample_rows(theta, 128)
        c = svgd_tile.column_center(theta)
        got = fused_median.dist_block(rows, theta, c)
        want = fused_median.dist_block_plain(rows, theta, c)
        torch.cuda.synchronize()
        err = norm_err(got, want)
        log(f"[kernels] B4 year [128, {n}] p={p} {kind}: normalised error "
            f"{err:.3e}, bitwise {torch.equal(got, want)} | {gpu}")
        if (kind == "lattice" and not torch.equal(got, want)) or err > 1e-5:
            fail(f"B4 at the Year shape ({kind}) disagrees with its plain "
                 "version")
        cold = b2_case(f"year {kind} (B4's block)", want, fused_median, zero)
        exact = torch.kthvalue(want.reshape(-1),
                               (want.numel() + 1) // 2).values.item()
        span = want.max().item() - min(want.min().item(), 0.0)
        cold_width = max(span / 4 ** 15,
                         2 * float(np.spacing(np.float32(exact))))
        log(f"[kernels] B2 year {kind}: cold {cold.item()!r} vs "
            f"torch.kthvalue's {exact!r} (bound {cold_width:.3e})")
        if abs(cold.item() - exact) > cold_width:
            fail(f"B2 at the Year shape ({kind}) is off the exact median "
                 "by more than one final interval")
        res = []
        for med_prev, passes in ((zero, 30), (cold * 1.01, 8)):
            k = fused_median.fused_warm_median_from_theta(
                rows, theta, med_prev, c, passes)
            p_ = fused_median.warm_search_on_value(want, med_prev, passes)
            res.append((k.item(), p_.item()))
        width = (1.09 - 0.92) * cold.item() * 1.01 / 4 ** 4
        log(f"[kernels] B5 year [128, {n}] p={p} {kind}: cold {res[0]} "
            f"(bound {cold_width:.3e}), warm {res[1]} (final interval "
            f"{width:.3e})")
        if kind == "lattice":
            if any(a != b for a, b in res):
                fail("B5 at the Year shape is not bitwise equal to its "
                     "plain version on lattice particles")
        elif (abs(res[0][0] - res[0][1]) > cold_width
              or abs(res[1][0] - res[1][1]) > width * 1.0001):
            fail("B5 at the Year shape is off its plain version by more "
                 "than its bound")


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


def wg(steps, m, n, p):
    """The wgmma or wide route's launches beside a path's tile launches
    (B3, or B1's chain in Gram mode) at [m, n] rows and columns of width p:
    steps where ops/svgd_tile.py:tile_route picks it, else none."""
    from stein_tpu_torch.ops import svgd_tile
    route = svgd_tile.tile_route(m, n, p)
    if route == svgd_tile.WGMMA:
        return {"B3-wgmma": steps}
    if route == svgd_tile.WIDE:
        return {"B3-wide": steps}
    return {}


def reset(counters):
    """Every count of the registry (graphs.launch_counters) to 0."""
    for c in counters.values():
        setattr(*c, 0)


def read(counters):
    return {k: getattr(*c) for k, c in counters.items()}


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
    want.update(B7=NN_STEPS, B3=NN_STEPS, B5=NN_STEPS + 1,
                **wg(NN_STEPS, NN_N, NN_N, NN_P))
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
                B4=NN_LARGE_STEPS + 1, B2=NN_LARGE_STEPS + 1,
                **wg(NN_LARGE_STEPS, NN_LARGE, NN_LARGE, NN_P))
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
    want.update(B3=LARGE_STEPS, B2=LARGE_STEPS + 1, **dp(LARGE_STEPS),
                **wg(LARGE_STEPS, LARGE_N, LARGE_N, P))
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


def plain_pallas_runner(sampler, batch, grad_fn, gram, median_fn=None):
    """run() of a kernel_impl='pallas' sampler with every kernel's plain
    version called on the card's tensors. run(k) starts from the sampler's
    state and returns (theta, optimizer state, [median], [phi_norm]) after
    k steps; the sampler is not advanced. ``median_fn(theta)``, where
    given, is the cold median of every step (median='binned' or
    'subsample') in place of the warm search."""
    import torch
    from stein_tpu_torch.ops import fused_median, rbf, svgd_tile
    from stein_tpu_torch.ops.median import row_subsample_block, subsample_rows

    n = sampler.n_particles

    def median(theta, med_prev, passes):
        if median_fn is not None:
            return median_fn(theta)
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
# [mesh2d]'s recipe, throughput_config(1000, 128, mesh=, model_axis='model')
# on a 1x1 2-D mesh, [main]'s data, Adam(0.1), 500 steps: the JAX package's
# run on the CPU (interpret mode) reads this log_p_mean at step 500, and
# this max |particle mean - posterior mean|. Its trajectories part
# chaotically: the JAX package's own runs of the recipe with
# median_collectives='grid', kernel_impl='xla' and the single-device
# throughput_config land 1.854, 0.365 and 0.714 from it at step 500 (all
# read -48985.28 at step 10), the port's plain versions on the CPU 0.486
# (posterior error 0.00967) and the card 1.892 (H100 run). So the card's
# log_p_mean is held within twice the largest of the JAX package's own
# spreads (the model check is the posterior error, held to 4x the JAX
# value); tests/test_torch_reference_values.py recomputes all three.
MESH2D_LOGP_JAX = -254.36280822753906
MESH2D_LOGP_SPREAD_JAX = 1.8538665771484375
POSTERIOR_MESH2D_JAX = 0.00949752300508655
# The 2-D step's tile works on the UNCENTRED u = grads - theta / h^2 and
# adds ksum theta / h^2 back (the JAX order), so phi cancels and its
# rounding grows by |theta / h^2| / |phi|: the JAX package's own
# kernel_impl='pallas' and 'xla' 2-D runs of each recipe part by these
# max abs sample differences after 10 steps (CPU, interpret mode), as
# step_impl='fused' does (FUSED_SPREAD_JAX); both runs leave the fused_gram
# class by step 10. The card is held to the class for FUSED_CLASS_STEPS
# steps and to twice these for 10: each is one draw of the rounding's
# growth, and the card's 3xTF32 tile against the CPU's f32 product drew
# 4.724e-06, 7.756e-06 (mesh2d-grid) on the H100.
MESH2D_SPREAD_JAX = {"mesh2d": 6.040558218955994e-06,
                     "mesh2d-grid": 5.200505256652832e-06,
                     "mesh2d-nn": 4.76837158203125e-06}
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
             dict(glm=GLM_STEPS, B1=GLM_STEPS, B2=1, **wg(GLM_STEPS, N, N, P)))
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
             dict(glm=GLM50_STEPS, B1=GLM50_STEPS,
                  **wg(GLM50_STEPS, 50, 50, P)))
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
                   dict(logistic=LOGREG_STEPS, B1=LOGREG_STEPS, B2=1,
                        **wg(LOGREG_STEPS, N, N, 55)))
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
    run_path("main-fused", s, batch, STEPS,
             dict(B1=STEPS, B10=STEPS, B2=1, **dp(STEPS)))
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
             dict(B3=LARGE_STEPS, B2=LARGE_STEPS + 1, B6=LARGE_STEPS,
                  **dp(LARGE_STEPS), **wg(LARGE_STEPS, LARGE_N, LARGE_N, P)))
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
                          {"logistic": COV_STEPS, "B1": COV_STEPS,
                           **wg(COV_STEPS, COV_N, COV_N, COV_D + 1)})
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
    # kernel); its scores are the linear model's torch.func gradients: the
    # data products, once for each of the 7 score calls (V, U and the
    # check's own on each sampler; theta0's V).
    counts["ksd"] = check_counts("ksd", counters, dp(7))
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
        "B1": 7 * CKPT_STEPS, "B2": 7, **dp(7 * CKPT_STEPS),
        **wg(7 * CKPT_STEPS, N, N, P)})
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
    # The trial's two samplers take 1 + IMQ_STEPS gradients.
    counts["kernel-imq"] = check_counts("kernel-imq", counters,
                                        dp(IMQ_STEPS + 1))
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

def bracket_case(label, rows, cols, exact, dev, torch):
    """B8 and B9 against their plain versions on one block (rows [m, p]
    against cols [n, p], about the columns' mean, at their plain cold
    median): D <= 1e-5 normalised (bitwise, with mm and the counts, where
    ``exact``), the counts and mm those of the kernel's own D, B9's D that
    of B8, two calls bitwise. Returns (D's max abs error, 0 where exact;
    (rows, cols, med, center, hi_bound))."""
    from stein_tpu_torch.ops import fused_median as fm
    from stein_tpu_torch.ops import svgd_tile
    from stein_tpu_torch.ops.median import DEFAULT_BRACKETS, count_le

    zero = torch.zeros((), dtype=torch.float32, device=dev)
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
    return (0.0 if exact else (D - Dp).abs().max().item(),
            (rows, cols, med, c, hib))


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
    from stein_tpu_torch.ops.median import DEFAULT_BRACKETS, count_le

    rng = np.random.default_rng(6)
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
        err, args = bracket_case(label, rows, cols, exact, dev, torch)
        errs["B8"] = max(errs["B8"], err)
        errs["B9"] = max(errs["B9"], err)
        if label.startswith("[mesh] path"):
            inputs = {"B8": args[:4], "B9": args}

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
    card's tensors) while the block runs: B8, B9, B3 (both of its mesh
    entry points), B7, B10, the bin count and the data products."""
    from stein_tpu_torch.models import bayesian_nn
    from stein_tpu_torch.ops import data_product as dpm
    from stein_tpu_torch.ops import fused_median as fm
    from stein_tpu_torch.ops import median, svgd_tile
    from stein_tpu_torch.parallel import sharded_fused

    def bin_count_plain(G, rowsq_rows, colsq, windows, n_bins, out=None):
        counts = median._gram_bin_counts(G, rowsq_rows, colsq, windows,
                                         n_bins)
        return counts if out is None else out.add_(counts)

    def nn_plain(theta, batch, f, H, consts):
        return bayesian_nn.nn_grads_plain(
            theta, batch["X"], batch["y"].reshape(-1), f, H, consts)

    def phi_rect_plain(rows, cols, grads, h2, n_total=None, center=None,
                       precision="f32"):
        c = (svgd_tile.column_center(cols) if center is None
             else center).reshape(1, -1)
        ku, ks = svgd_tile.svgd_both_ksum_plain(rows, cols, grads, h2, c,
                                                precision)
        return svgd_tile._combine(ku, ks, rows, c, h2,
                                  n_total or cols.shape[0])

    swaps = [(sharded_fused, "fused_bracket_pass",
              fm.fused_bracket_pass_plain),
             (sharded_fused, "fused_bracket_grid_pass",
              fm.fused_bracket_grid_pass_plain),
             (svgd_tile, "svgd_both_ksum", svgd_tile.svgd_both_ksum_plain),
             (svgd_tile, "svgd_phi_rect", phi_rect_plain),
             (svgd_tile, "svgd_both_ksum_on_D",
              svgd_tile.svgd_both_ksum_on_D_plain),
             (bayesian_nn, "nn_grads", nn_plain),
             (median, "bin_count", bin_count_plain),
             (dpm, "data_product", dpm.data_product_plain),
             (dpm, "data_product_t", dpm.data_product_t_plain)]
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
    from stein_tpu_torch.parallel import (
        mesh_2d,
        particle_mesh,
        setup_distributed,
    )

    setup_distributed("nccl", store=dist.HashStore(), world_size=1, rank=0,
                      device_id=dev)
    mesh = particle_mesh()
    cpu_mesh = particle_mesh(dist.new_group(backend="gloo"))
    # The 2-D mesh of one process: an NCCL group for each axis, and the
    # same on gloo for the CPU comparisons.
    mesh2, cpu_mesh2 = mesh_2d(1, 1), mesh_2d(1, 1, backend="gloo")
    t0 = time.perf_counter()
    coll.psum(torch.ones(1, device=dev), mesh)   # NCCL's lazy set-up
    torch.cuda.synchronize()
    log(f"[mesh] {mesh}; first NCCL collective "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    lin = LinearRegressionModel(P)
    suff = lin.sufficient_batch(batch)
    counts, timed = {}, {}

    def sampler_for(n, model, theta, cfg, two_d=False):
        def make(device):
            if two_d:
                m = mesh2 if device == "cuda" else cpu_mesh2
            else:
                m = mesh if device == "cuda" else cpu_mesh
            return SVGDSampler(n, model.log_p, model.template(),
                               Adam(0.1, decay=0.999 if model is nn_model
                                    else 1.0),
                               theta=theta, device=device,
                               **dict(cfg, mesh=m))
        return make

    def run_path(label, make, b, want, lr=0.1):
        """run(b, MESH_STEPS) on the card: counts, finiteness; 10 steps
        against the CPU at the class, or for the 2-D paths 5 at the class
        and 10 within the JAX package's own spread (MESH2D_SPREAD_JAX)."""
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
        if label in MESH2D_SPREAD_JAX:
            compare_with_cpu(make, b, FUSED_CLASS_STEPS, label, lr)
            compare_spread(label, make, b, 10,
                           2 * MESH2D_SPREAD_JAX[label],
                           "kernel_impl='pallas' vs 'xla' spread, twice")
        else:
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
    s, _ = run_path("mesh", make, batch,
                    dict(B8=MESH_STEPS, B3=MESH_STEPS, **dp(MESH_STEPS),
                         **wg(MESH_STEPS, N, N, P)))
    posterior("mesh", s, POSTERIOR_MESH_JAX)
    single = throughput_config(N, P)
    check_class("mesh", "the single-device fused_gram sampler on the card",
                sampler_trial(lambda: make("cuda"), batch, 10),
                sampler_trial(lambda: SVGDSampler(
                    N, lin.log_p, lin.template(), Adam(0.1), theta=theta0,
                    device="cuda", **single), batch, 10), 10, 0.1)

    run_path("mesh-grid", sampler_for(
        N, lin, theta0, dict(cfg, median_collectives="grid")), batch,
        dict(B9=MESH_STEPS, B3=MESH_STEPS, **dp(MESH_STEPS),
             **wg(MESH_STEPS, N, N, P)))
    run_path("mesh-ring", sampler_for(
        N, lin, theta0, dict(cfg, median_collectives="grid", comm="ring")),
        batch, dict(B9=MESH_STEPS, B3=MESH_STEPS, **dp(MESH_STEPS),
                    **wg(MESH_STEPS, N, N, P)))

    cfg_glm = throughput_config(N, P, mesh=mesh, model=lin)
    if "quadratic_form" not in cfg_glm:
        fail("[mesh-glm] throughput_config(model=) gave no quadratic_form")
    s, _ = run_path("mesh-glm", sampler_for(N, lin, theta0, cfg_glm), suff,
                    dict(B8=MESH_STEPS, B3=MESH_STEPS, **wg(MESH_STEPS, N, N, P)))
    posterior("mesh-glm", s, POSTERIOR_MESH_GLM_JAX)

    Xn, yn, theta_nn = nn_data(NN_N)
    nn_batch = {"X": torch.tensor(Xn, dtype=torch.float32, device=dev),
                "y": torch.tensor(yn, dtype=torch.float32, device=dev)}
    cfg_nn = throughput_config(NN_N, NN_P, mesh=mesh, model=nn_model)
    if "custom_grads" not in cfg_nn:
        fail("[mesh-nn] throughput_config(model=) gave no custom_grads")
    _, aux = run_path("mesh-nn", sampler_for(NN_N, nn_model, theta_nn,
                                             cfg_nn), nn_batch,
                      dict(B7=MESH_STEPS, B8=MESH_STEPS, B3=MESH_STEPS,
                           **wg(MESH_STEPS, NN_N, NN_N, NN_P)))
    lp = aux["log_p_mean"][-1].item()
    log(f"[mesh-nn] log_p_mean step {MESH_STEPS} {lp!r}; JAX package's "
        f"one-device mesh run: {NN_MESH_LOGP_JAX} (relative gap "
        f"{abs(lp / NN_MESH_LOGP_JAX - 1):.3e}, bound {NN_LOGP_RTOL:g})")
    if abs(lp / NN_MESH_LOGP_JAX - 1) > NN_LOGP_RTOL:
        fail(f"[mesh-nn] log_p_mean is not within {NN_LOGP_RTOL:g} of the "
             "JAX package's")
    run_mesh_medians_2d(sampler_for, mesh2, run_path, X, y, theta0, batch,
                        nn_model, nn_batch)
    b10_err = check_b10_2d(dev, torch, mesh2, nn_model, theta0, nn_batch,
                           batch)
    return counts, timed, mesh, b10_err


# ------------------------------------------- the large-n mesh rows (PR 13)
# bench_torch.py's meshL rows (bench.py:555-572): n=8192, p=64 linear
# regression on the sufficient batch through fused_shard, 1024-wide tiles,
# 64 median rows, on the one-process NCCL mesh.
MESHL_STEPS, MESHL_CHECK_STEPS = 50, 4
# The JAX suite's class of fused_shard against another fp order of the
# same in-kernel-Gram path (tests_tpu/test_tpu_fidelity.py:776-777: "same
# class, different tile/center fp order"): the samples after
# MESHL_CHECK_STEPS steps. At the fused_gram class (rtol 2e-4 / atol 1e-6)
# they leave it (measured excess 3.8e-5, H100): step 1 is in the class, but
# a coordinate in Adam's eps regime there moves its particle by ~2e-4, and
# the quadratic form's A (entries ~1e3) spreads that to all its gradients.
MESHL_SAMPLES_CLASS = (2e-2, 1e-4)


def run_meshL(dev, torch, counters, mesh):
    """[meshL] ('rounds': B8) and [meshL-grid] ('grid': B9) at full width:
    run(batch, MESHL_STEPS)'s counts (the bracket kernel and B3 every step,
    nothing else) and finiteness; on the path's own particles after it, B3
    against its plain version (<= 1e-4 normalised, repeat bitwise) and
    B8/B9 on the [64, 8192] median block (bracket_case); then
    MESHL_CHECK_STEPS steps against the plain functions on the card
    (plain_kernels(), which must launch nothing): medians, phi_norm and
    the first clipped phi at the fused_gram class, the samples at
    MESHL_SAMPLES_CLASS. Returns each path's counts, (sampler, batch) and
    the kernels' max abs errors."""
    import bench_torch
    from stein_tpu_torch.ops import model_grad, svgd_tile
    from stein_tpu_torch.ops.median import subsample_rows

    counts, timed, errs = {}, {}, {"B3": 0.0, "B8": 0.0, "B9": 0.0}
    rtol, atol = MESHL_SAMPLES_CLASS
    for label, arm, kernel in (("meshL", "meshL_fused_shard", "B8"),
                               ("meshL-grid", "meshL_fused_shard_grid",
                                "B9")):
        def make(arm=arm):
            return bench_torch.make_meshL_sampler(
                mesh, n_obs=bench_torch.N_OBS, device=dev,
                **bench_torch.MESHL_ARMS[arm])

        s, b = make()
        reset(counters)
        t0 = time.perf_counter()
        aux = s.run(b, MESHL_STEPS)
        torch.cuda.synchronize()
        log(f"[{label}] n={bench_torch.MESHL_N}, p={bench_torch.MESHL_P}, "
            f"{bench_torch.MESHL_ARMS[arm]}: run(batch, {MESHL_STEPS}) in "
            f"{time.perf_counter() - t0:.2f} s (first call)")
        counts[label] = check_counts(label, counters,
                                     {kernel: MESHL_STEPS, "B3": MESHL_STEPS,
                                      **wg(MESHL_STEPS, bench_torch.MESHL_N,
                                           bench_torch.MESHL_N,
                                           bench_torch.MESHL_P)})
        check_finite(label, s, aux, MESHL_STEPS)
        log(f"[{label}] last step: " + ", ".join(
            f"{k}={v[-1].item():.6g}" for k, v in aux.items()))

        theta = s.state.particles
        A, b_eff, _ = bench_torch.LinearRegressionModel(
            bench_torch.MESHL_P).quadratic_form(b)
        g = model_grad.glm_grads_plain(theta, A, b_eff.reshape(1, -1))[0]
        h2 = aux["h2"][-1]
        c = svgd_tile.column_center(theta)
        phi = svgd_tile.svgd_phi(theta, g, h2, center=c)
        again = svgd_tile.svgd_phi(theta, g, h2, center=c)
        ku, ks = svgd_tile.svgd_both_ksum_plain(theta, theta, g, h2,
                                                c.reshape(1, -1))
        plain = svgd_tile._combine(ku, ks, theta, c.reshape(1, -1), h2,
                                   theta.shape[0])
        err = norm_err(phi, plain)
        log(f"[kernels] B3 {label} path (n={theta.shape[0]}, "
            f"p={theta.shape[1]}): normalised error {err:.3e}, repeat "
            f"bitwise {torch.equal(phi, again)}")
        if err > 1e-4 or not torch.equal(phi, again):
            fail(f"B3 ({label} path) disagrees with its plain version")
        errs["B3"] = max(errs["B3"], (phi - plain).abs().max().item())
        e8, _ = bracket_case(
            f"{label} path [{bench_torch.MESHL_KW['median_max_rows']}, "
            f"{theta.shape[0]}] p={theta.shape[1]}",
            subsample_rows(theta, bench_torch.MESHL_KW["median_max_rows"]),
            theta, False, dev, torch)
        errs["B8"], errs["B9"] = max(errs["B8"], e8), max(errs["B9"], e8)

        def plain_drive(s_, b_, k):
            with plain_kernels():
                return s_._eager("run", b_, k)

        log(f"[{label}] the samples after {MESHL_CHECK_STEPS} steps are "
            f"held at rtol {rtol:g} / atol {atol:g} (MESHL_SAMPLES_CLASS)")
        reset(counters)
        want = sampler_trial(lambda: make()[0], b, MESHL_CHECK_STEPS,
                             drive=plain_drive)
        if any(read(counters).values()):
            fail(f"[{label}] the plain run launched {read(counters)}")
        check_class(label, "the plain functions on the card",
                    sampler_trial(lambda: make()[0], b, MESHL_CHECK_STEPS),
                    want, MESHL_CHECK_STEPS, 0.1,
                    samples_excess=lambda a, b_: float(np.max(
                        np.abs(a - b_) - (atol + rtol * np.abs(b_)))))
        timed[label] = (s, b)
    return counts, timed, errs


# ------------------------------- the fidelity suite and the bench (PR 13)
FIDELITY_CASES = 25
FIDELITY_TIMEOUT_S = 420
BENCH_TIMEOUT_S = 600


def pytest_phase(torch, label, args, cases, timeout, echo=False):
    """[label]: the card cases (``-m cuda``) of pytest ``args`` in a
    subprocess; with ``echo`` the run's own [label] lines. Fails on any
    failure, error or skip (a skip on the card hides the check), or on a
    count of passes other than ``cases``."""
    import re

    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "pytest", *args, "-m", "cuda", "-q",
           "--noconftest", "-p", "no:cacheprovider", "-rs"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                         timeout=timeout)
    out = res.stdout + res.stderr
    tag = f"[{label}]"
    if echo:
        for line in out.splitlines():
            if tag in line:
                log(line[line.index(tag):])
    summary = [ln for ln in out.splitlines()
               if re.search(r"\d+ (passed|failed|skipped|error)", ln)]
    summary = summary[-1] if summary else "(no summary)"
    log(f"{tag} pytest {summary.strip('= ')}, exit {res.returncode}, "
        f"{time.perf_counter() - t0:.1f} s")
    passed = re.search(r"(\d+) passed", summary)
    if (res.returncode != 0 or re.search(r"failed|skipped|error", summary)
            or not passed or int(passed.group(1)) != cases):
        for line in out.splitlines()[-60:]:
            log(f"{tag}   | {line}")
        fail(f"{tag} {summary}: expected {cases} passed, none failed or "
             "skipped")


def run_fidelity(torch):
    """[fidelity]: tests/test_torch_fidelity.py's card cases (the f32 step
    on the card against the f64 oracle) and their [fidelity] lines."""
    pytest_phase(torch, "fidelity", ["tests/test_torch_fidelity.py", "-s"],
                 FIDELITY_CASES, FIDELITY_TIMEOUT_S, echo=True)


GRAPH_TEST_CASES = 27
GRAPH_TEST_TIMEOUT_S = 300


def run_graph_tests(torch):
    """[graph-tests]: tests/test_torch_cuda.py's graph cases (every
    captured single-card path at its widths and every one-process NCCL
    mesh path, the binned ones included, each entry point against the
    eager loop, bitwise, with equal counts)."""
    pytest_phase(torch, "graph-tests", ["tests/test_torch_cuda.py", "-k",
                                        "graphs_equal_the_eager_loop"],
                 GRAPH_TEST_CASES, GRAPH_TEST_TIMEOUT_S)


STATISTICAL_CASES = 5
STATISTICAL_TIMEOUT_S = 300


def run_statistical(torch):
    """[statistical]: tests/test_torch_statistical.py's card cases (the
    JAX suite's analytic targets, f64 and bf16, through run's graphs) and
    their [statistical] lines."""
    pytest_phase(torch, "statistical",
                 ["tests/test_torch_statistical.py", "-s"],
                 STATISTICAL_CASES, STATISTICAL_TIMEOUT_S, echo=True)


TEARDOWN_TIMEOUT_S = 60


def teardown_child(mode):
    """``chip_smoke.py --teardown MODE`` (run by [teardown]): a one-process
    NCCL group captures a mesh run (the sampler's own graphs, fused_shard at
    [mesh]'s widths), then ends: 'destroy' frees the graphs
    (``graphs.release``) and destroys the group, 'exit' leaves both to the
    interpreter's exit (``graphs.release`` runs from atexit)."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from stein_tpu_torch import Adam, SVGDSampler, throughput_config
    from stein_tpu_torch.models import LinearRegressionModel
    from stein_tpu_torch.parallel import particle_mesh, setup_distributed
    from stein_tpu_torch.utils import graphs

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    setup_distributed("nccl", store=dist.HashStore(), world_size=1, rank=0,
                      device_id=dev)
    X, y, theta0 = make_data()
    model = LinearRegressionModel(P)
    batch = {"X": torch.tensor(X, dtype=torch.float32, device=dev),
             "y": torch.tensor(y, dtype=torch.float32, device=dev)}
    s = SVGDSampler(N, model.log_p, model.template(), Adam(0.1),
                    theta=theta0, device="cuda",
                    **throughput_config(N, P, mesh=particle_mesh()))
    aux = s.run(batch, 2 * graphs.CHUNK)
    torch.cuda.synchronize()
    if s._graphs is None or not s._graphs.graphs or \
            not torch.isfinite(aux["phi_norm"]).all():
        fail(f"[teardown] {mode}: the mesh run captured no graph")
    captured = len(s._graphs.graphs)
    if mode == "destroy":
        graphs.release()
        if s._graphs.graphs:
            fail("[teardown] graphs.release left a graph alive")
        dist.destroy_process_group()
    print(f"TEARDOWN-OK {mode} ({captured} graphs)", flush=True)
    return 0


def run_teardown():
    """[teardown]: ``teardown_child`` in a subprocess, 'destroy' then
    'exit': each must exit 0 within TEARDOWN_TIMEOUT_S."""
    for mode in ("destroy", "exit"):
        t0 = time.perf_counter()
        try:
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--teardown",
                 mode], cwd=HERE, capture_output=True, text=True,
                timeout=TEARDOWN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"[teardown] {mode}: the process did not exit within "
                 f"{TEARDOWN_TIMEOUT_S} s")
        ok = res.returncode == 0 and "TEARDOWN-OK" in res.stdout
        how = ("graphs.release, destroy_process_group" if mode == "destroy"
               else "the interpreter's exit alone")
        log(f"[teardown] one-process NCCL mesh, graphs captured, then "
            f"{how}: exit {res.returncode} in "
            f"{time.perf_counter() - t0:.1f} s "
            f"({res.stdout.strip().splitlines()[-1:]})")
        if not ok:
            for line in (res.stdout + res.stderr).splitlines()[-40:]:
                log(f"[teardown]   | {line}")
            fail(f"[teardown] {mode}: exit {res.returncode}")


RECOVERY_TIMEOUT_S = 120
# [recovery]'s schedule: train_with_recovery's steps and checkpoint
# interval (two whole graph chunks a checkpoint).
RECOVERY_STEPS, RECOVERY_EVERY = 256, 64
RECOVERY_DIR = os.path.join(HERE, "build", "chip_smoke_recovery")


def recovery_child(mode):
    """``chip_smoke.py --recovery MODE`` (run by [recovery]): [main]'s
    configuration (n=1000, p=128, ``throughput_config``, Adam(0.1); B1 and
    B2) through ``train_with_recovery(sampler, RECOVERY_STEPS,
    make_batches, ckpt, ckpt_every=RECOVERY_EVERY)``, the batch stacked k
    times. 'crash' exits 17 in the hook of the first checkpoint; 'resume'
    is the relaunch on that checkpoint; 'whole' the uninterrupted run from
    a fresh path. 'resume' and 'whole' write their final state and the
    aux of their chunks to <mode>.npz in RECOVERY_DIR."""
    t_start = time.perf_counter()
    import torch

    sys.path.insert(0, HERE)
    from stein_tpu_torch import Adam, SVGDSampler, throughput_config
    from stein_tpu_torch.models import LinearRegressionModel
    from stein_tpu_torch.utils.recovery import train_with_recovery

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    X, y, theta0 = make_data()
    model = LinearRegressionModel(P)
    batch = {"X": torch.tensor(X, dtype=torch.float32, device=dev),
             "y": torch.tensor(y, dtype=torch.float32, device=dev)}
    s = SVGDSampler(N, model.log_p, model.template(), Adam(1e-1),
                    theta=theta0, device="cuda", **throughput_config(N, P))
    if s._graphs is None or s._eager_reason is not None:
        fail(f"[recovery] {mode}: the sampler runs eagerly")

    def make_batches(start, k):
        return {key: v.expand(k, *v.shape) for key, v in batch.items()}

    ckpt = os.path.join(RECOVERY_DIR, "whole.ckpt" if mode == "whole"
                        else "main.ckpt")
    auxes, walls = [], {}

    def timed(name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            walls.setdefault(name, time.perf_counter() - t0)
            return out
        return call

    def hook(step, aux):
        auxes.append(aux)
        if mode == "crash" and step == RECOVERY_EVERY:
            print(f"[recovery] crash: checkpoint of step {step} in "
                  f"{time.perf_counter() - t0:.4f} s from "
                  f"train_with_recovery's call, "
                  f"{time.perf_counter() - t_start:.4f} s from the "
                  "process's start; exit 17", flush=True)
            os._exit(17)

    # The process's first step, split: read in turn before
    # train_with_recovery (which then meets each part warm) the kernel
    # library's load (the parent built it), the first cuBLAS call, the
    # first torch.func gradient of log_p (functorch's first transforms and
    # the data products' first launches) and a second one.
    from stein_tpu_torch import _cuda
    from stein_tpu_torch.api import _make_grad_all
    from stein_tpu_torch.utils.ravel import template_unraveler

    grad_all = _make_grad_all(model.log_p,
                              template_unraveler(model.template())[1])
    first = {}
    for name, fn in (
            ("library load", _cuda.library),
            ("first cuBLAS call",
             lambda: torch.matmul(batch["X"], batch["X"][:1].T)),
            ("first torch.func gradient",
             lambda: grad_all(s.state.particles, batch)),
            ("second torch.func gradient",
             lambda: grad_all(s.state.particles, batch))):
        timed(name, fn)()
        first[name] = round(walls[name], 4)
    print(f"[recovery] {mode}: the first step's parts, s: {first}",
          flush=True)

    def capture(warm, body, inner=s._graphs.capture):
        return inner(timed("warm-up", warm), body)
    s.restore = timed("restore", s.restore)
    s._graphs.capture = timed("capture", capture)
    t0 = time.perf_counter()
    executed = train_with_recovery(s, RECOVERY_STEPS, make_batches, ckpt,
                                   ckpt_every=RECOVERY_EVERY,
                                   on_checkpoint=hook)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if mode == "crash":
        print("CRASH-MODE-DID-NOT-CRASH", flush=True)
        return 1
    opt = s.state.opt_state
    state = {"particles": s.samples, "step": s.state.step.cpu().numpy(),
             **{f"opt_{k}": v.cpu().numpy()
                for k, v in zip(opt._fields, opt)},
             **{f"aux_{k}": torch.cat([a[k] for a in auxes]).cpu().numpy()
                for k in auxes[0]}}
    np.savez(os.path.join(RECOVERY_DIR, f"{mode}.npz"), **state)
    print(f"[recovery] {mode}: executed {executed} steps to step "
          f"{int(s.state.step)}; graph captures {s._graphs.captures}; "
          f"restore {walls.get('restore')} s, first capture "
          f"{walls.get('capture')} s (of which its warm-up step, the "
          f"process's first after the parts above, {walls.get('warm-up')} "
          "s), "
          f"train_with_recovery {wall:.4f} s, "
          f"{time.perf_counter() - t_start:.4f} s from the process's start",
          flush=True)
    print(f"RECOVERY-DONE {executed} {int(s.state.step)} "
          f"{s._graphs.captures}", flush=True)
    return 0


def run_recovery():
    """[recovery]: ``recovery_child`` in a subprocess, 'crash', 'resume'
    then 'whole', each within RECOVERY_TIMEOUT_S: the crash exits 17 with
    the checkpoint of step RECOVERY_EVERY in place; the relaunch restores
    it, executes the rest and replays graphs; its state (particles, Adam's
    moments and scalars, the step) and the aux of its chunks are bitwise
    those of the uninterrupted run."""
    os.makedirs(RECOVERY_DIR, exist_ok=True)
    for name in os.listdir(RECOVERY_DIR):
        os.remove(os.path.join(RECOVERY_DIR, name))
    done = {}
    for mode, code in (("crash", 17), ("resume", 0), ("whole", 0)):
        t0 = time.perf_counter()
        try:
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--recovery",
                 mode], cwd=HERE, capture_output=True, text=True,
                timeout=RECOVERY_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"[recovery] {mode}: the process did not exit within "
                 f"{RECOVERY_TIMEOUT_S} s")
        for line in res.stdout.splitlines():
            if line.startswith("[recovery]"):
                log(line)
            if line.startswith("RECOVERY-DONE"):
                done[mode] = [int(x) for x in line.split()[1:]]
        log(f"[recovery] {mode}: exit {res.returncode} in "
            f"{time.perf_counter() - t0:.1f} s (the process, from its "
            "start)")
        ok = res.returncode == code and "DID-NOT-CRASH" not in res.stdout
        if mode == "crash":
            path = os.path.join(RECOVERY_DIR, "main.ckpt")
            with np.load(path) as f:
                paths = str(f["__meta__"][1]).split("|")
                held = int(f[f"leaf_{paths.index('.step')}"])
            files = sorted(os.listdir(RECOVERY_DIR))
            log(f"[recovery] crash: the checkpoint holds step {held}; "
                f"files {files}")
            ok = ok and held == RECOVERY_EVERY and files == ["main.ckpt"]
        if not ok:
            for line in (res.stdout + res.stderr).splitlines()[-40:]:
                log(f"[recovery]   | {line}")
            fail(f"[recovery] {mode}: exit {res.returncode}")
    want = {"resume": [RECOVERY_STEPS - RECOVERY_EVERY, RECOVERY_STEPS],
            "whole": [RECOVERY_STEPS, RECOVERY_STEPS]}
    if any(done.get(m, [None] * 3)[:2] != w or done[m][2] < 1
           for m, w in want.items()):
        fail(f"[recovery] [executed, step, captures] {done}: expected "
             f"{want} and graphs captured")
    with np.load(os.path.join(RECOVERY_DIR, "resume.npz")) as f:
        resumed = dict(f)
    with np.load(os.path.join(RECOVERY_DIR, "whole.npz")) as f:
        whole = dict(f)
    same = {k: bool(np.array_equal(v, whole[k][RECOVERY_EVERY:]
                                   if k.startswith("aux_") else whole[k]))
            for k, v in resumed.items()}
    log(f"[recovery] resumed against the uninterrupted run, bitwise (aux "
        f"of steps {RECOVERY_EVERY}-{RECOVERY_STEPS}): {same}")
    if set(same) != set(whole) or not all(same.values()):
        fail("[recovery] the resumed state differs from the uninterrupted "
             "run")

def run_bench(torch):
    """[bench]: bench_torch.py in a subprocess at its default budget; its
    JSON line must parse and hold every key of bench.py's line, each
    value positive. Returns the line."""
    import bench_torch

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "bench_torch.py"], cwd=HERE,
                         capture_output=True, text=True,
                         timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for line in res.stderr.splitlines()[-20:]:
        log(f"[bench]   | {line}")
    lines = res.stdout.strip().splitlines()
    try:
        line = json.loads(lines[-1])
    except (IndexError, ValueError):
        fail(f"[bench] no JSON line (exit {res.returncode}): "
             f"{res.stdout[-2000:]}")
    log(f"[bench] {json.dumps(line)}")
    log(f"[bench] exit {res.returncode}, {wall:.1f} s")
    top, extra = bench_torch.bench_py_keys()
    missing = sorted(top - set(line)) + sorted(
        extra - set(line.get("extra", {})))
    values = [line.get("value"), line.get("vs_baseline"),
              *line.get("extra", {}).values()]
    if res.returncode != 0 or missing or not all(
            isinstance(v, (int, float)) and v > 0 for v in values):
        fail(f"[bench] exit {res.returncode}; keys of bench.py's line "
             f"missing: {missing}; values {values}")
    return line


# --------------------------------------------- A5: the other medians
# large_particle.py's default size: n=10240, LinearRegressionModel(64),
# 1000 observations from numpy seed 0 (its data recipe), Adam(1e-2), the
# streaming tile (B3) for phi.
MED_N, MED_P, MED_OBS, MED_STEPS = 10240, 64, 1000, 50
BIN_ROWS = 256        # binned_median's row block
# The bin-count launches of a binned step: a launch a row block (40 at
# n=10240) and level, two levels (both middle ranks' windows in one).
BIN_PER_STEP = -(-MED_N // BIN_ROWS) * 2
MED_ROWS = 128


def large_particle_data(seed=0):
    """examples/large_particle.py's data at its defaults, f32."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(MED_OBS, MED_P))
    w_true = rng.normal(size=(MED_P, 1))
    y = X @ w_true + rng.normal(size=(MED_OBS, 1)) * 0.5
    theta0 = np.random.default_rng(3).normal(size=(MED_N, MED_P)) * 0.01
    return (X.astype(np.float32), y.astype(np.float32),
            theta0.astype(np.float32))


# The bin-count kernel's phase: its shapes on the binned paths.
BIN_REM_N = 10000     # n with a remainder block: 39 x 256 + 16
# The mesh paths' blocks at N=1000, 4096 bins (SVGDSampler's binned_bins;
# the ring's also at ring_binned_median's own default, 2048): the
# one-process gathered step's row blocks, 3 x 256 then the remainder 232;
# the one-process ring's one rotation; on 4 ranks, a gathered rank's block
# and a ring rotation.
BIN_MESH = (BIN_ROWS, N)
BIN_MESH_REM = (N % BIN_ROWS, N)
BIN_RING1 = (N, N)
BIN_GATHER4 = (N // 4, N)
BIN_RING4 = (N // 4, N // 4)
BIN_PAST_SMEM = 60000   # bins past a block's 227 KB of shared memory
BIN_REPS = 50


def bin_count_cases(dev, torch):
    """[(label, G, r, c, windows, n_bins)] of the bin-count phase, each
    dtype the kernel takes (f32, bf16, f64), D = (r + c^T) - 2 G:
    large_particle.py's [256, 10240] block at the first level's interval
    [lo0, hi0], at a second level's (one first-level bin about the block's
    median: nearly every entry in an end bin) and at both middle ranks'
    second levels in one launch, at 4096, 2048 and 1 bins (and
    BIN_PAST_SMEM, the kernel's global-atomics path, one window and two);
    the n=10000 remainder block [16, 10000]; the mesh paths' blocks at
    4096 bins (the gathered step's [256, 1000] and remainder [232, 1000],
    a gathered rank's [250, 1000] on 4 ranks) and the ring's rotations
    ([1000, 1000] on one rank, [250, 250] on 4) at 4096 and 2048; a
    lattice D (G and r zero) on the bin edges, below lo, past the last
    edge, NaN and infinities, with entries whose 2 g overflows, at 4096,
    2048 and 1 bins, one window and two."""
    from stein_tpu_torch.ops.median import _binned_range, exact_median

    theta0 = large_particle_data()[2]
    cases = []
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        name = str(dtype).replace("torch.", "")

        def blocks(n, rows, bins, levels=("first", "second", "both")):
            theta = torch.tensor(theta0[:n], device=dev).to(dtype)
            rsq = torch.sum(theta * theta, dim=1)
            G = torch.matmul(theta[-rows:], theta.T)
            r = rsq[-rows:]
            D = r[:, None] + rsq[None, :] - 2.0 * G
            lo0, hi0 = _binned_range(torch.max(rsq), dtype)
            med = exact_median(D.double()).to(dtype)
            for nb in bins:
                w0 = (hi0 - lo0) / nb
                b = torch.floor((med - lo0) / w0)
                second = [(lo0 + (b + i) * w0, w0 / nb) for i in (0, 1)]
                wins = {"first": [(lo0, w0)], "second": second[:1],
                        "both": second, "first+second": [(lo0, w0),
                                                         second[0]]}
                for level in levels:
                    cases.append((f"{name} [{rows}, {n}] {level} level "
                                  f"{nb} bins", G, r, rsq, wins[level], nb))
        blocks(MED_N, BIN_ROWS, (4096, 2048))
        # 1 bin; and past the shared memory's room (global atomics).
        blocks(MED_N, BIN_ROWS, (1, BIN_PAST_SMEM), ("first",
                                                     "first+second"))
        blocks(BIN_REM_N, BIN_REM_N % BIN_ROWS, (4096,))
        for (rows, n), bins in ((BIN_MESH, (4096,)), (BIN_MESH_REM, (4096,)),
                                (BIN_GATHER4, (4096,)),
                                (BIN_RING1, (4096, 2048)),
                                (BIN_RING4, (4096, 2048))):
            blocks(n, rows, bins)
        for nb in (4096, 2048, 1):
            k = np.arange(-5, nb + 6, dtype=np.float64)
            lat = np.concatenate([-2.0 + 0.5 * k, -2.0 + 0.5 * k + 0.25,
                                  [-1e3, -2.5, 1e6, np.nan, -np.inf,
                                   np.inf]])
            c = torch.tensor(lat, device=dev).to(dtype)
            G = torch.zeros(3, lat.size, dtype=dtype, device=dev)
            G[2, :8] = 3e38
            G[2, 8] = float("nan")
            r = torch.zeros(3, dtype=dtype, device=dev)
            wins = [(torch.full((), lo, dtype=dtype, device=dev),
                     torch.full((), 0.5, dtype=dtype, device=dev))
                    for lo in (-2.0, -1.75)]
            for nw in (1, 2):
                cases.append((f"{name} lattice [3, {lat.size}] {nb} bins, "
                              f"{nw} windows", G, r, c, wins[:nw], nb))
    return cases


def check_bin_count(dev, torch):
    """[kernels] the bin-count kernel against its plain version
    (``_gram_bin_counts``, itself checked against ``_bin_counts`` of the
    plain D a window) at every case of bin_count_cases: the counts
    bitwise, alone and added to a running histogram, and a second call
    bitwise. Returns the max abs error (0 or the phase fails) and the
    timing inputs: the [median-binned] path's first-level case, its bin
    indices (for torch.bincount's time) and its second-level cases, one
    window and both."""
    from stein_tpu_torch.ops import median

    t0 = time.perf_counter()
    cases = bin_count_cases(dev, torch)
    bad = []
    for label, G, r, c, wins, nb in cases:
        want = median._gram_bin_counts(G, r, c, wins, nb)
        D = median._sq_dists_from_gram(G, r, c)
        plain_d = torch.equal(want, torch.stack(
            [median._bin_counts(D, lo, w, nb) for lo, w in wins]))
        got = median.bin_count(G, r, c, wins, nb)
        again = median.bin_count(G, r, c, wins, nb)
        acc = torch.arange(len(wins) * nb, dtype=torch.float32,
                           device=dev).reshape(len(wins), nb) * 2.0 ** 20
        summed = median.bin_count(G, r, c, wins, nb, acc.clone())
        torch.cuda.synchronize()
        ends = (want[0, 0] + want[0, -1]).item() / G.numel() \
            if nb > 1 else 1.0
        ok = (plain_d and torch.equal(got, want) and torch.equal(again, got)
              and torch.equal(summed, acc + want)
              and bool((got.sum(dim=1) == G.numel()).all()))
        log(f"[kernels] bin_count {label}: counts bitwise the plain "
            f"version's {torch.equal(got, want)}, with a running histogram "
            f"{torch.equal(summed, acc + want)}, repeat bitwise "
            f"{torch.equal(again, got)}, the plain version the plain D's "
            f"count {plain_d}; end bins hold {ends:.4f} of {G.numel()} "
            "entries")
        if not ok:
            bad.append(label)
    log(f"[kernels] bin_count: {len(cases) - len(bad)} of {len(cases)} "
        f"cases bitwise ({time.perf_counter() - t0:.1f} s)")
    if bad:
        fail(f"bin_count disagrees with its plain version: {bad}")
    by_label = {case[0]: case[1:] for case in cases}
    G, r, c, wins, nb = cases[0][1:]
    D = median._sq_dists_from_gram(G, r, c)
    lo, w = wins[0]
    idx = torch.clamp(((D - lo) / w).reshape(-1), 0.0, nb - 1.0).to(
        torch.int32)
    # f32 at the binned paths' blocks, 4096 bins: each level's case.
    shapes = {}
    for rows, n in (BIN_ROWS, MED_N), BIN_MESH, BIN_RING1, BIN_RING4:
        shapes[f"[{rows}, {n}]"] = {
            level: by_label[f"float32 [{rows}, {n}] {level} level 4096 bins"]
            for level in ("first", "second", "both")}
    return 0.0, dict(first=cases[0][1:], idx=idx, shapes=shapes)


# [kernels] data_product: the linear models' folded data products
# (ops/data_product.py, csrc/data_product.cu) at the row counts the paths
# give them, (n, N, p): [main] and its CPU comparisons (1000), [large-n]
# (10240), a 4-card shard of [main] (250), the one-process mesh's median
# block (256), meshL's 4-card shard (2048) and large_particle's (2560, p
# 64); the sufficient batch's A [128, 128] and the logistic model's X [50,
# 54] at n=1000; then the transpose's split at its edges: a ragged last
# chunk that is no multiple of 8 and rows of 55 (neither 16-byte aligned),
# chunks of 512 (N = 4096), a single row.
DP_CASES = ((1000, 1000, 128), (10240, 1000, 128), (250, 1000, 128),
            (256, 1000, 128), (2048, 1000, 64), (2560, 1000, 64),
            (1000, 128, 128), (1000, 50, 54), (97, 999, 55),
            (256, 4096, 64), (1, 1000, 128))
# Other dtypes: f64 and bf16 at [main]'s shape, bf16 at the 4-card shard.
DP_OTHER = (("float64", (1000, 1000, 128)), ("bfloat16", (1000, 1000, 128)),
            ("bfloat16", (250, 1000, 128)))
# Normalised error (max |kernel - plain| / max |plain|) against the plain
# version (torch.matmul, TF32 off): f32 sums of up to 4096 terms in
# another order, the kernel's in 3xTF32 (f64: 1e-12; bf16, rounded once
# from f32 sums: two bf16 ulps, 8e-3).
DP_BOUND = {"float32": 1e-5, "float64": 1e-12, "bfloat16": 8e-3}
# Row invariance: each case's rows launched again in blocks of these
# sizes, at every offset (0, b, 2b, ...), bitwise the full launch's rows.
DP_BLOCKS = (250, 97, 33, 1)
DP_REPS = 50


def dp(steps):
    """The launch counts of a linear model's torch.func gradient taken
    ``steps`` times: one folded product and its transpose a gradient."""
    return {"data_product": steps, "data_product_t": steps}


def same_bits(a, b):
    """Bitwise equality of two float tensors (-0.0 and 0.0 apart)."""
    import torch

    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(ints[a.element_size()]),
        b.contiguous().view(ints[b.element_size()]))


def check_data_product(dev, torch):
    """[kernels] data_product: both entry points against their plain
    versions at DP_CASES (f32) and DP_OTHER, within DP_BOUND normalised;
    two calls bitwise; every case's rows in blocks of DP_BLOCKS at every
    offset bitwise the full launch's. Returns the max abs error (f32) and
    the timing inputs."""
    from stein_tpu_torch.ops import data_product as dpm

    t0 = time.perf_counter()
    rng = np.random.default_rng(17)
    cases = [(n, N, p, torch.float32) for n, N, p in DP_CASES]
    cases += [(*shape, getattr(torch, name)) for name, shape in DP_OTHER]
    err32, inputs, bad = 0.0, {}, []
    for n, N, p, dtype in cases:
        M = torch.tensor(rng.normal(size=(N, p)), dtype=dtype, device=dev)
        W = torch.tensor(rng.normal(size=(n, p)), dtype=dtype, device=dev)
        R = torch.tensor(rng.normal(size=(n, N)), dtype=dtype, device=dev)
        name = str(dtype).split(".")[-1]
        line = []
        for fn, plain, A in ((dpm.data_product, dpm.data_product_plain, W),
                             (dpm.data_product_t, dpm.data_product_t_plain,
                              R)):
            got, again = fn(M, A), fn(M, A)
            want = plain(M, A)
            blocks = {}
            for b in DP_BLOCKS:
                if b > n:
                    continue
                parts = [fn(M, A[a:a + b]) for a in range(0, n, b)]
                blocks[b] = same_bits(torch.cat(parts), got)
            torch.cuda.synchronize()
            err = norm_err(got, want)
            failing = [b for b, same in blocks.items() if not same]
            ok = (err <= DP_BOUND[name] and same_bits(again, got)
                  and not failing)
            if dtype == torch.float32:
                err32 = max(err32, (got - want).abs().max().item())
            line.append(f"{fn.__name__} {err:.3e} normalised, repeat "
                        f"bitwise {same_bits(again, got)}, blocks of "
                        f"{sorted(blocks, reverse=True)} at every offset "
                        f"bitwise {not failing}"
                        + (f" (not: {failing})" if failing else ""))
            if not ok:
                bad.append(f"{fn.__name__} {name} n={n} N={N} p={p}")
        log(f"[kernels] data_product {name} n={n} N={N} p={p} (the "
            f"transpose's split {dpm.transpose_plan(N)}): "
            + "; ".join(line) + f" (bound {DP_BOUND[name]:g})")
        if dtype == torch.float32:
            inputs[n, N, p] = (M, W, R)
    log(f"[kernels] data_product: {2 * len(cases) - len(bad)} of "
        f"{2 * len(cases)} entry points within the bound and row-invariant "
        f"({time.perf_counter() - t0:.1f} s)")
    if bad:
        fail(f"data_product disagrees or is not row-invariant: {bad}")
    return err32, inputs


def data_product_route(lib):
    """[kernels] data_product route: the count of HMMA (tensor-core)
    instructions in the SASS of every f32 and bf16 instance of both
    tensor-core kernels of csrc/data_product.cu (cuobjdump --dump-sass of
    the built library); fails unless each product has instances of both
    dtypes and every one holds HMMA."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(lib.path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    found = {f"{k} {d}": [] for k in ("forward", "transpose")
             for d in ("f32", "bf16")}
    for part in sass.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        m = re.search(r"tc_(forward|transpose)_kernelILb([01])E", name)
        if m:
            found[f"{m.group(1)} {('f32', 'bf16')[int(m.group(2))]}"].append(
                body.count("HMMA"))
    log(f"[kernels] data_product route: HMMA instructions in the SASS of "
        f"each tensor-core instance (cuobjdump --dump-sass "
        f"{lib.path.name}): {json.dumps(found)}")
    bad = [k for k, v in found.items() if not v or min(v) == 0]
    if bad:
        fail(f"data_product: no tensor-core instructions in {bad}")


def data_product_timing(torch, gpu, dp_in):
    """[timing] data_product: each product at [main]'s, [large-n]'s and a
    4-card shard's shapes against its plain version (torch.matmul of the
    folded operands: cuBLAS, the library call too), by device time
    (device_us) in turns plain, kernel, kernel, plain, and by events in
    turns. Returns {(name, (n, N, p)): (ms by events, plain ms by events,
    kernel device µs, plain device µs)}, each device figure the mean of its
    two readings (None where one was not read)."""
    from stein_tpu_torch.ops import data_product as dpm

    def mean(a, b):
        return None if a is None or b is None else (a + b) / 2

    dp_t = {}
    for key in ((N, N_OBS, P), (LARGE_N, N_OBS, P), (N // 4, N_OBS, P)):
        M_, W_, R_ = dp_in[key]
        for fn, plain, A_ in ((dpm.data_product, dpm.data_product_plain,
                               W_),
                              (dpm.data_product_t, dpm.data_product_t_plain,
                               R_)):
            ms_, plain_ms_ = in_turns(lambda: plain(M_, A_),
                                      lambda: fn(M_, A_), DP_REPS, torch)
            p1 = device_us(lambda: plain(M_, A_), DP_REPS, torch)
            k1 = device_us(lambda: fn(M_, A_), DP_REPS, torch)
            k2 = device_us(lambda: fn(M_, A_), DP_REPS, torch)
            p2 = device_us(lambda: plain(M_, A_), DP_REPS, torch)
            dp_t[fn.__name__, key] = (ms_, plain_ms_, mean(k1, k2),
                                      mean(p1, p2))
            log(f"[timing] {gpu}: {fn.__name__} n={key[0]} N={key[1]} "
                f"p={key[2]}: kernel {k1}, {k2} us (device, in turns with "
                f"plain; events {ms_ * 1e3:.2f}), plain (torch.matmul) "
                f"{p1}, {p2} us (device; events {plain_ms_ * 1e3:.2f})")
    return dp_t


def run_median_paths(dev, torch, counters, gpu):
    """[median-binned] and [median-subsample]: SVGDSampler(median='binned'
    | 'subsample', kernel_impl='pallas') at large_particle.py's default
    size. Counts (B3 every step, nothing else), 4 steps against the plain
    functions on the card, the medians against the exact ones, wall and
    device us a step. Returns each path's counts and (sampler, batch)."""
    from stein_tpu_torch import Adam, SVGDSampler
    from stein_tpu_torch.api import _make_grad_all
    from stein_tpu_torch.models import LinearRegressionModel
    from stein_tpu_torch.ops.median import (
        binned_median,
        exact_median,
        row_subsample_block,
        subsampled_sq_dist_median,
    )
    from stein_tpu_torch.ops.rbf import pairwise_sq_dists

    def binned_plain(t):
        with plain_kernels():
            return binned_median(t)

    X, y, theta0 = large_particle_data()
    model = LinearRegressionModel(MED_P)
    batch = {"X": torch.tensor(X, device=dev), "y": torch.tensor(y,
                                                                 device=dev)}
    counts, timed = {}, {}
    for label, cfg, median_fn, want in (
            ("median-binned", dict(median="binned"), binned_plain,
             dict(B3=MED_STEPS, bin_count=BIN_PER_STEP * MED_STEPS,
                  **dp(MED_STEPS), **wg(MED_STEPS, MED_N, MED_N, MED_P))),
            ("median-subsample", dict(median="subsample",
                                      median_max_rows=MED_ROWS),
             lambda t: subsampled_sq_dist_median(t, MED_ROWS),
             dict(B3=MED_STEPS, **dp(MED_STEPS),
                  **wg(MED_STEPS, MED_N, MED_N, MED_P)))):
        def make(cfg=cfg):
            return SVGDSampler(MED_N, model.log_p, model.template(),
                               Adam(1e-2), theta=theta0, device="cuda",
                               kernel_impl="pallas", **cfg)
        s = make()
        reset(counters)
        t0 = time.perf_counter()
        aux = s.run(batch, MED_STEPS)
        torch.cuda.synchronize()
        log(f"[{label}] run(batch, {MED_STEPS}) in "
            f"{time.perf_counter() - t0:.2f} s (first call)")
        counts[label] = check_counts(label, counters, want)
        check_finite(label, s, aux, MED_STEPS)
        log(f"[{label}] last step: " + ", ".join(
            f"{k}={v[-1].item():.6g}" for k, v in aux.items()))
        compare_with_plain(label, make, batch, plain_pallas_runner(
            make(), batch, _make_grad_all(model.log_p, s.unravel_fn),
            gram=False, median_fn=median_fn), 4, 1e-2)

        theta = s.state.particles
        med = median_fn(theta).item()
        med_cpu = median_fn(theta.cpu()).item()
        if label == "median-binned":
            # The kernel's binned median bitwise the plain count's (the
            # same counts); against the exact median of the full [n, n] D
            # (420 MB) within the histogram's bound, range / n_bins^2 / 2,
            # plus the f32 Gram's rounding of an entry, (p + 2) eps hi0;
            # against the CPU's binned_median of the same theta within one
            # final bin.
            med_kernel = binned_median(theta).item()
            med_sweep = binned_sweep().reference_binned_median(
                theta).item()
            log(f"[{label}] binned median with the bin-count kernel "
                f"{med_kernel!r}, with the plain count {med!r}, by the "
                f"per-window sweep (each middle rank on its own, the plain "
                f"count) {med_sweep!r}")
            if not med_kernel == med == med_sweep:
                fail(f"[{label}] the kernel's binned median is not the "
                     "plain count's and the per-window sweep's")
            D = pairwise_sq_dists(theta)
            exact = exact_median(D).item()
            del D
            hi0 = 4.0 * torch.sum(theta * theta, 1).max().item()
            width = hi0 * (1 + 1e-6) / 4096 ** 2
            gram = (MED_P + 2) * float(np.finfo(np.float32).eps) * hi0
            log(f"[{label}] binned median of the card's theta {med!r}; exact "
                f"median of the full D on the card {exact!r} (gap "
                f"{abs(med - exact):.3e}, bound {width / 2 + gram:.3e}); "
                f"the CPU's binned_median {med_cpu!r} (gap "
                f"{abs(med - med_cpu):.3e}, bound one final bin "
                f"{width:.3e})")
            if abs(med - exact) > width / 2 + gram or \
                    abs(med - med_cpu) > width:
                fail(f"[{label}] the binned median is off its bounds")
        else:
            # The exact median of the same row block, by a full sort.
            block = row_subsample_block(theta, MED_ROWS).reshape(-1)
            v = torch.sort(block).values
            k = block.numel()
            exact = ((v[(k + 1) // 2 - 1] + v[k // 2]) * 0.5).item()
            log(f"[{label}] subsample median of the card's theta {med!r}; "
                f"by a full sort of the same [{MED_ROWS}, {MED_N}] block "
                f"{exact!r}; the CPU's {med_cpu!r} (rel "
                f"{abs(med / med_cpu - 1):.3e}, bound 1e-5: the f32 Gram's "
                "order)")
            if med != exact or abs(med / med_cpu - 1) > 1e-5:
                fail(f"[{label}] the subsample median is off")
        us = run_timed(lambda k: s.run(batch, k), torch, 32)
        log(f"[timing] {gpu}: {label} (n={MED_N}, p={MED_P}) run() "
            f"{us:.2f} us/step by CUDA events")
        timed[label] = (s, batch)
    return counts, timed


def run_mesh_medians_2d(sampler_for, mesh2, run_path, X, y, theta0, batch,
                        nn_model, nn_batch):
    """[mesh-binned], [mesh-ring-binned] (the 1-D mesh with median='binned'
    and the tile) and [mesh2d], [mesh2d-nn], [mesh2d-grid] (the 2-D mesh
    ``mesh2`` of one process, throughput_config(model_axis=): B10 every
    step), each against the CPU gloo run of the same sampler.
    ``sampler_for(n, model, theta, cfg, two_d)`` builds a path's
    make(device); ``run_path`` is run_mesh_paths'."""
    from stein_tpu_torch import throughput_config
    from stein_tpu_torch.models import LinearRegressionModel

    lin = LinearRegressionModel(P)
    # bin_count a step: 4 row blocks of 256 (gathered) or one rotation
    # (the ring of one rank), two levels (both middle ranks in one).
    for label, comm, blocks in (("mesh-binned", "all_gather", 4),
                                ("mesh-ring-binned", "ring", 1)):
        cfg = dict(median="binned", kernel_impl="pallas", comm=comm)
        run_path(label, sampler_for(N, lin, theta0, cfg), batch,
                 dict(B3=MESH_STEPS, bin_count=2 * blocks * MESH_STEPS,
                      **dp(MESH_STEPS), **wg(MESH_STEPS, N, N, P)))

    cfg = throughput_config(N, P, mesh=mesh2, model_axis="model")
    log(f"[mesh2d] throughput_config({N}, {P}, mesh=, model_axis='model') "
        f"= { {k: str(v) for k, v in cfg.items() if k != 'mesh'} }")
    if (cfg.get("kernel_impl"), cfg.get("median_collectives")) != (
            "pallas", "rounds"):
        fail("[mesh2d] throughput_config did not pick the tile and rounds")
    cfg.pop("mesh")
    s, aux = run_path("mesh2d", sampler_for(N, lin, theta0, cfg, True),
                      batch, dict(B10=MESH_STEPS, **dp(MESH_STEPS)))
    lp = aux["log_p_mean"][-1].item()
    post = np.linalg.solve(X.T @ X + np.eye(P), X.T @ y).ravel()
    err = float(np.max(np.abs(s.samples.mean(0) - post)))
    log(f"[mesh2d] log_p_mean step {MESH_STEPS} {lp!r}; the JAX package's "
        f"1x1 run {MESH2D_LOGP_JAX} (gap {abs(lp - MESH2D_LOGP_JAX):.4g}, "
        f"relative {abs(lp / MESH2D_LOGP_JAX - 1):.3e}; bound twice the JAX "
        f"package's own spread {MESH2D_LOGP_SPREAD_JAX:.4g}); posterior mean "
        f"max abs error {err:.4e} (JAX's {POSTERIOR_MESH2D_JAX:.4e}, bound "
        f"4x)")
    if abs(lp - MESH2D_LOGP_JAX) > 2 * MESH2D_LOGP_SPREAD_JAX or \
            not err <= 4 * POSTERIOR_MESH2D_JAX:
        fail("[mesh2d] log_p_mean or the posterior mean is off")
    run_path("mesh2d-grid", sampler_for(N, lin, theta0, dict(
        cfg, median_collectives="grid"), True), batch,
        dict(B10=MESH_STEPS, **dp(MESH_STEPS)))

    theta_nn = nn_data(NN_N)[2]
    cfg_nn = throughput_config(NN_N, NN_P, mesh=mesh2, model_axis="model",
                               model=nn_model)
    cfg_nn.pop("mesh")
    if "custom_grads" in cfg_nn:
        fail("[mesh2d-nn] a model axis takes no custom_grads")
    run_path("mesh2d-nn", sampler_for(NN_N, nn_model, theta_nn, cfg_nn,
                                      True), nn_batch, dict(B10=MESH_STEPS))


def check_b10_2d(dev, torch, mesh2, nn_model, theta0, nn_batch, lin_batch):
    """B10 against its plain version on the 2-D step's own operands: the
    psum'd D rows of [mesh2d] (p=128) and [mesh2d-nn] (p=303) at theta0 with
    u = grads - theta / h^2, and an odd [333, 777] x [777, 300]: <= 1e-5
    normalised, a second call bitwise. Returns the max abs error."""
    from stein_tpu_torch.api import _make_grad_all
    from stein_tpu_torch.models import LinearRegressionModel
    from stein_tpu_torch.ops import fused_median, svgd_tile
    from stein_tpu_torch.ops.median import sharded_bisect_median_on_D
    from stein_tpu_torch.parallel import collectives as coll
    from stein_tpu_torch.ops.rbf import pairwise_sq_dists
    from stein_tpu_torch.parallel.sharded2d import _d_rows_2d
    from stein_tpu_torch.utils.ravel import template_unraveler

    f32 = torch.float32
    lin = LinearRegressionModel(P)
    cases = []
    for label, model, theta_np, b in (
            ("mesh2d", lin, theta0, lin_batch),
            ("mesh2d-nn", nn_model, nn_data(NN_N)[2], nn_batch)):
        theta = torch.tensor(theta_np, dtype=f32, device=dev)
        D, _ = _d_rows_2d(theta, coll.all_gather(theta, mesh2.particles),
                          mesh2.model)
        med = sharded_bisect_median_on_D(D, mesh2.particles, 256, 30)
        h2 = med / np.log(theta.shape[0])
        _, g = _make_grad_all(model.log_p,
                              template_unraveler(model.template())[1])(
            theta, b)
        cases.append((f"{label} [{theta.shape[0]}, {theta.shape[0]}] x "
                      f"[{theta.shape[0]}, {theta.shape[1]}]", D,
                      g - theta / h2, h2))
    rng = np.random.default_rng(8)
    t_r = torch.tensor(rng.normal(size=(777, 300)), dtype=f32, device=dev)
    D_r = pairwise_sq_dists(t_r)[:333].contiguous()
    zero = torch.zeros((), dtype=f32, device=dev)
    h2_r = fused_median.warm_search_on_value(D_r, zero, 30) / np.log(777)
    cases.append(("[333, 777] x [777, 300]", D_r,
                  torch.randn_like(t_r) - t_r / h2_r, h2_r))
    err_abs = 0.0
    for label, D_, u_, h2_ in cases:
        ku, ks = svgd_tile.svgd_both_ksum_on_D(D_, u_, h2_)
        ku2, ks2 = svgd_tile.svgd_both_ksum_on_D(D_, u_, h2_)
        ku0, ks0 = svgd_tile.svgd_both_ksum_on_D_plain(D_, u_, h2_)
        torch.cuda.synchronize()
        err = max(norm_err(ku, ku0), norm_err(ks, ks0))
        same = torch.equal(ku, ku2) and torch.equal(ks, ks2)
        log(f"[kernels] B10 on the 2-D step's operands, {label}: normalised "
            f"error {err:.3e} (bound 1e-05), repeat bitwise {same}")
        if err > 1e-5 or not same:
            fail(f"B10 {label} disagrees with its plain version or itself")
        err_abs = max(err_abs, (ku - ku0).abs().max().item(),
                      (ks - ks0).abs().max().item())
    return err_abs


# ------------------------------------------ A6: the example CLIs
# Each CLI of examples_torch/ at its default sizes on the card; the
# production run goes again with 500 more iterations from its checkpoint.
EXAMPLES = (
    ("linear_regression", []),
    ("logistic_regression", []),
    ("regression_neural_network", ["--prior-beta", "10"]),
    ("gaussian_mixture", []),
    ("production_run", ["--ckpt", "{ckpt}"]),
    ("production_run", ["--ckpt", "{ckpt}", "--n-iters", "3500"]),
    ("large_particle", []),
    ("large_particle", ["--median", "binned"]),
)


def _floats(line):
    import re
    return [float(t) for t in
            re.findall(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:e[-+]?\d+)?", line)]


def _last(out, prefix):
    hits = [ln for ln in out.splitlines() if ln.startswith(prefix)]
    if not hits:
        fail(f"[examples] no line starting with {prefix!r}")
    return hits[-1]


def check_example(name, out):
    """The acceptance numbers of a CLI's printed lines, as
    tests/test_torch_examples.py checks them. Returns the line shown."""
    if name == "linear_regression":
        est = _floats(_last(out, "Est. coefficients:"))
        conj = _floats(_last(out, "Conjugate posterior mean:"))
        ok = len(est) == len(conj) and np.allclose(est, conj, atol=5e-2,
                                                   rtol=0)
        return ok, f"est {est} vs conjugate {conj} (atol 5e-2)"
    if name == "logistic_regression":
        acc = _floats(_last(out, "Final accuracy:"))[0]
        return acc > 0.9, f"held-out accuracy {acc} (> 0.9)"
    if name == "regression_neural_network":
        first = _floats(_last(out, "Iteration: 0."))[-1]
        final = _floats(_last(out, "Final MSE:"))[0]
        return (np.isfinite(final) and final < first - 0.05,
                f"MSE {first} -> {final}")
    if name == "gaussian_mixture":
        modes = [_floats(ln) for ln in out.splitlines()
                 if ln.startswith("mode ")]
        ksd = _floats(_last(out, "KSD^2:"))[-1]
        ok = (len(modes) == 3 and 0 < ksd < 0.1
              and all(abs(m[2] - m[1]) < 0.15 and m[3] < 0.15
                      for m in modes))
        return ok, (f"modes (true, particle mass, mean err) "
                    f"{[m[1:4] for m in modes]}, KSD^2 {ksd}")
    if name == "production_run":
        ksd = _floats(_last(out, "final KSD^2:"))[-1]
        ran = _last(out, "executed")
        return np.isfinite(ksd) and ksd > 0, f"{ran}; KSD^2 {ksd}"
    err = _floats(_last(out, "posterior mean max-abs-err"))[0]
    rate = [ln for ln in out.splitlines() if " steps of n=" in ln]
    return err < 0.2 and len(rate) == 1, (
        f"{rate}; posterior mean max-abs-err {err} (< 0.2)")


def run_examples(torch, counters, gpu):
    """[examples]: each CLI of examples_torch/ in this process
    (runpy, --device cuda) at its default sizes, its printed acceptance
    numbers checked and its launch counts read. Returns the counts."""
    import contextlib
    import io
    import runpy
    import shutil

    ckdir = os.path.join(HERE, "build", "chip_smoke_examples")
    shutil.rmtree(ckdir, ignore_errors=True)
    os.makedirs(ckdir)
    ckpt = os.path.join(ckdir, "production.ckpt")
    counts = {}
    argv = sys.argv
    for i, (name, extra) in enumerate(EXAMPLES):
        args = [a.format(ckpt=ckpt) for a in extra]
        label = " ".join([name] + args).replace(ckpt, "<ckpt>")
        sys.argv = [name, *args, "--device", "cuda"]
        buf = io.StringIO()
        reset(counters)
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                runpy.run_path(os.path.join(HERE, "examples_torch",
                                            f"{name}.py"),
                               run_name="__main__")
            torch.cuda.synchronize()
        finally:
            sys.argv = argv
        wall = time.perf_counter() - t0
        got = {k: v for k, v in read(counters).items() if v}
        counts[f"examples/{name}#{i}"] = read(counters)
        out = buf.getvalue()
        ok, shown = check_example(name, out)
        if name == "production_run":
            # The second run resumes from the first's checkpoint.
            want = ("executed 500 steps" if "--n-iters" in args
                    else "executed 3000 steps")
            ok = ok and want in out
        log(f"[examples] {label}: {wall:.1f} s; {shown}; kernel launches "
            f"{got}")
        for line in out.splitlines()[-3:]:
            log(f"[examples]   | {line}")
        if not ok:
            fail(f"[examples] {label}: its acceptance check failed")
    return counts


def profile_numbers(fn, steps, torch):
    """torch.profiler over fn(steps) after fn(10): (wall us/step under the
    profiler, [(device us/step, kernel, launches/step)] of the kernels'
    own events, largest first), the rows empty when the profiler reports
    no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(10)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) / steps * 1e6
    rows = []
    for e in prof.key_averages():   # the kernels' own events only
        t = (getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0) or 0)
        if getattr(e, "device_type", None) == DeviceType.CUDA and t > 0 \
                and not getattr(e, "is_user_annotation", False):
            rows.append((t / steps, e.key, e.count / steps))
    rows.sort(reverse=True)
    return wall_us, rows


def profile_split(label, sampler, batch, steps, torch, gpu):
    """torch.profiler over `steps` steps of sampler.run after 10 warm-up
    steps: wall and device time per step, the device's busy share, and the
    kernels by device time (self device time per step, launches per step).
    Prints "not captured" when the profiler reports no device time."""
    wall_us, rows = profile_numbers(lambda k: sampler.run(batch, k), steps,
                                    torch)
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


# ------------------------------------------------------ the step graphs

# [graph]'s chunk lengths for the main path's capture time and step.
GRAPH_CHUNKS = (16, 32, 64)


def graph_check(label, s, fn, torch):
    """CHUNK + 3 steps (a chunk and a remainder) replayed from graphs,
    then through the eager loop from the same state: bitwise, with the
    same launch counts. fn(k, eager) drives k steps of sampler s."""
    from stein_tpu_torch.utils import graphs

    steps = graphs.CHUNK + 3
    state0 = graphs.tree_map(torch.clone, s.state)
    out = []
    for eager in (False, True):
        s.load_state(graphs.tree_map(torch.clone, state0))
        graphs.set_counts(dict.fromkeys(graphs.read_counts(), 0))
        aux = fn(steps, eager)
        torch.cuda.synchronize()
        out.append((graphs.tensor_leaves(s.state), aux,
                    graphs.read_counts()))
    (sg, ag, ng), (se, ae, ne) = out
    if ng != ne:
        fail(f"[graph] {label}: launch counts {ng} from the graphs, {ne} "
             "from the eager loop")
    diff = [k for k in ae if not torch.equal(ag[k], ae[k])]
    if diff or not all(torch.equal(a, b) for a, b in zip(sg, se)):
        fail(f"[graph] {label}: the graphs' {steps} steps differ from the "
             f"eager loop's (aux {diff}, or the state)")
    return steps, {k: v for k, v in ng.items() if v}


def graph_chunks(make, batch, torch, gpu):
    """The main path at each chunk length of GRAPH_CHUNKS: the first call
    (the capture and its warm-up step, then the chunk's steps) and the
    steady us/step of run(batch, 8 * C) by CUDA events."""
    from stein_tpu_torch.utils import graphs

    saved = graphs.CHUNK
    try:
        for c in GRAPH_CHUNKS:
            graphs.CHUNK = c
            s = make()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.run(batch, c)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            us = run_timed(lambda k: s.run(batch, k), torch, 8 * c)
            log(f"[graph] {gpu}: main, CHUNK {c}: first call {first:.3f} s "
                f"(capture, warm-up and {c} steps); {us:.2f} us/step over "
                f"run(batch, {8 * c})")
    finally:
        graphs.CHUNK = saved


def graph_size(label, s, batch, torch, gpu):
    """A chunk's graph of sampler ``s``'s run, captured once more with
    the CUDA graph kept: its node count (libcuda's cuGraphGetNodes),
    the capture's seconds (the warm-up step outside it) and the
    instantiation's. The sampler's own graphs are put back."""
    import ctypes

    from stein_tpu_torch.utils import graphs

    out = {}

    def capture(warm, body):
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            warm()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            body()
        out["capture_s"] = time.perf_counter() - t0
        nodes = ctypes.c_size_t(0)
        try:   # a count libcuda reads; none where it cannot
            err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
                ctypes.c_void_p(graph.raw_cuda_graph()), None,
                ctypes.byref(nodes))
        except (OSError, TypeError, AttributeError) as e:
            log(f"[graph] {label}: node count not read ({e!r})")
            err = -1
        out["nodes"] = nodes.value if err == 0 else None
        t0 = time.perf_counter()
        graph.instantiate()
        torch.cuda.synchronize()
        out["instantiate_s"] = time.perf_counter() - t0
        torch.cuda.current_stream().wait_stream(stream)
        return graph

    saved = s._graphs
    s._graphs = graphs.StepGraphs(capture=capture, mesh=s.mesh)
    try:
        s.run(batch, graphs.CHUNK)
        torch.cuda.synchronize()
    finally:
        s._graphs.free()
        s._graphs = saved
    log(f"[graph] {gpu}: {label}: a {graphs.CHUNK}-step graph holds "
        f"{out['nodes']} nodes; capture {out['capture_s']:.3f} s, "
        f"instantiate {out['instantiate_s']:.3f} s")
    return {f"chunk_{k}": v for k, v in out.items()}


def run_graph_phase(paths, torch, gpu):
    """[graph]: each sampler path, replayed from graphs against the eager
    loop. paths: {label: (sampler, fn(k, eager), reps)}. Per path: the
    bitwise check (graph_check), us/step of both by CUDA events in turns
    (eager, graph, graph, eager; reps steps a reading), and under the
    profiler (reps / 2 steps) each one's device us/step and kernel
    launches a step, with its busy share: that device time over its wall
    by events. Returns {label: numbers} for the summary line."""
    summary = {}
    for label, (s, fn, reps) in paths.items():
        if s._graphs is None:
            log(f"[graph] {label}: eager by the rule ({s._eager_reason})")
            summary[label] = {"graph": False, "reason": s._eager_reason}
            continue
        t0 = time.perf_counter()
        steps, counts = graph_check(label, s, fn, torch)
        t = {}
        for eager in (True, False, False, True):
            t.setdefault(eager, []).append(
                run_timed(lambda k: fn(k, eager), torch, reps))
        wall = {e: sum(v) / len(v) for e, v in t.items()}
        prof = {}
        for eager in (False, True):
            _, rows = profile_numbers(lambda k: fn(k, eager), reps // 2,
                                      torch)
            prof[eager] = (None if not rows else
                           (sum(r[0] for r in rows), sum(r[2] for r in rows)))
        line = {"graph": True, "captures": s._graphs.captures,
                "wall_us": wall[False], "eager_wall_us": wall[True]}
        for eager, key in ((False, ""), (True, "eager_")):
            if prof[eager] is not None:
                dev_us, launches = prof[eager]
                # Busy: the profiler's device time over the wall by CUDA
                # events without it (the profiler's own cost is not the
                # path's).
                line.update({f"{key}device_us": dev_us,
                             f"{key}busy": dev_us / wall[eager],
                             f"{key}launches": launches})
        summary[label] = line
        shown = ("device time not reported by torch.profiler"
                 if None in prof.values() else
                 f"device {prof[False][0]:.1f} vs {prof[True][0]:.1f} "
                 f"us/step, busy {line['busy']:.3f} vs "
                 f"{line['eager_busy']:.3f}, kernels "
                 f"{prof[False][1]:.1f} vs {prof[True][1]:.1f}/step")
        log(f"[graph] {gpu}: {label}: replays graphs ({s._graphs.captures} "
            f"captured); {steps} steps bitwise equal to the eager loop, "
            f"launches equal {counts}; graph vs eager: wall "
            f"{wall[False]:.2f} vs {wall[True]:.2f} us/step ({reps} steps "
            f"a reading), {shown} (profiler); phase "
            f"{time.perf_counter() - t0:.1f} s")
    return summary


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
    from stein_tpu_torch.utils import graphs
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
    if "--data-product" in sys.argv[1:]:
        data_product_route(lib)
        data_product_timing(torch, gpu, check_data_product(dev, torch)[1])
        return 0
    if "--tile" in sys.argv[1:]:
        year_b7(dev, torch, gpu)
        year_median(dev, torch, gpu)
        tile_routes(dev, torch, gpu)
        return 0
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
    year_b7(dev, torch, gpu)
    year_median(dev, torch, gpu)
    tile_routes(dev, torch, gpu)

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
    bin_err, bin_in = check_bin_count(dev, torch)
    dp_err, dp_in = check_data_product(dev, torch)
    data_product_route(lib)

    # ------------------------------------------------------ 4. main path
    # Every wrapper's launch count, the registry utils/graphs.py keeps.
    counters = graphs.launch_counters()
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
    want.update(B2=1, B1=STEPS, **dp(STEPS), **wg(STEPS, N, N, P))
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
    mesh_counts, mesh_timed, mesh, b10_2d_err = run_mesh_paths(
        dev, torch, counters, X, y, theta0, batch, nn_model)
    path_counts.update(mesh_counts)
    meshL_counts, meshL_timed, meshL_errs = run_meshL(dev, torch, counters,
                                                      mesh)
    path_counts.update(meshL_counts)
    mesh_timed.update(meshL_timed)
    errs["B3"] = max(errs["B3"], meshL_errs["B3"])
    for key in ("B8", "B9"):
        bracket_errs[key] = max(bracket_errs[key], meshL_errs[key])
    med_counts, med_timed = run_median_paths(dev, torch, counters, gpu)
    path_counts.update(med_counts)
    path_counts.update(run_examples(torch, counters, gpu))
    run_fidelity(torch)
    run_graph_tests(torch)
    run_teardown()
    run_recovery()
    run_statistical(torch)
    run_bench(torch)

    # --------------------------------------------------------- 5. timing
    K = 6 * graphs.CHUNK   # whole graph chunks
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
                           K)
    nn_plain_us = run_timed(plain_pallas_runner(
        nn_sampler, nn_batch,
        lambda t, b: bayesian_nn.nn_grads_plain(
            t, b["X"], b["y"].reshape(-1), 1, 100, nn_model._consts()),
        gram=True), torch, K)
    large_us = run_timed(lambda k: big.run(lr_batch, k), torch,
                         graphs.CHUNK)
    nn16_us = run_timed(lambda k: nn16.run(nn_batch, k), torch, K)
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
        reps = graphs.CHUNK if label == "large-n-epilogue" else K
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
                s_._eager("run", b_, k)
        # The binned, 2-D and large-n paths: 2 chunks a reading.
        reps = 2 * graphs.CHUNK if any(
            k in label for k in ("binned", "mesh2d", "meshL")) else K
        p1 = run_timed(plain, torch, reps)
        k1 = run_timed(lambda k: s_.run(b_, k), torch, reps)
        k2 = run_timed(lambda k: s_.run(b_, k), torch, reps)
        p2 = run_timed(plain, torch, reps)
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
    # The bin count at [median-binned]'s block (first level, 4096 bins):
    # the kernel by device time (events where device_us cannot read it);
    # its plain version and torch.bincount of the same block's bin indices
    # by events (both read back to the host, so the calls do not queue).
    # Then device time at each binned path's block and level, one window
    # and both.
    from stein_tpu_torch.ops import median as median_ops
    bin_first = bin_in["first"]
    bin_ms, bin_plain = in_turns(
        lambda: median_ops._gram_bin_counts(*bin_first),
        lambda: median_ops.bin_count(*bin_first), BIN_REPS, torch)
    bin_lib = cuda_ms(lambda: torch.bincount(bin_in["idx"],
                                             minlength=bin_first[-1]),
                      BIN_REPS, torch)
    bin_dev = {shape: {level: device_us(
        lambda case=case: median_ops.bin_count(*case), BIN_REPS, torch)
        for level, case in levels.items()}
        for shape, levels in bin_in["shapes"].items()}
    first_dev = bin_dev[f"[{BIN_ROWS}, {MED_N}]"]["first"]
    bin_by = "events" if first_dev is None else "device"
    if first_dev is not None:
        bin_ms = first_dev / 1e3
    log(f"[timing] {gpu}: bin_count [{BIN_ROWS}, {MED_N}] f32 from the "
        f"Gram, 4096 bins, first level: kernel "
        f"{bin_ms * 1e3:.2f} us ({bin_by}), plain {bin_plain * 1e3:.2f} us, "
        f"torch.bincount of the bin indices {bin_lib * 1e3:.2f} us")
    for shape, levels in bin_dev.items():
        log(f"[timing] {gpu}: bin_count {shape} f32, device us a launch: "
            f"first level {levels['first']}, a second level's interval "
            f"{levels['second']}, both middle ranks' second levels in one "
            f"launch {levels['both']}")
    # The data products at [main]'s, [large-n]'s and a 4-card shard's
    # shapes (data_product_timing). Then the gradient stage they feed
    # (_make_grad_all of the linear model's log_p) by device time, with the
    # data products and with torch.matmul in log_p (torch.func's batched
    # GEMV, the route before them), in turns.
    from stein_tpu_torch.models import linear_regression as lr_mod
    dp_t = data_product_timing(torch, gpu, dp_in)

    @contextlib.contextmanager
    def gemv_log_p():
        saved = lr_mod.matvec
        lr_mod.matvec = torch.matmul
        try:
            yield
        finally:
            lr_mod.matvec = saved

    def grad_stage(theta_, batch_):
        return lambda: grad_all(theta_, batch_)
    stage_us = {}
    for label, th_, b_ in (("main", theta, batch),
                           ("large-n", big.state.particles, lr_batch)):
        reps = 20 if label == "main" else 5
        with gemv_log_p():
            g1 = device_us(grad_stage(th_, b_), reps, torch)
        d1 = device_us(grad_stage(th_, b_), reps, torch)
        d2 = device_us(grad_stage(th_, b_), reps, torch)
        with gemv_log_p():
            g2 = device_us(grad_stage(th_, b_), reps, torch)
        stage_us[label] = ((d1, d2), (g1, g2))
        log(f"[timing] {gpu}: the gradient stage of [{label}] (n="
            f"{th_.shape[0]}), device us a call in turns: with the data "
            f"products {d1}, {d2}; with torch.func's batched GEMV "
            f"{g1}, {g2}")
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

    # Whole graph chunks: 2 (1 on the paths of 3 ms or more a step).
    one, two = graphs.CHUNK, 2 * graphs.CHUNK
    profile_split("main (fused_gram)", sampler, batch, two, torch, gpu)
    profile_split("main-nn", nn_sampler, nn_batch, two, torch, gpu)
    profile_split("main-nn-bf16", nn16, nn_batch, two, torch, gpu)
    profile_split("main-nn-large", nn_large, nn_batch, one, torch, gpu)
    profile_split("large-n", big, lr_batch, one, torch, gpu)
    for label, (s_, b_) in mesh_timed.items():
        profile_split(label, s_, b_, two, torch, gpu)
    for label, (s_, b_, _) in tail_timed.items():
        profile_split(label, s_, b_,
                      one if label == "large-n-epilogue" else two, torch,
                      gpu)
    profile_split("main-nn-pblock", pb_loop, pb_batch, 20, torch, gpu)
    profile_split("covertype-e2e", cov_loop, None, two, torch, gpu)
    profile_split("large-n-sym", sym_loops["B11"], None, 10, torch, gpu)
    for label, (s_, b_) in med_timed.items():
        profile_split(label, s_, b_, one, torch, gpu)

    # [graph]: every sampler path replayed from graphs against the eager
    # loop; the chunk length's capture time and step on [main].
    from stein_tpu_torch import InverseMultiquadricKernel
    graph_chunks(lambda: main_make("cuda"), batch, torch, gpu)

    def by_run(s_, b_):
        return lambda k, eager: (s_._eager("run", b_, k) if eager
                                 else s_.run(b_, k))
    # Steps a reading: whole chunks, 2 on the paths of 5 ms or more a
    # step eagerly, else 4.
    c2, c4 = 2 * graphs.CHUNK, 4 * graphs.CHUNK
    g_paths = {"main": (sampler, by_run(sampler, batch), c4),
               "main-nn": (nn_sampler, by_run(nn_sampler, nn_batch), c4),
               "main-nn-bf16": (nn16, by_run(nn16, nn_batch), c4),
               "main-nn-large": (nn_large, by_run(nn_large, nn_batch), c4),
               "large-n": (big, by_run(big, lr_batch), c2)}
    imq = main_make("cuda", kernel=InverseMultiquadricKernel())
    g_paths["kernel-imq"] = (imq, by_run(imq, batch), c4)
    for label, (s_, b_, _) in tail_timed.items():
        g_paths[label] = (s_, by_run(s_, b_),
                          c2 if label == "large-n-epilogue" else c4)
    cov = cov_loop.sampler
    g_paths["covertype-e2e"] = (cov, lambda k, eager: (
        cov._eager("train_minibatched", cov_loop.data, k, COV_BATCH, COV_KEY)
        if eager else cov_loop.run(None, k)), c4)
    for label, (s_, b_) in list(mesh_timed.items()) + list(med_timed.items()):
        g_paths[label] = (s_, by_run(s_, b_), c2)
    t_graph = time.perf_counter()
    graph_summary = run_graph_phase(g_paths, torch, gpu)
    for label in ("median-binned", "mesh-binned", "mesh-ring-binned"):
        s_, b_ = {**med_timed, **mesh_timed}[label]
        graph_summary[label].update(graph_size(label, s_, b_, torch, gpu))
    log(f"[graph] phase {time.perf_counter() - t_graph:.1f} s")

    total = {k: sum(c[k] for c in path_counts.values()) for k in counters}

    def dp_ms(t):
        """(ms, plain ms) of a data-product reading: the kernel's device
        time where device_us read it, else events; the plain version by
        events."""
        return (t[0] if t[2] is None else t[2] / 1e3), t[1]

    def dp_lib(t):
        return t[1] if t[3] is None else t[3] / 1e3

    def dp_by(t):
        return "events" if t[2] is None else "device"

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
            "stein_tpu/ops/pallas_svgd.py:217",
            max(tail_errs["B10"], b10_2d_err),
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
        # The bin count: one read of the [256, 10240] f32 Gram block and
        # its norms, the running histogram read and written; seven
        # operations an entry (D's add, product and subtraction; the
        # window's subtraction, division and two compares) on the CUDA
        # cores. No Pallas site: the JAX package's count is XLA's
        # scatter-add.
        row("bin_count, median='binned''s count", "bin_count",
            "bin_count.cu",
            "stein_tpu/ops/median.py:265 (XLA scatter-add; no Pallas "
            "kernel)", bin_err, bin_ms, bin_plain,
            sum(t.element_size() * t.numel() for t in bin_first[:3])
            + 2 * 4 * bin_first[-1], 7 * bin_first[0].numel(), bin_lib,
            ms_by=bin_by),
        # The data products at [main]'s shape: 2 n N p FLOP on the tensor
        # cores as three TF32 products each (3xTF32); bytes: the
        # particles' rows (or the residual rows) and the data matrix in,
        # the product out. No Pallas site: XLA forms the JAX models'
        # products. The library call is the plain version's one
        # torch.matmul (cuBLAS).
        *[row(f"{name}, the linear models' {what} folded", name,
              "data_product.cu",
              "none: jnp.matmul(batch['X'], w) under jax.vmap("
              "jax.value_and_grad) (stein_tpu/models/linear_regression.py:"
              "93, logistic_regression.py:163, stein_tpu/api.py:442; XLA, "
              "no Pallas kernel)", dp_err,
              *dp_ms(dp_t[name, (N, N_OBS, P)]),
              4 * (N * P + N_OBS * P + N * N_OBS), 0,
              dp_lib(dp_t[name, (N, N_OBS, P)]),
              tf32_ops=3 * 2 * N * N_OBS * P,
              ms_by=dp_by(dp_t[name, (N, N_OBS, P)]))
          for name, what in (("data_product", "X @ w"),
                             ("data_product_t", "X^T r"))],
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
    log(f"[result] graph {json.dumps(graph_summary)}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run():
    """main(), then the process group's end (its graphs freed first), so
    that the exit code is the script's own."""
    try:
        return main()
    finally:
        if "torch" in sys.modules:
            import torch.distributed as dist
            if dist.is_available() and dist.is_initialized():
                from stein_tpu_torch.utils import graphs

                graphs.release()
                dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--teardown"]:
        sys.exit(teardown_child(sys.argv[2]))
    if sys.argv[1:2] == ["--recovery"]:
        sys.exit(recovery_child(sys.argv[2]))
    sys.exit(run())
