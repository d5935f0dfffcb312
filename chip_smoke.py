#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (stein_tpu_torch) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from csrc/, checks each against its
plain PyTorch version on the card, drives the main path
(SVGDSampler(1000, ..., device="cuda", **throughput_config(1000, 128)) then
run(batch, 500), on the bench's p=128 Bayesian linear regression), checks
the result, and times the step and the kernels. Phases:

  1. device   the card's name and power limit (nvidia-smi), the TF32 flags
  2. build    nvcc of csrc/ into build/stein_tpu_torch/, its seconds
  3. kernels  B2 bitwise against its plain version (cold and warm); B1's
              launch chain against the plain tail, at the stated tolerances
  4. main     launch counts of the run, finiteness, the first 10 steps
              against the CPU run, the posterior mean against the conjugate
              closed form
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
    from stein_tpu_torch.models import LinearRegressionModel
    from stein_tpu_torch.ops import fused_median, fused_step
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
        if "registers" in line or "Compiling entry" in line:
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
    cold_k = fused_median.fused_warm_median_rows(D_sub, zero, 30)
    cold_p = fused_median.warm_search_on_value(D_sub, zero, 30)
    warm_k = fused_median.fused_warm_median_rows(D_sub, cold_p * 1.01, 8)
    warm_p = fused_median.warm_search_on_value(D_sub, cold_p * 1.01, 8)
    torch.cuda.synchronize()
    b2_err = max(abs(cold_k.item() - cold_p.item()),
                 abs(warm_k.item() - warm_p.item()))
    log(f"[kernels] B2 [{MEDIAN_ROWS}, {N}] cold {cold_k.item()!r} vs "
        f"{cold_p.item()!r}, warm {warm_k.item()!r} vs {warm_p.item()!r}")
    if cold_k.item() != cold_p.item() or warm_k.item() != warm_p.item():
        fail("B2 is not bitwise equal to its plain version")

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

    # ------------------------------------------------------ 4. main path
    kw = throughput_config(N, P)
    log(f"[main] throughput_config({N}, {P}) = "
        f"{ {k: str(v) for k, v in kw.items()} }")
    sampler = SVGDSampler(N, model.log_p, model.template(), Adam(1e-1),
                          theta=theta0, device="cuda", **kw)
    fused_median.fused_warm_median_rows.launches = 0
    fused_step.fused_warm_step_tail.launches = 0
    t0 = time.perf_counter()
    aux = sampler.run(batch, STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"B2": fused_median.fused_warm_median_rows.launches,
                "B1": fused_step.fused_warm_step_tail.launches}
    log(f"[main] run(batch, {STEPS}) in {wall:.2f} s (first call), "
        f"launches {launches}")
    if launches != {"B2": 1, "B1": STEPS}:
        fail(f"launch counts {launches}, expected B2 1, B1 {STEPS}")
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

    kernels = [
        {"name": "warm_median (B2)", "route": "cuda",
         "source": "stein_tpu_torch/csrc/warm_search.cuh",
         "replaces": "stein_tpu/ops/pallas_median.py:85",
         "launches": launches["B2"], "max_abs_err": b2_err,
         "ms": b2_ms, "plain_ms": b2_plain},
        {"name": "fused_step_tail (B1)", "route": "cuda",
         "source": "stein_tpu_torch/csrc/stein_kernels.cu",
         "replaces": "stein_tpu/ops/pallas_step.py:92",
         "launches": launches["B1"], "max_abs_err": b1_err,
         "ms": b1_ms, "plain_ms": b1_plain},
    ]
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
