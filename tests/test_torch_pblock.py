"""The B7 -> B12 slice as a whole: the JAX package's own loop for its p-blocked
tail (per step ``pallas_grads(interpret=True)`` then
``fused_warm_step_pblock(interpret=True)``, under ``jax.jit``) against the
port's (``BayesianNNModel.pallas_grads()`` then ``fused_warm_step_pblock``,
their plain versions on CPU tensors), on a small Bayesian NN.

The JAX loop runs two steps first (Adam's and Adagrad's first step divide by
|phi| and would amplify roundings, PERF.md §2); its state then crosses over
through ``state_from_numpy``, the port's loader of a JAX sampler's state, and
both loops run five more steps from it. Each step is held to the fused_gram
class: the mean log_p rtol 1e-5, the median rtol 5e-3, phi_norm rtol 1e-4,
the particles and the moments rtol 2e-4 / atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stein_tpu as sj
import stein_tpu_torch as st
from stein_tpu.models import BayesianNNModel as JNN
from stein_tpu.ops.pallas_step import fused_warm_step_pblock as j_pblock
from stein_tpu_torch.models import BayesianNNModel as TNN
from stein_tpu_torch.ops.fused_step import (
    fused_warm_step_pblock,
    pblock_step_fits,
)
from stein_tpu_torch.utils.convert import state_from_numpy


def _problem(n, f, H, B, seed=4):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(B, f))
    y = np.cos(10 * X[:, :1]) * (5 * X[:, :1]) + rng.normal(size=(B, 1)) * 0.1
    p = f * H + 2 * H + 3
    theta0 = rng.normal(size=(n, p)) * 0.1
    return (X.astype(np.float32), y.astype(np.float32),
            theta0.astype(np.float32))


@pytest.mark.parametrize("rule", ["Adam", "Adagrad"])
@pytest.mark.parametrize("n,f,H,B", [(96, 1, 6, 20), (130, 2, 5, 12)])
def test_pblock_loop_matches_jax(rule, n, f, H, B):
    X, y, theta0 = _problem(n, f, H, B)
    kw = dict(n_train=5 * B, n_batch=B, prior_beta=10.0)
    jm, tm = JNN(f, H, **kw), TNN(f, H, **kw)
    p = theta0.shape[1]
    assert pblock_step_fits(n, p)
    if rule == "Adam":
        jgd, tgd = (sj.Adam(learning_rate=0.1, decay=0.999),
                    st.Adam(learning_rate=0.1, decay=0.999))
    else:
        jgd, tgd = sj.Adagrad(learning_rate=0.05), st.Adagrad(
            learning_rate=0.05)
    jgrads = jm.pallas_grads(interpret=True)
    jb = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    tb = {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}

    @jax.jit
    def jstep(theta, opt, med):
        logp, grads = jgrads(theta, jb)
        theta, opt, (med, norm, h2) = j_pblock(theta, grads, med, opt, jgd,
                                               interpret=True)
        return theta, opt, (med, norm, h2), jnp.mean(logp)

    jth, jopt = jnp.asarray(theta0), jgd.init((n, p), jnp.float32)
    jmed = jnp.float32(0.0)
    for _ in range(2):
        jth, jopt, (jmed, _, _), _ = jstep(jth, jopt, jmed)

    state = state_from_numpy(
        np.asarray(jth), {k: np.asarray(v) for k, v in jopt._asdict().items()},
        2, device="cpu")
    tth, topt, tmed = state.particles, state.opt_state, torch.tensor(
        float(jmed))
    tgrads = tm.pallas_grads()
    for step in range(5):
        jth, jopt, jstats, jlp = jstep(jth, jopt, jmed)
        tlp, g = tgrads(tth, tb)
        tth, topt, tstats = fused_warm_step_pblock(tth, g, tmed, topt, tgd)
        jmed, tmed = jstats[0], tstats[0]
        np.testing.assert_allclose(tlp.mean().item(), float(jlp), rtol=1e-5)
        np.testing.assert_allclose(tstats[0].item(), float(jstats[0]),
                                   rtol=5e-3)
        np.testing.assert_allclose(tstats[1].item(), float(jstats[1]),
                                   rtol=1e-4)
        np.testing.assert_allclose(tth.numpy(), np.asarray(jth), rtol=2e-4,
                                   atol=1e-6, err_msg=f"step {step}")
        for tl, jl in zip(topt, jopt):
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       rtol=2e-4, atol=1e-6)
    assert int(topt.count) == 7
