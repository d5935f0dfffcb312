"""Kernel B1's plain version (stein_tpu_torch/ops/fused_step.py,
fused_warm_step_tail(gram_in_kernel=True) on CPU tensors) against the JAX
tail (stein_tpu/ops/pallas_step.py) in interpret mode, from the same theta,
gradients, optimizer state and med_prev."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stein_tpu.ops import optimizers as jopt
from stein_tpu.ops.median import subsample_rows as j_subsample_rows
from stein_tpu.ops.pallas_step import fused_warm_step_tail as j_tail
from stein_tpu_torch.ops import optimizers as topt
from stein_tpu_torch.ops.fused_step import fused_warm_step_tail as t_tail
from stein_tpu_torch.ops.median import subsample_rows as t_subsample_rows

N, P = 64, 8

# rtol 1e-5: D comes from two different f32 dot orders (XLA's and torch's),
# so the medians are close, not bitwise; theta, the moments and the stats
# inherit that and the exp2/pow evaluations. atol 1e-7 covers entries that
# cancel to near zero.
RTOL, ATOL = 1e-5, 1e-7


def _inputs(rule, seed=0):
    rng = np.random.default_rng(seed)
    theta = (rng.normal(size=(N, P)) * 0.3 + 1.5).astype(np.float32)
    grads = rng.normal(size=(N, P)).astype(np.float32)
    if rule == "Adam":
        opt = dict(mu=rng.normal(size=(N, P)) * 0.1,
                   nu=rng.uniform(0.01, 0.1, size=(N, P)),
                   count=np.int32(3), learning_rate=np.float32(0.05))
    else:
        opt = dict(hist=rng.uniform(0.01, 0.1, size=(N, P)),
                   count=np.int32(3), learning_rate=np.float32(0.05))
    opt = {k: np.asarray(v, np.int32 if k == "count" else np.float32)
           for k, v in opt.items()}
    return theta, grads, opt


def _rules(rule):
    if rule == "Adam":
        kw = dict(learning_rate=0.05, decay=0.999)
        return (jopt.Adam(**kw), jopt.AdamState, topt.Adam(**kw),
                topt.AdamState)
    kw = dict(learning_rate=0.05)
    return (jopt.Adagrad(**kw), jopt.AdagradState, topt.Adagrad(**kw),
            topt.AdagradState)


@pytest.mark.parametrize("rule", ["Adam", "Adagrad"])
@pytest.mark.parametrize("max_rows", [None, 16])
def test_tail_matches_jax(rule, max_rows):
    theta, grads, opt = _inputs(rule)
    jgd, JState, tgd, TState = _rules(rule)
    js = JState(**{k: jnp.asarray(v) for k, v in opt.items()})
    ts = TState(**{k: torch.from_numpy(np.array(v)) for k, v in opt.items()})
    jth, tth = jnp.asarray(theta), torch.from_numpy(theta)
    rows_j = None if max_rows is None else j_subsample_rows(jth, max_rows)
    rows_t = None if max_rows is None else t_subsample_rows(tth, max_rows)
    # A hint near the block's median, so the tight bracket is verified.
    med_prev = np.float32(np.median(
        ((theta[:, None] - theta[None]) ** 2).sum(-1)) * 1.01)
    j_out = j_tail(jth, jnp.asarray(grads), None, None,
                   jnp.float32(med_prev), js, jgd, max_phi_norm=10.0,
                   warm_passes=8, gram_in_kernel=True, theta_sub=rows_j,
                   interpret=True)
    t_out = t_tail(tth, torch.from_numpy(grads), None, None,
                   torch.tensor(med_prev), ts, tgd, max_phi_norm=10.0,
                   warm_passes=8, gram_in_kernel=True, theta_sub=rows_t)
    (jt, jst, jstats), (tt, tst, tstats) = j_out, t_out
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), RTOL, ATOL)
    for tl, jl in zip(tst, jst):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), RTOL, ATOL)
    for tl, jl in zip(tstats, jstats):   # med, phi_norm, h2
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), RTOL, ATOL)


def test_tail_refuses_other_step_rules():
    class Sgd:
        def init(self, shape, dtype=torch.float32, device=None):
            return topt.AdagradState(torch.zeros(shape),
                                     torch.zeros((), dtype=torch.int32),
                                     torch.tensor(0.1))

        def update(self, state, phi):
            return -0.1 * phi, state

    theta = torch.zeros(8, 2)
    with pytest.raises(TypeError, match="Adam and Adagrad"):
        t_tail(theta, theta, None, None, 0.0, Sgd().init((8, 2)), Sgd(),
               gram_in_kernel=True)


def test_tail_guards():
    theta = torch.zeros(8, 2)
    gd = topt.Adam()
    state = gd.init((8, 2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_tail(theta, theta, None, None, 0.0, state, gd)
    with pytest.raises(ValueError, match="computes D inside"):
        t_tail(theta, theta, theta, None, 0.0, state, gd,
               gram_in_kernel=True)
    with pytest.raises(TypeError, match="f32"):
        t_tail(theta.double(), theta.double(), None, None, 0.0, state, gd,
               gram_in_kernel=True)
    huge = torch.zeros(1, 1).expand(2 ** 16, 2)
    with pytest.raises(ValueError, match="int32"):
        t_tail(torch.zeros(1, 1).expand(2 ** 15 + 1, 2), None, None, None,
               0.0, state, gd, gram_in_kernel=True, theta_sub=huge)
