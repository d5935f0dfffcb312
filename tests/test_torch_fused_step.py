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
    state = gd.init((8, 2), device="cpu")
    with pytest.raises(ValueError, match="searches a given D"):
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


def _pair_states(rule, opt):
    jgd, JState, tgd, TState = _rules(rule)
    return (jgd, JState(**{k: jnp.asarray(v) for k, v in opt.items()}),
            tgd, TState(**{k: torch.from_numpy(np.array(v))
                           for k, v in opt.items()}))


def _assert_tail_close(t_out, j_out):
    (tt, tst, tstats), (jt, jst, jstats) = t_out, j_out
    assert len(tstats) == len(jstats)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), RTOL, ATOL)
    for tl, jl in zip(tst, jst):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), RTOL, ATOL)
    for tl, jl in zip(tstats, jstats):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), RTOL, ATOL)


def _glm_operands(seed=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(40, P)).astype(np.float32)
    A = (X.T @ X + np.eye(P)).astype(np.float32)
    b = (X.T @ rng.normal(size=(40,))).astype(np.float32)
    return A, b


@pytest.mark.parametrize("rule", ["Adam", "Adagrad"])
@pytest.mark.parametrize("max_rows", [None, 16])
def test_glm_tail_matches_jax(rule, max_rows):
    """B1 with its glm stage (glm=(A_eff, b_eff), grads=None) against the
    JAX tail in interpret mode; the fourth stat is the mean log_p."""
    theta, _, opt = _inputs(rule, seed=2)
    theta = (theta - 1.5) * 0.2
    A, b = _glm_operands()
    jgd, js, tgd, ts = _pair_states(rule, opt)
    jth, tth = jnp.asarray(theta), torch.from_numpy(theta)
    rows_j = None if max_rows is None else j_subsample_rows(jth, max_rows)
    rows_t = None if max_rows is None else t_subsample_rows(tth, max_rows)
    j_out = j_tail(jth, None, None, None, jnp.float32(0.0), js, jgd,
                   gram_in_kernel=True, theta_sub=rows_j, interpret=True,
                   glm=(jnp.asarray(A), jnp.asarray(b)))
    t_out = t_tail(tth, None, None, None, 0.0, ts, tgd, gram_in_kernel=True,
                   theta_sub=rows_t,
                   glm=(torch.from_numpy(A), torch.from_numpy(b)))
    assert len(t_out[2]) == 4
    _assert_tail_close(t_out, j_out)


@pytest.mark.parametrize("rule", ["Adam", "Adagrad"])
def test_logistic_model_tail_matches_jax(rule):
    """B1 with the logistic stage (model=inkernel_model(batch))."""
    from stein_tpu.models import LogisticRegressionModel as JL
    from stein_tpu_torch.models import LogisticRegressionModel as TL

    d, n_obs = P - 1, 30
    rng = np.random.default_rng(4)
    X = rng.normal(size=(n_obs, d)).astype(np.float32)
    y = (X @ rng.normal(size=(d, 1)) > 0).astype(np.float32)
    theta = (rng.normal(size=(N, P)) * 0.3).astype(np.float32)
    _, _, opt = _inputs(rule)
    jgd, js, tgd, ts = _pair_states(rule, opt)
    jk = JL(d, 300, n_obs).inkernel_model({"X": jnp.asarray(X),
                                           "y": jnp.asarray(y)})
    tk = TL(d, 300, n_obs).inkernel_model({"X": torch.from_numpy(X),
                                           "y": torch.from_numpy(y)})
    jth, tth = jnp.asarray(theta), torch.from_numpy(theta)
    j_out = j_tail(jth, None, None, None, jnp.float32(0.0), js, jgd,
                   gram_in_kernel=True, theta_sub=j_subsample_rows(jth, 16),
                   interpret=True, model=jk)
    t_out = t_tail(tth, None, None, None, 0.0, ts, tgd, gram_in_kernel=True,
                   theta_sub=t_subsample_rows(tth, 16), model=tk)
    _assert_tail_close(t_out, j_out)


@pytest.mark.parametrize("rule", ["Adam", "Adagrad"])
@pytest.mark.parametrize("max_rows", [None, 16])
def test_d_given_tail_matches_jax(rule, max_rows):
    """B1's D-given branch (gram_in_kernel=False, step_impl='fused'): the
    same D and strided block to both, tc = theta uncentred."""
    from stein_tpu.ops.median import _strided_rows as j_strided
    from stein_tpu.ops.rbf import pairwise_sq_dists as j_dists
    from stein_tpu_torch.ops.median import _strided_rows as t_strided

    theta, grads, opt = _inputs(rule, seed=3)
    jgd, js, tgd, ts = _pair_states(rule, opt)
    D = np.array(j_dists(jnp.asarray(theta)))
    jD, tD = jnp.asarray(D), torch.from_numpy(D)
    rows = N if max_rows is None else max_rows
    j_sub, t_sub = j_strided(jD, rows), t_strided(tD, rows)
    assert (t_sub is tD) == (max_rows is None)
    med_prev = np.float32(np.median(D) * 0.97)
    j_out = j_tail(jnp.asarray(theta), jnp.asarray(grads), jD, j_sub,
                   jnp.float32(med_prev), js, jgd, interpret=True)
    t_out = t_tail(torch.from_numpy(theta), torch.from_numpy(grads), tD,
                   t_sub, torch.tensor(med_prev), ts, tgd)
    _assert_tail_close(t_out, j_out)


def test_quadratic_form_matches_jax():
    """LinearRegressionModel.quadratic_form on both batch forms, at rtol
    1e-5 (X^T X and X^T y are f32 sums of 50 products in other orders)."""
    from stein_tpu.models import LinearRegressionModel as JM
    from stein_tpu_torch.models import LinearRegressionModel as TM

    rng = np.random.default_rng(6)
    X = rng.normal(size=(50, P)).astype(np.float32)
    y = rng.normal(size=(50, 1)).astype(np.float32)
    jm, tm = JM(P), TM(P)
    jb = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    tb = {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}
    for jbatch, tbatch in ((jb, tb), (jm.sufficient_batch(jb),
                                      tm.sufficient_batch(tb))):
        jA, jbv, jc = jm.quadratic_form(jbatch)
        tA, tbv, tc = tm.quadratic_form(tbatch)
        assert tA.shape == (P, P) and tbv.shape == (P,)
        np.testing.assert_allclose(tA.numpy(), np.asarray(jA), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(tbv.numpy(), np.asarray(jbv), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(float(tc), float(jc), rtol=1e-6)


@pytest.mark.parametrize("rule", ["Adam", "Adagrad"])
def test_fused_epilogue_matches_jax(rule):
    """B6's plain version against stein_tpu.ops.pallas_step.fused_epilogue
    in interpret mode (tests/test_pallas_step.py:319's inputs and rtol
    2e-6 / atol 1e-7), with a ragged row block on the JAX side."""
    from stein_tpu.ops.pallas_step import fused_epilogue as j_epi
    from stein_tpu_torch.ops.fused_step import fused_epilogue as t_epi

    n, p = 40, 6
    rng = np.random.default_rng(3)
    theta = rng.normal(size=(n, p)).astype(np.float32)
    ku = rng.normal(size=(n, p)).astype(np.float32)
    ksum = rng.uniform(1.0, 2.0, size=(n, 1)).astype(np.float32)
    center = theta.mean(0, keepdims=True)
    phi = (ku + ksum * (theta - center) / np.float32(0.7)) / n
    norm = np.float32(np.sqrt((phi * phi).sum()) * 0.5)  # clip active
    if rule == "Adam":
        opt = dict(mu=rng.normal(size=(n, p)) * 0.1,
                   nu=rng.uniform(0.01, 0.1, size=(n, p)),
                   count=np.int32(2), learning_rate=np.float32(0.1))
    else:
        opt = dict(hist=rng.uniform(0.01, 0.1, size=(n, p)),
                   count=np.int32(2), learning_rate=np.float32(0.1))
    opt = {k: np.asarray(v, np.int32 if k == "count" else np.float32)
           for k, v in opt.items()}
    jgd, js, tgd, ts = _pair_states(rule, opt)
    for max_norm in (10.0, 1e-3):
        jt, jst = j_epi(jnp.asarray(ku), jnp.asarray(ksum),
                        jnp.asarray(theta), jnp.asarray(center),
                        jnp.float32(0.7), jnp.float32(norm), js, jgd,
                        max_phi_norm=max_norm, block_rows=16, interpret=True)
        tt, tst = t_epi(torch.from_numpy(ku), torch.from_numpy(ksum),
                        torch.from_numpy(theta), torch.from_numpy(center),
                        torch.tensor(0.7), torch.tensor(norm), ts, tgd,
                        max_phi_norm=max_norm)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=2e-6,
                                   atol=1e-7)
        for tl, jl in zip(tst, jst):
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-6,
                                       atol=1e-7)


def test_model_and_epilogue_guards():
    from stein_tpu_torch.ops.fused_step import InKernelModel, fused_epilogue

    theta = torch.zeros(8, 2)
    gd = topt.Adam()
    state = gd.init((8, 2), device="cpu")
    A, b = torch.eye(2), torch.zeros(2)
    with pytest.raises(ValueError, match="not both"):
        t_tail(theta, None, None, None, 0.0, state, gd, gram_in_kernel=True,
               glm=(A, b), model=InKernelModel((A,), None))
    with pytest.raises(ValueError, match="A_eff shape"):
        t_tail(theta, None, None, None, 0.0, state, gd, gram_in_kernel=True,
               glm=(torch.eye(3), b))
    with pytest.raises(ValueError, match="gram_in_kernel=True"):
        t_tail(theta, None, None, None, 0.0, state, gd, glm=(A, b))
    with pytest.raises(ValueError, match="theta_sub"):
        t_tail(theta, theta, theta @ theta.T, theta @ theta.T, 0.0, state,
               gd, theta_sub=theta)
    unknown = InKernelModel((A, b.reshape(1, 2)), lambda t, *ops: None)
    with pytest.raises(TypeError, match="LogisticGrad"):
        t_tail(theta, None, None, None, 0.0, state, gd, gram_in_kernel=True,
               model=unknown)

    class Sgd(topt.Adagrad):
        pass

    with pytest.raises(TypeError, match="Adam and Adagrad"):
        fused_epilogue(theta, torch.ones(8, 1), theta, torch.zeros(1, 2),
                       1.0, 1.0, Sgd().init((8, 2), device="cpu"), Sgd())
    with pytest.raises(TypeError, match="f32"):
        fused_epilogue(theta.double(), torch.ones(8, 1), theta,
                       torch.zeros(1, 2), 1.0, 1.0, state, gd)


# ------------------------------------------------------------------ B12

def _eps_regime(rule, phi1, lr):
    """Where the first step's slope in phi exceeds 10, so that no bound on
    the new theta follows from a bound on phi (PERF.md §2's rule): Adam's
    first step is lr (phi / (1 - b1)) / (eps + |phi| / sqrt(1 - b2)),
    Adagrad's lr phi / (eps + |phi|)."""
    a = np.abs(phi1)
    if rule == "Adam":
        slope = lr / 0.1 * 1e-8 / (1e-8 + a / np.sqrt(1e-3)) ** 2
    else:
        slope = lr * 1e-6 / (1e-6 + a) ** 2
    return slope > 10


@pytest.mark.parametrize("rule", ["Adam", "Adagrad"])
def test_pblock_matches_jax(rule):
    """B12's plain version against the JAX package's fused_warm_step_pblock
    in interpret mode at its own test's shape (n=256, p=300: p not a
    multiple of the 128-column tile, warm_passes=16), from a fresh
    optimizer state, cold (med_prev 0) and warm (1.01 x the cold median).
    The median searches all n^2 entries by integer counts, so it is
    bitwise; phi_norm rtol 1e-5; the first clipped phi (Adam's mu, the
    square root of Adagrad's history) and theta at the fused_gram class
    (rtol 2e-4 / atol 1e-6), theta outside the first step's eps regime."""
    from stein_tpu.ops.pallas_step import fused_warm_step_pblock as j_pblock
    from stein_tpu_torch.ops.fused_step import fused_warm_step_pblock

    rng = np.random.default_rng(0)
    n, p = 256, 300
    theta = (rng.normal(size=(n, p)) * 0.5 + 1.0).astype(np.float32)
    grads = rng.normal(size=(n, p)).astype(np.float32)
    lr = 0.1
    if rule == "Adam":
        jgd, tgd = jopt.Adam(lr, decay=0.999), topt.Adam(lr, decay=0.999)
    else:
        jgd, tgd = jopt.Adagrad(lr), topt.Adagrad(lr)
    med_prev = 0.0
    for kind in ("cold", "warm"):
        jout = j_pblock(jnp.asarray(theta), jnp.asarray(grads),
                        jnp.float32(med_prev), jgd.init((n, p), jnp.float32),
                        jgd, warm_passes=16, p_tile=128, interpret=True)
        tout = fused_warm_step_pblock(
            torch.from_numpy(theta), torch.from_numpy(grads),
            torch.tensor(med_prev, dtype=torch.float32),
            tgd.init((n, p), device="cpu"), tgd, warm_passes=16)
        (jt, jst, jstats), (tt, tst, tstats) = jout, tout
        assert tstats[0].item() == float(jstats[0]), kind
        assert tstats[2].item() == float(jstats[2]), kind
        np.testing.assert_allclose(tstats[1].item(), float(jstats[1]),
                                   rtol=1e-5)
        if rule == "Adam":
            jphi, tphi = np.asarray(jst.mu), tst.mu.numpy()
        else:
            jphi, tphi = np.sqrt(np.asarray(jst.hist)), tst.hist.sqrt().numpy()
        np.testing.assert_allclose(tphi, jphi, rtol=2e-4, atol=1e-6)
        ill = _eps_regime(rule, jphi, lr)
        # Adam's regime (|phi| < ~1e-6) holds 1e-4 of the coordinates here,
        # Adagrad's (eps 1e-6: |phi| < ~1e-4) 1.4%, where theta parts by up
        # to 2.5e-4 (measured; 2.4e-7 outside it).
        assert ill.mean() < 2e-2, (kind, ill.sum())
        np.testing.assert_allclose(tt.numpy()[~ill], np.asarray(jt)[~ill],
                                   rtol=2e-4, atol=1e-6)
        assert int(tst.count) == int(jst.count) == 1
        np.testing.assert_allclose(tst.learning_rate.numpy(),
                                   np.asarray(jst.learning_rate), rtol=1e-7)
        med_prev = float(jstats[0]) * 1.01


@pytest.mark.parametrize("n,p,p_tile", [
    (1000, 303, 128), (1000, 128, 128), (1200, 303, 128), (1500, 128, 128),
    (256, 300, 64), (1600, 64, 32), (100, 1000, 128),
])
def test_pblock_step_fits_matches_jax(n, p, p_tile):
    from stein_tpu.ops.pallas_step import pblock_step_fits as j_fits
    from stein_tpu_torch.ops.fused_step import pblock_step_fits

    assert pblock_step_fits(n, p, p_tile) == j_fits(n, p, p_tile)


def test_pblock_guards():
    from stein_tpu_torch.ops.fused_step import fused_warm_step_pblock as pb

    theta = torch.zeros(8, 2)
    gd = topt.Adam()
    state = gd.init((8, 2), device="cpu")
    with pytest.raises(TypeError, match="f32"):
        pb(theta.double(), theta, 0.0, state, gd)
    with pytest.raises(TypeError, match="f32"):
        pb(theta, theta.double(), 0.0, state, gd)
    big = torch.zeros(1, 1).expand(46341, 2)   # 46341^2 >= 2^31
    with pytest.raises(ValueError, match="int32"):
        pb(big, big, 0.0, state, gd)
    with pytest.raises(ValueError, match=r"array\s+leaves are \[n, p\]"):
        pb(theta, theta, 0.0, gd.init((8, 3), device="cpu"), gd)
    with pytest.raises(ValueError, match="grads"):
        pb(theta, torch.zeros(8, 3), 0.0, state, gd)

    class Sgd(topt.Adagrad):
        pass

    with pytest.raises(TypeError, match="Adam and Adagrad"):
        pb(theta, theta, 0.0, Sgd().init((8, 2), device="cpu"), Sgd())
    with pytest.raises(ValueError, match="no kernel"):
        pb(theta.to("meta"), theta.to("meta"), 0.0,
           gd.init((8, 2), device="meta"), gd)


def test_pblock_p_tile_parity():
    """p_tile is accepted for parity: any positive value gives the same
    step, and a value the JAX function could not tile by raises."""
    from stein_tpu_torch.ops.fused_step import fused_warm_step_pblock as pb

    rng = np.random.default_rng(4)
    theta = torch.tensor(rng.normal(size=(40, 12)), dtype=torch.float32)
    grads = torch.tensor(rng.normal(size=(40, 12)), dtype=torch.float32)
    gd = topt.Adam(0.1)
    a = pb(theta, grads, 0.0, gd.init((40, 12), device="cpu"), gd)
    b = pb(theta, grads, 0.0, gd.init((40, 12), device="cpu"), gd, p_tile=8)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))
    with pytest.raises(ValueError, match="p_tile must be positive"):
        pb(theta, grads, 0.0, gd.init((40, 12), device="cpu"), gd, p_tile=0)
