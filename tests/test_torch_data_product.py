"""The linear models' data products through ops/data_product.py (MatVec,
MatTVec and their vmap rules) against the JAX package, on the same numpy
inputs: vmap(grad_and_value) of the port's log_p against
jax.vmap(jax.value_and_grad) of the JAX model's, every route through
_make_grad_all (plain, remat=True, the KSD score), the folded call counts,
and the errors, and the transpose's split plan (transpose_plan). On the CPU
the folded products run their plain versions;
the kernel's own checks are tests/test_torch_cuda.py's."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, grad_and_value, vmap

import stein_tpu as sj
import stein_tpu_torch as st
from stein_tpu.models import LinearRegressionModel as JLR
from stein_tpu.models import LogisticRegressionModel as JL
from stein_tpu.utils.ravel import template_unraveler as j_unraveler
from stein_tpu_torch.api import _make_grad_all
from stein_tpu_torch.models import LinearRegressionModel as TLR
from stein_tpu_torch.models import LogisticRegressionModel as TL
from stein_tpu_torch.ops import data_product as dp
from stein_tpu_torch.utils import graphs
from stein_tpu_torch.utils.ravel import template_unraveler as t_unraveler

# The reference-semantics class (ROADMAP C): the port against JAX in f32.
RTOL, ATOL = 1e-5, 1e-6
MODELS = ("lr-X", "lr-A", "logistic")


def _case(kind, n=48, n_obs=80, p=12, seed=0, dtype=np.float32):
    """(JAX model, port model, JAX batch, port batch, theta [n, p'])."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_obs, p)) * 0.25
    if kind == "logistic":
        y = (X @ rng.normal(size=(p, 1)) > 0).astype(np.float64)
        jm, tm = JL(p, 2 * n_obs, n_obs), TL(p, 2 * n_obs, n_obs)
        theta = rng.normal(size=(n, p + 1)) * 0.5
    else:
        y = X @ rng.normal(size=(p, 1)) + rng.normal(size=(n_obs, 1)) * 0.3
        jm, tm = JLR(p), TLR(p)
        theta = rng.normal(size=(n, p)) * 0.5
    X, y, theta = X.astype(dtype), y.astype(dtype), theta.astype(dtype)
    jb = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    tb = {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}
    if kind == "lr-A":
        jb = jm.sufficient_batch(jb, jnp.asarray(X).dtype)
        tb = tm.sufficient_batch(tb, tb["X"].dtype)
    return jm, tm, jb, tb, theta


def _jax_grads(jm, jb, theta):
    jdt = jnp.float64 if theta.dtype == np.float64 else jnp.float32
    _, unravel = j_unraveler(jm.template(jdt))
    fn = jax.vmap(jax.value_and_grad(lambda r: jm.log_p(unravel(r), jb)))
    v, g = fn(jnp.asarray(theta))
    return np.asarray(v), np.asarray(g)


def _port_grad_all(tm, remat=False, dtype=torch.float32):
    return _make_grad_all(tm.log_p, t_unraveler(tm.template(dtype))[1],
                          remat=remat)


@pytest.fixture
def folded_calls(monkeypatch):
    """Count the folded products' calls (each a launch on the card)."""
    calls = {"data_product": 0, "data_product_t": 0}
    for name in calls:
        fn = getattr(dp, name)

        def counted(*args, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(dp, name, counted)
    return calls


@pytest.mark.parametrize("kind", MODELS)
def test_grad_and_value_matches_jax(kind, folded_calls):
    """vmap(grad_and_value) of the port's log_p (MatVec's vmap rule, then
    MatTVec's as its backward) against the JAX model's vmapped
    value_and_grad at the reference-semantics class, in one folded call of
    each product."""
    jm, tm, jb, tb, theta = _case(kind)
    jv, jg = _jax_grads(jm, jb, theta)
    tv, tg = _port_grad_all(tm)(torch.from_numpy(theta), tb)
    assert folded_calls == {"data_product": 1, "data_product_t": 1}
    np.testing.assert_allclose(tv.numpy(), jv, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", MODELS)
def test_f64_matches_jax(kind):
    """The same in f64 at the JAX suite's model class (tests/
    test_models.py: rtol 1e-8)."""
    jm, tm, jb, tb, theta = _case(kind, n=16, dtype=np.float64, seed=3)
    jv, jg = _jax_grads(jm, jb, theta)
    tv, tg = _port_grad_all(tm, dtype=torch.float64)(
        torch.from_numpy(theta), tb)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-8)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("kind", MODELS)
def test_remat_equals_plain(kind, folded_calls):
    """remat=True (a plain vmap forward under torch.utils.checkpoint, then
    torch.autograd.grad: ordinary autograd records the vmap rule's folded
    MatVec and takes MatTVec as its backward) equals remat=False bitwise;
    the checkpoint runs the forward twice."""
    _, tm, _, tb, theta = _case(kind, seed=1)
    t = torch.from_numpy(theta)
    v0, g0 = _port_grad_all(tm)(t, tb)
    folded_calls.update(data_product=0, data_product_t=0)
    v1, g1 = _port_grad_all(tm, remat=True)(t, tb)
    assert folded_calls == {"data_product": 2, "data_product_t": 1}
    assert not v1.requires_grad and not g1.requires_grad
    assert torch.equal(v0, v1) and torch.equal(g0, g1)


def test_no_bmm_under_grad_all():
    """The models' log_p under _make_grad_all runs no aten::bmm (the
    per-particle GEMV that torch.func's vmap of torch.matmul lowers to)."""
    for kind in MODELS:
        _, tm, _, tb, theta = _case(kind, seed=2)
        grad_all = _port_grad_all(tm)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            grad_all(torch.from_numpy(theta), tb)
        names = {e.key for e in prof.key_averages()}
        assert "aten::bmm" not in names, (kind, sorted(names))
        assert "aten::mm" in names


@pytest.mark.parametrize("kind", ("lr-X", "lr-A"))
def test_ksd_matches_jax(kind, folded_calls):
    """SVGDSampler.ksd (scores by vmap(grad(log_p)), api.py's KSD route)
    against the JAX sampler's at tests/test_torch_diagnostics.py's f64
    class (rtol 1e-10), both statistics; each score call folds once."""
    jm, tm, jb, tb, theta = _case(kind, n=32, n_obs=40, p=3, seed=4,
                                  dtype=np.float64)
    js = sj.SVGDSampler(32, jm.log_p, jm.template(jnp.float64),
                        sj.Adam(1e-1), theta=jnp.asarray(theta),
                        dtype=jnp.float64)
    ts = st.SVGDSampler(32, tm.log_p, tm.template(torch.float64),
                        st.Adam(1e-1), theta=theta, dtype=torch.float64,
                        device="cpu")
    for u in (False, True):
        np.testing.assert_allclose(ts.ksd(tb, u_statistic=u),
                                   js.ksd(jb, u_statistic=u), rtol=1e-10)
    assert folded_calls == {"data_product": 2, "data_product_t": 2}


def test_single_particle_and_nested_vmap():
    """MatVec outside vmap (w [p] and [p, 1]) and under two vmaps (the
    rule folds both axes into one call), and grad of each, against
    torch.matmul."""
    rng = np.random.default_rng(5)
    M = torch.from_numpy(rng.normal(size=(20, 6)))
    W = torch.from_numpy(rng.normal(size=(3, 4, 6)))

    def f(w):
        return torch.sum(torch.sin(dp.matvec(M, w)))

    def ref(w):
        return torch.sum(torch.sin(torch.matmul(M, w)))
    for w in (W[0, 0], W[0, 0].reshape(6, 1)):
        torch.testing.assert_close(dp.matvec(M, w), torch.matmul(M, w),
                                   rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(grad(f)(w), grad(ref)(w), rtol=1e-12,
                                   atol=1e-12)
    got = vmap(vmap(grad_and_value(f)))(W)
    want = vmap(vmap(grad_and_value(ref)))(W)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_errors():
    """A batched data matrix raises under vmap (no fallback); wrong widths,
    a data matrix that wants a gradient and a dtype mismatch raise."""
    M = torch.randn(5, 3)
    with pytest.raises(ValueError, match="data matrix is batched"):
        vmap(dp.matvec)(torch.randn(2, 5, 3), torch.randn(2, 3))
    with pytest.raises(ValueError, match="data matrix is batched"):
        vmap(dp.matvec, in_dims=(0, None))(torch.randn(2, 5, 3),
                                          torch.randn(3))
    with pytest.raises(ValueError, match="contraction of 3"):
        dp.matvec(M, torch.randn(4))
    with pytest.raises(ValueError, match="contraction of 3"):
        dp.matvec(M, torch.randn(3, 2))
    with pytest.raises(ValueError, match="takes no gradient"):
        dp.matvec(M.requires_grad_(), torch.randn(3))
    with pytest.raises(TypeError, match="data matrix is torch.float64"):
        dp.data_product(torch.randn(5, 3, dtype=torch.float64),
                        torch.randn(2, 3))
    with pytest.raises(ValueError, match="rows of width 4"):
        dp.data_product_t(torch.randn(5, 3), torch.randn(2, 4))


def test_plain_versions_and_registry():
    """The folded products on CPU tensors are their plain versions
    (torch.matmul of the folded operands) and launch nothing; both are
    in the graph driver's registry of launch counts."""
    rng = np.random.default_rng(6)
    M = torch.from_numpy(rng.normal(size=(30, 7)).astype(np.float32))
    W = torch.from_numpy(rng.normal(size=(9, 7)).astype(np.float32))
    R = torch.from_numpy(rng.normal(size=(9, 30)).astype(np.float32))
    before = graphs.read_counts()
    assert torch.equal(dp.data_product(M, W), torch.matmul(W, M.T))
    assert torch.equal(dp.data_product_t(M, R), torch.matmul(R, M))
    assert graphs.read_counts() == before
    reg = graphs.launch_counters()
    assert reg["data_product"] == (dp.data_product, "launches")
    assert reg["data_product_t"] == (dp.data_product_t, "launches")


@pytest.mark.parametrize("N", [0, 1, 31, 32, 50, 54, 55, 128, 129, 257, 999,
                               1000, 1024, 1025, 4096, 464809])
def test_transpose_plan(N):
    """G = R M's split of its contraction (the kernel's clusters): a
    function of N alone, 1 to 8 chunks that cover [0, N) in order, none
    empty, each but the last a multiple of the kernel's 32-index runs (so
    every run starts at a multiple of 32 from 0). N = 1000 is 8 chunks."""
    assert list(inspect.signature(dp.transpose_plan).parameters) == ["N"]
    S, chunk = dp.transpose_plan(N)
    assert (S, chunk) == dp.transpose_plan(N)
    assert 1 <= S <= 8 and chunk > 0 and chunk % 32 == 0
    bounds = [(j * chunk, min(N, (j + 1) * chunk)) for j in range(S)]
    assert bounds[0][0] == 0 and bounds[-1][1] == N
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(hi > lo for lo, hi in bounds) or (N == 0 and S == 1)
    assert all((hi - lo) % 32 == 0 for lo, hi in bounds[:-1])
    if N == 1000:
        assert (S, chunk) == (8, 128)
        assert [hi - lo for lo, hi in bounds] == [128] * 7 + [104]
