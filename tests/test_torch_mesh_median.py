"""The port's sharded medians (ops/median.py's sharded half) and the bracket
passes B8 and B9 (ops/fused_median.py) against the JAX package's, on the
same numpy inputs in f32. The port's searches run on a one-process gloo
group, JAX's under shard_map on a 1-device mesh (or on 4 of the 8 fake CPU
devices); on the same D block they agree bitwise (integer counts, order-free
min/max, the same f32 scalar expression tree). B8's and B9's plain versions
are held to JAX's kernels in interpret mode: bitwise on lattice particles,
where D is exact in any summation order, and D to rtol 1e-5 otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_mesh_runner as R
from stein_tpu.ops import median as jmed
from stein_tpu.ops import pallas_median as jpm
from stein_tpu.parallel import particle_mesh as jax_mesh
from stein_tpu_torch.ops import fused_median as tfm
from stein_tpu_torch.ops import median as tmed
from stein_tpu_torch.parallel.mesh import ParticleMesh

BR = jmed.DEFAULT_BRACKETS


@pytest.fixture(scope="module")
def mesh1():
    with R.one_process_mesh() as mesh:
        yield mesh


def _shard_map(fn, world=1):
    """fn under shard_map on `world` devices, every input and the output
    replicated."""
    return jax.jit(jax.shard_map(fn, mesh=jax_mesh(jax.devices()[:world]),
                                 in_specs=P(), out_specs=P(),
                                 check_vma=False))


def _lattice(n, p, seed=1):
    half = np.random.default_rng(seed).integers(-3, 4, size=(n // 2, p))
    return np.concatenate([half, -half]).astype(np.float32)


def _inputs(kind, m=32, n=200, p=7, seed=3):
    """(rows [m, p], cols [n, p], center [1, p]) as numpy f32."""
    if kind == "lattice":
        cols = _lattice(n, p, seed)
    else:
        cols = (np.random.default_rng(seed).normal(size=(n, p)) * 0.3
                + 2.0).astype(np.float32)
    rows = cols[:: n // m][:m]
    return rows, cols, cols.mean(0, keepdims=True).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(np.asarray(a)) for a in arrays]


F32 = np.finfo(np.float32)


def _edges_ieee(med, hib, brackets, g1):
    """The JAX package's grid_edges expression tree in numpy f32: one IEEE
    rounding an operation, subnormals kept (as on the card)."""
    f = np.float32
    with np.errstate(all="ignore"):
        cands = [(f(lo) * med, f(hi) * med) for lo, hi in brackets]
        cands.append((f(-1e-6) * (f(1.0) + hib), hib))
        out = []
        for lo, hi in cands:
            w = (hi - lo) / f(g1)
            out += [lo + f(t) * w for t in range(g1 + 1)]
    return np.array(out, dtype=np.float32)


def _flush(x):
    """x with subnormals replaced by a zero of their sign."""
    x = np.asarray(x, dtype=np.float32)
    return np.where(np.abs(x) < F32.tiny, np.copysign(np.float32(0), x), x)


@pytest.mark.parametrize("g1", [1, 3, 8, 16])
@pytest.mark.parametrize("med,hib", [
    (0.0, 5.0), (0.731, 3.3), (2.5e-3, 1.7e-2), (13.0, 40.0), (0.0, 0.0),
    (F32.smallest_subnormal, 7 * F32.smallest_subnormal), (2.5e-39, 1e-38),
    (F32.smallest_subnormal, F32.max), (1e30, 3e38),
    (0.731, 0.99 * F32.max), (0.5 * F32.max, F32.max)])
def test_grid_edges_bitwise(g1, med, hib):
    """The port's grid_edges (and so B9's in-kernel edges, held to it on the
    card) against the JAX package's, bitwise as int32, down to the NaN of
    an inf - inf at the f32 range's end. XLA's CPU backend runs with
    subnormals flushed to zero, the card and torch do not: at subnormal
    inputs the port is held to the JAX expression tree in IEEE f32, and
    JAX's values to the port's on flushed inputs, flushed."""
    med, hib = np.float32(med), np.float32(hib)
    got = tfm.grid_edges(*_t(med, hib), BR, g1).numpy()
    want = np.asarray(jnp.stack(jpm.grid_edges(*_j(med, hib), BR, g1)))
    assert got.shape == ((len(BR) + 1) * (g1 + 1),)
    np.testing.assert_array_equal(got.view(np.int32),
                                  _edges_ieee(med, hib, BR, g1).view(np.int32))
    if _flush(med) == med and _flush(hib) == hib:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    else:
        flushed = tfm.grid_edges(*_t(_flush(med), _flush(hib)), BR, g1)
        np.testing.assert_array_equal(_flush(flushed.numpy()).view(np.int32),
                                      want.view(np.int32))


def _med_of(D, hint):
    return np.float32(np.median(D) * hint)


@pytest.mark.parametrize("kind", ["lattice", "normal"])
@pytest.mark.parametrize("hint", [0.0, 1.0001, 0.8, 3.0])
def test_bracket_pass_plain_matches_jax_kernel(kind, hint):
    """B8's plain version against JAX's fused_bracket_pass (interpret)."""
    rows, cols, c = _inputs(kind)
    med = _med_of(tfm.dist_block_plain(*_t(rows, cols, c)).numpy(), hint)
    D, mm, cnts = tfm.fused_bracket_pass(*_t(rows, cols, med, c))
    jD, jmm, jc = jpm.fused_bracket_pass(*_j(rows, cols, med, c),
                                         brackets=BR, interpret=True)
    assert cnts.dtype == torch.int32 and cnts.shape == (2 * len(BR),)
    if kind == "lattice":
        np.testing.assert_array_equal(D.numpy(), np.asarray(jD))
        np.testing.assert_array_equal(mm.numpy(), np.asarray(jmm))
        np.testing.assert_array_equal(cnts.numpy(), np.asarray(jc))
    else:
        np.testing.assert_allclose(D.numpy(), np.asarray(jD), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(mm.numpy(), np.asarray(jmm), rtol=1e-5,
                                   atol=1e-6)
    # The counts and range are those of the block it emits.
    np.testing.assert_array_equal(
        cnts.numpy(), [(D.numpy() <= np.float32(b) * med).sum()
                       for pair in BR for b in pair])
    assert mm[1] == D.max() and mm[0] == -min(float(D.min()), 0.0)


@pytest.mark.parametrize("kind", ["lattice", "normal"])
@pytest.mark.parametrize("g1", [8, 16])
@pytest.mark.parametrize("hint", [0.0, 1.0001, 0.5])
def test_bracket_grid_pass_plain_matches_jax_kernel(kind, g1, hint):
    """B9's plain version against JAX's fused_bracket_grid_pass
    (interpret), at a ring shape too (rows against other columns)."""
    rows, cols, c = _inputs(kind)
    if kind == "normal":
        cols = cols[:77]          # m != n, n not a multiple of 32
    Dp = tfm.dist_block_plain(*_t(rows, cols, c)).numpy()
    med = _med_of(Dp, hint)
    hib = np.float32(4.0 * ((cols - c) ** 2).sum(1).max() * 1.0001 + 1e-30)
    D, cnts = tfm.fused_bracket_grid_pass(*_t(rows, cols, med, c, hib),
                                          g1=g1)
    jD, jc = jpm.fused_bracket_grid_pass(*_j(rows, cols, med, c, hib),
                                         brackets=BR, g1=g1, interpret=True)
    assert cnts.shape == ((len(BR) + 1) * (g1 + 1),)
    if kind == "lattice":
        np.testing.assert_array_equal(D.numpy(), np.asarray(jD))
        np.testing.assert_array_equal(cnts.numpy(), np.asarray(jc))
    else:
        np.testing.assert_allclose(D.numpy(), np.asarray(jD), rtol=1e-5,
                                   atol=1e-6)
    edges = tfm.grid_edges(*_t(med, hib), BR, g1).numpy()
    np.testing.assert_array_equal(
        cnts.numpy(), [(D.numpy() <= t).sum() for t in edges])


def test_bracket_pass_guards():
    rows, cols, c = _t(*_inputs("normal"))
    med, hib = torch.tensor(1.0), torch.tensor(2.0)
    for fn, args in ((tfm.fused_bracket_pass, (med, c)),
                     (tfm.fused_bracket_grid_pass, (med, c, hib))):
        with pytest.raises(TypeError, match="f32-only"):
            fn(rows.double(), cols.double(), *args)
        big = torch.empty(1, 7).expand(2 ** 16, 7)
        with pytest.raises(ValueError, match="int32"):
            fn(big, big, *args)


def _block_and_hint(hint, m=48, n=3000, seed=5):
    """A [m, n] block (> 100k entries: the quad-ary regime) and a hint."""
    rows, cols, c = _inputs("normal", m=m, n=n, seed=seed)
    D = tfm.dist_block_plain(*_t(rows, cols, c)).numpy()
    return D, _med_of(D, hint)


@pytest.mark.parametrize("hint", [0.0, 1.0001, 0.8, 0.5, 3.0])
def test_sharded_warm_from_bracket_bitwise(hint, mesh1):
    D, med = _block_and_hint(hint)
    # The range and counts of D itself (the bracket pass's outputs).
    mm = torch.tensor([-min(D.min(), 0.0), D.max()], dtype=torch.float32)
    cnts = torch.tensor([(D <= np.float32(b) * med).sum()
                         for pair in BR for b in pair], dtype=torch.int32)
    got = tmed.sharded_warm_from_bracket(
        *_t(D, med), mm, cnts, mesh1, total=D.size, warm_passes=8)
    want = _shard_map(lambda D_, m_, mm_, c_: jmed.sharded_warm_from_bracket(
        D_, m_, mm_, c_, "particles", total=D.size, warm_passes=8))(
        *_j(D, med, mm.numpy(), cnts.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The single-device warm search on the same block agrees too.
    np.testing.assert_array_equal(
        got.numpy(), tmed._warm_search(*_t(D, med), 8).numpy())


@pytest.mark.parametrize("g1", [8, 16])
@pytest.mark.parametrize("warm_passes", [6, 8])
@pytest.mark.parametrize("hint", [0.0, 1.0001, 0.8, 0.5, 3.0])
def test_sharded_warm_from_grid_bitwise(g1, warm_passes, hint, mesh1):
    D, med = _block_and_hint(hint)
    hib = np.float32(D.max() * 1.5)
    edges = tfm.grid_edges(*_t(med, hib), BR, g1)
    cnts = tfm.count_le(torch.from_numpy(D), edges)
    got = tmed.sharded_warm_from_grid(
        *_t(D, med), cnts, torch.tensor(hib), mesh1, total=D.size,
        warm_passes=warm_passes, g1=g1)
    want = _shard_map(lambda D_, m_, c_, h_: jmed.sharded_warm_from_grid(
        D_, m_, c_, h_, "particles", total=D.size, warm_passes=warm_passes,
        g1=g1))(*_j(D, med, cnts.numpy(), hib))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sharded_warm_from_grid_guards(mesh1):
    D, med = _block_and_hint(1.0)
    args = (*_t(D, med), torch.zeros(36, dtype=torch.int32),
            torch.tensor(1.0), mesh1)
    with pytest.raises(ValueError, match="power of two"):
        tmed.sharded_warm_from_grid(*args, total=D.size, g1=6)
    with pytest.raises(ValueError, match="cap warm_passes"):
        tmed.sharded_warm_from_grid(*args, total=D.size, warm_passes=14,
                                    g1=8)


@pytest.mark.parametrize("world", [1, 2, 4, 8])
@pytest.mark.parametrize("n_loc,max_rows", [(16, 512), (250, 256),
                                            (1000, 128), (3, 2), (7, 512)])
def test_local_row_idx_matches_jax(world, n_loc, max_rows):
    idx, m_global = tmed._local_row_idx(
        n_loc, ParticleMesh(None, "particles", world, 0, "cpu"), max_rows)
    out = {}

    def fn(_):
        i, mg = jmed._local_row_idx(n_loc, "particles", max_rows)
        out["m_global"] = mg
        return i

    want = _shard_map(fn, world)(jnp.zeros(()))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    assert m_global == out["m_global"]


@pytest.mark.parametrize("n,max_rows,passes", [(40, 512, 30),
                                               (600, 256, 30),
                                               (600, 512, 8)])
def test_sharded_and_ring_bisect_match_jax(n, max_rows, passes, mesh1):
    """The cold sharded searches (all-gather and ring) on one process
    against JAX's on a 1-device mesh (the binary and quad-ary regimes);
    each package computes its own Gram (f32 both), so rtol 1e-5."""
    theta = np.random.default_rng(n).normal(size=(n, 5)).astype(np.float32)
    t = torch.from_numpy(theta)
    got = tmed.sharded_bisect_median(t, t, mesh1, max_rows, passes)
    ring = tmed.ring_bisect_median(t, mesh1, max_rows, passes)
    want = _shard_map(lambda x: jmed.sharded_bisect_median(
        x, x, "particles", max_rows, passes))(jnp.asarray(theta))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_array_equal(ring.numpy(), got.numpy())
    warm = tmed.ring_warm_bisect_median(t, got * 1.01, mesh1, max_rows)
    want_w = _shard_map(lambda x, m: jmed.ring_warm_bisect_median(
        x, m, "particles", max_rows))(jnp.asarray(theta),
                                      jnp.asarray(got.numpy() * 1.01))
    np.testing.assert_allclose(warm.numpy(), np.asarray(want_w), rtol=1e-5)
