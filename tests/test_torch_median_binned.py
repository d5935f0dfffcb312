"""The port's subsample and binned medians (stein_tpu_torch/ops/median.py)
against the JAX package's, on the same numpy particles (f32 and f64), and
the samplers that use them against the JAX sampler.

The histogram counts are exact integers on both sides while the total stays
below 2^24 (n < 4096), so the port must find the same bins as the JAX
package there: the two medians are the same bins' centres, which a
quarter of a final bin width (hi0 - lo0) / n_bins**n_levels tells apart
(another bin moves the result by half a width; the centres' arithmetic
differs by an ulp where XLA contracts a multiply-add). Above 2^24 the f32
cumulative sums round in each library's own order, and the port is held
within one final bin width. The subsample median is held to rtol 1e-12 in
f64 and 2e-6 in f32 (torch and XLA sum the Gram's p products in their own
orders, so an f32 entry of D may differ by an ulp). The samplers are held
at the reference-semantics class (rtol 1e-5 / atol 1e-6) for 10 steps; the
mesh samplers are in tests/test_torch_mesh.py."""

import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import stein_tpu as sj
import stein_tpu_torch as st
import torch_mesh_runner as R
from binned_sweep import reference_binned_median
from stein_tpu.kernels import InverseMultiquadricKernel as JIMQ
from stein_tpu.models import LinearRegressionModel as JLR
from stein_tpu.ops import median as jm
from stein_tpu.parallel import particle_mesh as jax_mesh
from stein_tpu_torch.kernels import InverseMultiquadricKernel as TIMQ
from stein_tpu_torch.models import LinearRegressionModel as TLR
from stein_tpu_torch.ops import median as tm

REF_TOL = dict(rtol=1e-5, atol=1e-6)
DTYPES = [(np.float32, jnp.float32), (np.float64, jnp.float64)]


def _theta(n, p, seed, dt):
    return np.random.default_rng(seed).normal(size=(n, p)).astype(dt)


def _final_width(theta, n_bins, n_levels):
    """(hi0 - lo0) / n_bins**n_levels of binned_median's range."""
    hi0 = 4.0 * float(np.max(np.sum(theta.astype(np.float64) ** 2, 1)))
    return hi0 * (1 + 1e-6) / n_bins ** n_levels


@pytest.mark.parametrize("dt,jdt", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("n,max_rows", [(40, 64), (300, 64), (1000, 512),
                                        (257, 100)])
def test_subsampled_median_matches_jax(n, max_rows, dt, jdt):
    theta = _theta(n, 5, n, dt)
    want = float(jm.subsampled_sq_dist_median(jnp.asarray(theta, jdt),
                                              max_rows=max_rows))
    got = float(tm.subsampled_sq_dist_median(torch.from_numpy(theta),
                                             max_rows=max_rows))
    assert got == pytest.approx(want, rel=2e-6 if dt is np.float32
                                else 1e-12)


@pytest.mark.parametrize("dt,jdt", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("n,p,n_bins,n_levels,block_rows", [
    (300, 5, 1024, 2, 64),      # 300 = 4 x 64 + 44: a remainder block
    (257, 3, 512, 3, 100),      # three levels (the quotient passes 2^31)
    (1000, 7, 4096, 2, 256),    # the defaults
    (1000, 7, 4096, 3, 256),    # the defaults with three levels
    (96, 2, 2048, 2, 1000),     # block_rows > n: one block
    (513, 4, 300, 2, 7),        # n_bins not a power of two
])
def test_binned_median_matches_jax(n, p, n_bins, n_levels, block_rows, dt,
                                   jdt):
    """Below 2^24 entries the counts are exact on both sides, so the bins
    are equal."""
    theta = _theta(n, p, n + p, dt)
    kw = dict(n_bins=n_bins, n_levels=n_levels, block_rows=block_rows)
    want = float(jm.binned_median(jnp.asarray(theta, jdt), **kw))
    got = float(tm.binned_median(torch.from_numpy(theta), **kw))
    assert abs(got - want) < _final_width(theta, n_bins, n_levels) / 4


def test_binned_median_three_levels_off_range_entries_clamp():
    """At three levels the final interval is range / 4096^3 wide, so the
    far entries' quotients (D - lo) / width pass 2^31: clamped in floating
    point before the int conversion, they land in the end bins as XLA's
    saturating conversion puts them, and the median is JAX's."""
    theta = _theta(600, 3, 5, np.float32)
    D = ((theta[:, None, :] - theta[None, :, :]) ** 2).sum(-1)
    width = _final_width(theta, 4096, 3)
    assert (D.max() - np.median(D)) / width > 2 ** 31
    want = float(jm.binned_median(jnp.asarray(theta), n_levels=3))
    got = float(tm.binned_median(torch.from_numpy(theta), n_levels=3))
    assert abs(got - want) < width / 4


def test_binned_median_large_n_within_one_final_bin():
    """tests/test_ops.py:141's n=6000 (36M entries; level-2 boundary bins
    hold ~18M > 2^24): within one final bin width of the JAX package's,
    and within its 1e-4 of the exact median."""
    theta = _theta(6000, 3, 15, np.float32)
    kw = dict(n_bins=1024, n_levels=2, block_rows=512)
    want = float(jm.binned_median(jnp.asarray(theta), **kw))
    got = float(tm.binned_median(torch.from_numpy(theta), **kw))
    assert abs(got - want) <= _final_width(theta, 1024, 2)
    t = torch.from_numpy(theta.astype(np.float64))
    exact = float(tm.exact_median(torch.cdist(t, t) ** 2))
    assert abs(got - exact) / exact < 1e-4


def test_binned_median_is_near_exact():
    """Within range / n_bins**n_levels / 2 (plus the Gram's rounding) of
    the exact median."""
    theta = _theta(700, 6, 3, np.float64)
    got = float(tm.binned_median(torch.from_numpy(theta), n_bins=1024))
    t = torch.from_numpy(theta)
    exact = float(tm.exact_median(torch.cdist(t, t) ** 2))
    assert abs(got - exact) <= _final_width(theta, 1024, 2) / 2 + 1e-12


BIN_DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
              (torch.float64, jnp.float64)]


def _lattice(n_bins):
    """A D row on the bin edges of (lo, width) = (-2, 0.5), between them,
    below lo and past the last edge."""
    k = np.arange(-5, n_bins + 6, dtype=np.float64)
    return np.concatenate([-2.0 + 0.5 * k, -2.0 + 0.5 * k + 0.25,
                           [-1e3, -2.5, 1e6]])


def _bin_case(kind, n_bins, tdt):
    """(G, r, c, lo, width) in ``tdt`` for the count's edge inputs, D =
    (r + c^T) - 2 G: a Gram block at the first level's interval [lo0, hi0]
    (every entry inside); at a second level's interval, one first-level
    bin about the median (nearly every entry in an end bin); a lattice on
    the bin edges, below lo and past the last edge (G and r zero, so D is
    the lattice exactly)."""
    rng = np.random.default_rng(n_bins)
    if kind == "lattice":
        c = torch.from_numpy(_lattice(n_bins)).to(tdt)
        return (torch.zeros(1, c.numel(), dtype=tdt),
                torch.zeros(1, dtype=tdt), c, torch.tensor(-2.0, dtype=tdt),
                torch.tensor(0.5, dtype=tdt))
    theta = torch.from_numpy(rng.normal(size=(100, 5))).to(tdt)
    rsq = torch.sum(theta * theta, dim=1)
    G = torch.matmul(theta[:37], theta.T)
    D = tm._row_block_sq_dists(theta[:37], theta, rsq[:37], rsq)
    lo, hi = tm._binned_range(torch.max(rsq), tdt)
    width = (hi - lo) / n_bins
    if kind == "second":
        b = torch.floor((tm.exact_median(D.double()).to(tdt) - lo) / width)
        lo = lo + b * width
        width = width / n_bins
    return G, rsq[:37], rsq, lo, width


@pytest.mark.parametrize("tdt,jdt", BIN_DTYPES, ids=["f32", "bf16", "f64"])
@pytest.mark.parametrize("n_bins", [1, 2048, 4096, 4098])
@pytest.mark.parametrize("kind", ["first", "second", "lattice"])
def test_bin_counts_match_jax_formula(kind, n_bins, tdt, jdt):
    """The count (``_bin_counts``, the bin-count kernel's plain version's
    count of the plain D) bitwise equal to JAX's block count,
    clip(int32((D - lo) / width), 0, n_bins - 1) then a scatter-add
    (stein_tpu/ops/median.py:262-266), on the same D, lo and width in each
    dtype. n_bins 4098: the last bin's edge 4097 is no bf16 value, and the
    count compares exactly (torch alone would round it to 4096).
    ``bin_count`` of the same Gram block adds the counts to a running
    histogram as the blocks' sum does."""
    G, r, c, lo, width = _bin_case(kind, n_bins, tdt)
    D = tm._sq_dists_from_gram(G, r, c)

    def jax_counts(D, lo, width):
        b = jnp.clip(((D - lo) / width).astype(jnp.int32), 0, n_bins - 1)
        ints = jnp.zeros((n_bins,), jnp.int32).at[b.ravel()].add(1)
        return ints.astype(jnp.float32)
    j = [jnp.asarray(x.double().numpy(), jdt) for x in (D, lo, width)]
    want = np.asarray(jax.jit(jax_counts)(*j))
    got = tm._bin_counts(D, lo, width, n_bins)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got.sum()) == D.numel()
    if kind == "second":
        assert float(got[0] + got[-1]) > 0.9 * D.numel()
    acc = torch.arange(n_bins, dtype=torch.float32).reshape(1, -1) * 2.0 ** 20
    np.testing.assert_array_equal(
        tm.bin_count(G, r, c, [(lo, width)], n_bins, acc.clone()).numpy(),
        (acc + got).numpy())


def _gram_case(kind, n_bins, tdt):
    """(G, r, c, D, two windows) of the Gram-fed count's cases, D formed
    apart from G's count: _row_block_sq_dists of a block of particles (a
    [37, 100] block; the n=10000 path's remainder block [16, 10000] at
    p=64), with the first level's interval and a second level's about the
    median ("first", "remainder"), or the second levels about the two
    middle ranks' neighbouring first-level bins ("second"); "edges": G and
    r zero but for entries whose 2 g overflows to inf (and one NaN) in
    the last row, c a lattice on the bin edges (q at n_bins - 1 among
    them), NaN, -inf and inf, over windows (-2, 0.5) and (-1.75, 0.5)."""
    if kind == "edges":
        c = torch.from_numpy(np.concatenate(
            [_lattice(n_bins), [np.nan, -np.inf, np.inf]])).to(tdt)
        G = torch.zeros(2, c.numel(), dtype=tdt)
        G[1, :8] = 3e38
        G[1, 8] = float("nan")
        r = torch.zeros(2, dtype=tdt)
        D = (r[:, None] + c[None, :]) - 2.0 * G
        wins = [(torch.tensor(lo, dtype=tdt), torch.tensor(0.5, dtype=tdt))
                for lo in (-2.0, -1.75)]
        return G, r, c, D, wins
    n, p, rows = (10000, 64, 16) if kind == "remainder" else (100, 5, 37)
    rng = np.random.default_rng(n_bins + n)
    theta = torch.from_numpy(rng.normal(size=(n, p)) * (
        0.01 if kind == "remainder" else 1.0)).to(tdt)
    rsq = torch.sum(theta * theta, dim=1)
    blk, r = theta[-rows:], rsq[-rows:]
    D = tm._row_block_sq_dists(blk, theta, r, rsq)
    lo, hi = tm._binned_range(torch.max(rsq), tdt)
    width = (hi - lo) / n_bins
    b = torch.floor((tm.exact_median(D.double()).to(tdt) - lo) / width)
    second = [(lo + (b + i) * width, width / n_bins) for i in (0, 1)]
    wins = second if kind == "second" else [(lo, width), second[0]]
    return torch.matmul(blk, theta.T), r, rsq, D, wins


@pytest.mark.parametrize("n_windows", [1, 2])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16,
                                 torch.float64], ids=["f32", "bf16", "f64"])
@pytest.mark.parametrize("n_bins", [1, 2048, 4096])
@pytest.mark.parametrize("kind", ["first", "second", "remainder", "edges"])
def test_gram_bin_counts_equal_the_plain_d_count(kind, n_bins, tdt,
                                                 n_windows):
    """The Gram-fed count's plain version (``_gram_bin_counts``, and
    ``bin_count`` on the CPU) bitwise ``_bin_counts`` of the D that
    ``_row_block_sq_dists`` forms, a histogram a window, alone and added
    to a running [windows, n_bins] histogram."""
    G, r, c, D, wins = _gram_case(kind, n_bins, tdt)
    wins = wins[:n_windows]
    want = torch.stack([tm._bin_counts(D, lo, w, n_bins) for lo, w in wins])
    got = tm._gram_bin_counts(G, r, c, wins, n_bins)
    assert got.dtype == torch.float32 and got.shape == (n_windows, n_bins)
    assert torch.equal(got, want)
    assert torch.equal(tm.bin_count(G, r, c, wins, n_bins), want)
    assert (got.sum(dim=1) == D.numel()).all()
    acc = torch.arange(n_windows * n_bins, dtype=torch.float32).reshape(
        n_windows, n_bins) * 2.0 ** 20
    assert torch.equal(tm.bin_count(G, r, c, wins, n_bins, acc.clone()),
                       acc + want)


@pytest.mark.parametrize("n_levels", [1, 2, 3])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float64], ids=["f32", "bf16", "f64"])
@pytest.mark.parametrize("n,p,n_bins,block_rows", [
    (300, 5, 1024, 64),     # a remainder block
    (96, 2, 2048, 1000),    # one block
    (513, 4, 300, 7),       # n_bins not a power of two
])
def test_binned_median_equals_the_per_window_sweep(n, p, n_bins, block_rows,
                                                   dt, n_levels):
    """binned_median's shared sweeps (one histogram at the first level,
    both middle ranks' windows in one sweep after it) give bitwise the
    median of refining each rank on its own, one sweep a rank and level
    (binned_sweep.reference_binned_median)."""
    theta = torch.from_numpy(_theta(n, p, n + p, np.float64)).to(dt)
    kw = dict(n_bins=n_bins, n_levels=n_levels, block_rows=block_rows)
    got = tm.binned_median(theta, **kw)
    want = reference_binned_median(theta, **kw)
    assert got.dtype == want.dtype == dt
    assert torch.equal(got, want), (float(got), float(want))


@functools.lru_cache(maxsize=None)
def _port_mesh_medians(world):
    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/out.npz"
        ok, outs = R.launch(world, [R.MEDIANS], out)
        assert ok, "\n".join(outs)
        with np.load(out) as f:
            return {k.split("/")[1]: f[k] for k in f.files
                    if k.startswith(R.MEDIANS + "/")}


@functools.lru_cache(maxsize=None)
def _jax_mesh_medians(world):
    mesh = jax_mesh(jax.devices()[:world])
    out = {}
    for name, (dt, jdt) in zip(("f32", "f64"), DTYPES):
        theta = jnp.asarray(R.medians_theta(dt), jdt)
        for levels in (1, 2, 3):
            f = jax.shard_map(
                lambda t, levels=levels: jm.binned_median(
                    t, n_bins=512, n_levels=levels, block_rows=5,
                    axis_name="particles",
                    theta_cols=jax.lax.all_gather(t, "particles",
                                                  tiled=True)),
                mesh=mesh, in_specs=P("particles"), out_specs=P(),
                check_vma=False)
            out[f"binned_{name}_{levels}"] = np.asarray(jax.jit(f)(theta))
            f = jax.shard_map(
                lambda t, levels=levels: jm.ring_binned_median(
                    t, "particles", n_bins=512, n_levels=levels),
                mesh=mesh, in_specs=P("particles"), out_specs=P(),
                check_vma=False)
            out[f"ring_{name}_{levels}"] = np.asarray(jax.jit(f)(theta))
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_binned_medians_match_jax(world):
    """binned_median with a mesh (local rows against the gathered columns,
    histograms psum'd) and ring_binned_median (the column blocks around
    the ring) in 2 and 4 gloo processes, at n_levels 1, 2 and 3, against
    the JAX functions under shard_map on as many fake devices: the same
    bins (64^2 entries, exact counts)."""
    got, want = _port_mesh_medians(world), _jax_mesh_medians(world)
    assert {k for k in got if not k.startswith("ref_")} == set(want)
    for key in want:
        levels = int(key.rsplit("_", 1)[1])
        width = _final_width(R.medians_theta(np.float64), 512, levels)
        assert abs(float(got[key]) - float(want[key])) < width / 4, key


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_binned_medians_equal_the_per_window_sweep(world):
    """On 2 and 4 gloo processes, binned_median and ring_binned_median
    (one psum of both windows' histograms a level; on the ring one
    circulation a level) give bitwise the medians of the per-window sweep
    (a circulation and a psum a rank and level), f32 and f64, n_levels 1,
    2 and 3."""
    got = _port_mesh_medians(world)
    keys = [k for k in got if not k.startswith("ref_")]
    assert len(keys) == 12
    for key in keys:
        assert got[key].dtype == got["ref_" + key].dtype, key
        assert np.array_equal(got[key], got["ref_" + key]), key


def _problem(n=48, p=6, seed=0):
    """The JAX suite's fused-step problem (tests/test_pallas_step.py)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(80, p))
    y = X @ rng.normal(size=(p, 1))
    theta0 = (rng.normal(size=(n, p)) * 0.1).astype(np.float32)
    return X.astype(np.float32), y.astype(np.float32), theta0


@pytest.mark.parametrize("cfg", [
    dict(median="subsample", median_max_rows=16),
    dict(median="subsample", median_max_rows=16, kernel_impl="pallas"),
    dict(median="binned"),
    dict(median="binned", kernel_impl="pallas", binned_bins=1024,
         binned_block_rows=7),
    dict(median="binned", kernel="imq"),
    dict(median="subsample", median_max_rows=20, kernel="imq"),
], ids=["subsample", "subsample-pallas", "binned", "binned-pallas-settings",
        "binned-imq", "subsample-imq"])
def test_sampler_median_modes_match_jax(cfg):
    """SVGDSampler(median='subsample'|'binned') on one device against the
    JAX sampler from the same theta0: run 10 steps, then train_on_batch,
    at the reference-semantics class."""
    X, y, theta0 = _problem()
    jcfg, tcfg = dict(cfg), dict(cfg)
    if cfg.get("kernel") == "imq":
        jcfg["kernel"], tcfg["kernel"] = JIMQ(), TIMQ()
    jmod, tmod = JLR(6), TLR(6)
    js = sj.SVGDSampler(48, jmod.log_p, jmod.template(),
                        sj.Adam(learning_rate=1e-1), theta=jnp.asarray(theta0),
                        pallas_interpret=True, **jcfg)
    ts = st.SVGDSampler(48, tmod.log_p, tmod.template(),
                        st.Adam(learning_rate=1e-1), theta=theta0,
                        device="cpu", **tcfg)
    jb = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    tb = {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}
    ja, ta = js.run(jb, 10), ts.run(tb, 10)
    np.testing.assert_allclose(ts.samples, np.asarray(js.samples), **REF_TOL)
    for key in ("median", "h2", "phi_norm", "log_p_mean"):
        np.testing.assert_allclose(ta[key].numpy(), np.asarray(ja[key]),
                                   rtol=1e-5, err_msg=key)
    aj, at = js.train_on_batch(jb), ts.train_on_batch(tb)
    np.testing.assert_allclose(float(at["median"]), float(aj["median"]),
                               rtol=1e-5)
