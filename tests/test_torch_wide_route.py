"""The streaming tile's wide route (ops/svgd_tile.py, WIDE: D formed once,
then K @ u) on the CPU, where it runs its two plain stages, and the SVGD
paper's Bayesian NN on UCI Year through the port's normal path: the
keywords throughput_config picks at the Year widths, and a Year-shaped
model at small widths through SVGDSampler.run against the benchmark's
plain reference (svgd_bench/reference/bnn.py). This file imports no JAX."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import stein_tpu_torch as st
from stein_tpu_torch.models import BayesianNNModel
from stein_tpu_torch.ops import svgd_tile
from stein_tpu_torch.utils import graphs, profiling

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from svgd_bench.reference import bnn as ref_bnn  # noqa: E402

# The Year network (Liu & Wang 2016, section 5.3): 90 -> 100 -> 1, the
# documented training split and the paper's minibatch.
YEAR = dict(n_feats=90, n_hidden=100, n_train=463715, n_batch=100,
            prior_alpha=1.0, prior_beta=0.1)
# Year-shaped at small widths: several features, a minibatch of a large
# training set, p = 9 * 16 + 2 * 16 + 3 = 179, past WIDE_ROUTE_MIN_P.
SMALL = dict(n_feats=9, n_hidden=16, n_train=1000, n_batch=10,
             prior_alpha=1.0, prior_beta=0.1)


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def _inputs(m, n, p, seed):
    g = torch.Generator().manual_seed(seed)
    cols = torch.randn(n, p, generator=g)
    grads = torch.randn(n, p, generator=g)
    return cols[:m], cols, grads, svgd_tile.column_center(cols)


@pytest.mark.parametrize("div_h2", [True, False])
@pytest.mark.parametrize("n_total", [None, 40])
@pytest.mark.parametrize("m,n,p", [(17, 40, 9), (40, 40, 200), (5, 40, 1)])
def test_wide_plain_stages_equal_b3_plain(m, n, p, n_total, div_h2):
    """The wide route's plain stages (phi_gram_plain, then
    wide_contract_plain) give the bits of B3's plain version, raw sums
    and phi, in both exponent orders."""
    rows, cols, grads, c = _inputs(m, n, p, m + p)
    h2 = 0.7 * p
    got = svgd_tile._tile(rows, cols, grads, h2, c, n_total, "f32", div_h2,
                          svgd_tile.WIDE)
    want = svgd_tile._tile(rows, cols, grads, h2, c, n_total, "f32", div_h2,
                           svgd_tile.MMA_SYNC)
    if n_total is None:
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        assert torch.equal(got, want)


def test_wide_plain_stages_compose():
    """D of the first stage is the centred squared distance; the second
    stage on it is (K @ u, rowsum K) with u about the centre."""
    rows, cols, grads, c = _inputs(6, 11, 5, 2)
    D = svgd_tile.phi_gram_plain(rows, cols, c)
    exact = ((rows.double()[:, None, :] - cols.double()[None]) ** 2).sum(-1)
    torch.testing.assert_close(D.double(), exact, rtol=1e-5, atol=1e-5)
    ku, ks = svgd_tile.wide_contract_plain(D, cols, grads, 2.0, c)
    K = torch.exp(-D / 2.0 / 2.0)
    u = grads - (cols - c) / 2.0
    torch.testing.assert_close(ku, K @ u, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ks, K.sum(1, keepdim=True), rtol=1e-5,
                               atol=1e-5)


def test_phi_takes_the_wide_route_with_its_spans():
    """svgd_phi past WIDE_ROUTE_MIN_P under a CPU profiler: the stage spans
    svgd.phi.gram and svgd.phi.contract, once each (host clock only off a
    card), the B3-wide key among the launches, and the same bits as the
    plain version."""
    p = svgd_tile.WIDE_ROUTE_MIN_P
    _, theta, grads, c = _inputs(12, 12, p, 7)
    assert svgd_tile.tile_route(12, 12, p) == svgd_tile.WIDE
    with profile(activities=[ProfilerActivity.CPU]):
        phi = svgd_tile.svgd_phi(theta, grads, 3.0 * p, center=c)
    s = profiling.summary()
    for name in ("svgd.phi.gram", "svgd.phi.contract"):
        assert s["spans"][name]["count"] == 1
        assert s["spans"][name]["device_s"] is None
    assert "B3-wide" in s["counters"]["launches"]
    ku, ks = svgd_tile.svgd_both_ksum_plain(theta, theta, grads, 3.0 * p, c)
    assert torch.equal(phi, (ku + ks * (theta - c) / (3.0 * p)) / 12)


def test_wide_spans_are_off_without_a_profiler():
    _, theta, grads, c = _inputs(8, 8, svgd_tile.WIDE_ROUTE_MIN_P, 1)
    svgd_tile.svgd_phi(theta, grads, 500.0, center=c)
    assert profiling.summary()["spans"] == {}


def throughput_config_year(model, p):
    return st.throughput_config(2048, p, model=model)


def test_throughput_config_at_the_year_widths():
    """The Year cell's keywords, as throughput_config(2048, 9203, model=)
    picks them: the streaming tile (on the wide route there), the
    in-kernel-Gram median on 128 rows, and B7 as custom_grads."""
    model = BayesianNNModel(**YEAR)
    p = 90 * 100 + 2 * 100 + 3
    kw = throughput_config_year(model, p)
    assert p == 9203
    assert kw["kernel_impl"] == "pallas"
    assert kw["median_impl"] == "fused_gram"
    assert kw["median_max_rows"] == 128
    assert callable(kw["custom_grads"])
    assert "step_impl" not in kw
    assert svgd_tile.tile_route(2048, 2048, p) == svgd_tile.WIDE


def _small_problem(n=12, seed=0):
    model = BayesianNNModel(**SMALL)
    f, H, B = SMALL["n_feats"], SMALL["n_hidden"], SMALL["n_batch"]
    p = f * H + 2 * H + 3
    rng = np.random.default_rng(seed)
    theta = (rng.normal(size=(n, p)) * 0.3).astype(np.float32)
    X = rng.normal(size=(B, f)).astype(np.float32)
    y = rng.normal(size=(B, 1)).astype(np.float32)
    batch = {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}
    return model, theta, batch, p


def _reference(theta, batch):
    data = {k: v.double() for k, v in batch.items()}
    return ref_bnn.grad_fn(data, **SMALL)(torch.from_numpy(theta).double())


def test_small_year_nn_hook_against_the_reference():
    """B7's hook on the CPU (its plain version) at f = 9, H = 16, B = 10,
    n_train = 1000 on seeded random theta, against the float64 reference:
    log p rtol 1e-5, gradients 1e-5 of their largest."""
    model, theta, batch, p = _small_problem()
    lp, g = model.pallas_grads()(torch.from_numpy(theta), batch)
    lp_ref, g_ref = _reference(theta, batch)
    torch.testing.assert_close(lp.double(), lp_ref, rtol=1e-5, atol=1e-6)
    scale = g_ref.abs().max().item()
    torch.testing.assert_close(g.double(), g_ref, rtol=0, atol=1e-5 * scale)


def test_small_year_nn_through_run_on_the_cells_keywords():
    """A Year-shaped NN at small widths through SVGDSampler.run on the
    Year cell's keywords (B7's hook as custom_grads, the streaming tile on
    its wide route): the first step's mean log p against the reference's
    at theta, and the run's stage spans with the wide route's two nested
    in svgd.phi, once a step."""
    model, theta, batch, p = _small_problem()
    n = theta.shape[0]
    kw = throughput_config_year(BayesianNNModel(**YEAR), 9203)
    kw["custom_grads"] = model.pallas_grads()
    s = st.SVGDSampler(n, model.log_p, model.template(), st.Adam(1e-3),
                       theta=theta, device="cpu", **kw)
    assert svgd_tile.tile_route(n, n, p) == svgd_tile.WIDE
    before = graphs.read_counts()["B3-wide"]
    with profile(activities=[ProfilerActivity.CPU]):
        aux = s.run(batch, 3)
    lp_ref, _ = _reference(theta, batch)
    assert float(aux["log_p_mean"][0]) == pytest.approx(
        float(lp_ref.mean()), rel=1e-5)
    assert np.all(np.isfinite(s.samples))
    assert not np.array_equal(s.samples, theta)
    spans = profiling.summary()["spans"]
    for name in ("svgd.phi.gram", "svgd.phi.contract"):
        assert spans[name]["count"] == 3
        assert spans[name]["parents"] == {"svgd.phi": 3}
    # The CPU runs the plain stages: nothing is launched or counted.
    assert graphs.read_counts()["B3-wide"] == before
