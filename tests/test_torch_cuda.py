"""The port's CUDA kernels against their plain PyTorch versions on an
NVIDIA card. Marked ``cuda``: without a card every test here skips (the
decision is made in the fixture, at run time). On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: this file needs torch and the port only, not the JAX
package's test configuration)."""

import numpy as np
import pytest
import torch

from stein_tpu_torch import Adagrad, Adam, SVGDSampler, throughput_config
from stein_tpu_torch.models import (
    BayesianNNModel,
    LinearRegressionModel,
    LogisticRegressionModel,
)
from stein_tpu_torch.models import bayesian_nn
from stein_tpu_torch.ops import fused_median, fused_step, model_grad, svgd_tile
from stein_tpu_torch.ops.median import (
    _strided_rows,
    row_subsample_block,
    subsample_rows,
)
from stein_tpu_torch.ops.optimizers import AdagradState, AdamState
from stein_tpu_torch.ops.rbf import pairwise_sq_dists

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("hint,passes", [(0.0, 30), (1.01, 8), (0.8, 8)])
def test_b2_bitwise_against_plain(dev, hint, passes):
    rng = np.random.default_rng(0)
    theta = torch.tensor(rng.normal(size=(1000, 32)), dtype=torch.float32,
                         device=dev)
    D = row_subsample_block(theta, 256)
    med0 = fused_median.warm_search_on_value(
        D, torch.zeros((), device=dev), 30)
    med_prev = med0 * hint
    got = fused_median.fused_warm_median_rows(D, med_prev, passes)
    want = fused_median.warm_search_on_value(D, med_prev, passes)
    assert got.item() == want.item()


@pytest.mark.parametrize("rule", ["adam", "adagrad"])
@pytest.mark.parametrize("n,p,rows", [(1000, 128, 256), (300, 40, 512),
                                     (300, 400, 512)])
def test_b1_against_plain_on_exact_d(dev, rule, n, p, rows):
    """Integer particles whose columns sum to 0: the centre, the Gram and
    D are exact in any summation order, so the median and h^2 are bitwise
    equal and the rest differs by the order of the K @ u sums only
    (max|a-b| / max|b| <= 1e-5)."""
    rng = np.random.default_rng(1)
    half = rng.integers(-3, 4, size=(n // 2, p))
    theta = torch.tensor(np.concatenate([half, -half]), dtype=torch.float32,
                         device=dev)
    grads = torch.tensor(rng.normal(size=(n, p)), dtype=torch.float32,
                         device=dev)
    nu = torch.ones(n, p, device=dev)
    count = torch.full((), 5, dtype=torch.int32, device=dev)
    lr = torch.full((), 0.1, device=dev)
    if rule == "adam":
        gd, state = Adam(1e-1, decay=0.99), AdamState(
            torch.zeros_like(nu), nu, count, lr)
    else:
        gd, state = Adagrad(5e-2), AdagradState(nu, count, lr)
    sub = subsample_rows(theta, rows)
    med_prev = fused_median.warm_search_on_value(
        row_subsample_block(theta, rows), torch.zeros((), device=dev), 30)
    k_theta, k_state, k_stats = fused_step.fused_warm_step_tail(
        theta, grads, None, None, med_prev, state, gd, gram_in_kernel=True,
        theta_sub=sub)
    p_theta, p_state, p_stats = fused_step._plain_tail(
        theta, grads, sub, med_prev, state, gd, 10.0, 8,
        fused_step.DEFAULT_BRACKETS)
    assert k_stats[0].item() == p_stats[0].item()
    assert k_stats[2].item() == p_stats[2].item()
    for a, b in zip([k_theta, *k_state, k_stats[1]],
                    [p_theta, *p_state, p_stats[1]]):
        a, b = a.double().cpu(), b.double().cpu()
        scale = max(b.abs().max().item(), 1e-30)
        assert (a - b).abs().max().item() / scale <= 1e-5


def test_sampler_runs_through_both_kernels(dev):
    rng = np.random.default_rng(0)
    X = torch.tensor(rng.normal(size=(200, 16)), dtype=torch.float32,
                     device=dev)
    y = X @ torch.ones(16, 1, device=dev)
    model = LinearRegressionModel(16)
    s = SVGDSampler(600, model.log_p, model.template(), Adam(1e-1),
                    theta=rng.normal(size=(600, 16)) * 0.1, device="cuda",
                    **throughput_config(600, 16))
    fused_median.fused_warm_median_rows.launches = 0
    fused_step.fused_warm_step_tail.launches = 0
    aux = s.run({"X": X, "y": y}, 5)
    torch.cuda.synchronize()
    assert fused_median.fused_warm_median_rows.launches == 1
    assert fused_step.fused_warm_step_tail.launches == 5
    assert all(torch.isfinite(v).all() for v in aux.values())
    assert np.isfinite(s.samples).all()


def _lattice(n, p, dev, seed=1):
    """Integer particles whose columns sum to 0: the centre, every norm and
    dot, and so D, are exact in any summation order."""
    half = np.random.default_rng(seed).integers(-3, 4, size=(n // 2, p))
    return torch.tensor(np.concatenate([half, -half]), dtype=torch.float32,
                        device=dev)


def _norm_err(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


@pytest.mark.parametrize("m,n,p,lattice", [
    (1000, 1000, 303, False), (1000, 1000, 303, True),
    (3000, 3000, 640, False), (200, 1000, 70, False),
    (500, 700, 1000, False), (400, 400, 1000, True),
])
def test_b3_against_plain(dev, m, n, p, lattice):
    """phi of the tile against its plain version: <= 1e-5 normalised on
    lattice particles, <= 1e-4 otherwise (f32 sums in other orders, D
    through exp2); two calls bitwise equal."""
    rng = np.random.default_rng(n + p)
    cols = (_lattice(n, p, dev) if lattice else torch.tensor(
        rng.normal(size=(n, p)), dtype=torch.float32, device=dev))
    rows = cols[:m] if m < n else cols
    grads = torch.tensor(rng.normal(size=(n, p)), dtype=torch.float32,
                         device=dev)
    D = fused_median.dist_block_plain(cols, cols,
                                      svgd_tile.column_center(cols))
    h2 = fused_median.warm_search_on_value(
        D, torch.zeros((), device=dev), 30) / np.log(n)
    c = svgd_tile.column_center(cols)
    got = svgd_tile.svgd_phi_rect(rows, cols, grads, h2)
    again = svgd_tile.svgd_phi_rect(rows, cols, grads, h2)
    ku, ks = svgd_tile.svgd_both_ksum_plain(rows, cols, grads, h2, c)
    want = (ku + ks * (rows - c) / h2) / n
    assert torch.equal(got, again)
    assert _norm_err(got, want) <= (1e-5 if lattice else 1e-4)
    ku_k, ks_k = svgd_tile.svgd_both_ksum(rows, cols, grads, h2, c)
    assert _norm_err(ku_k, ku) <= (1e-5 if lattice else 1e-4)
    assert _norm_err(ks_k, ks) <= (1e-5 if lattice else 1e-4)


def _tile_inputs(m, n, p, dev, seed):
    rng = np.random.default_rng(seed)
    cols = torch.tensor(rng.normal(size=(n, p)), dtype=torch.float32,
                        device=dev)
    grads = torch.tensor(rng.normal(size=(n, p)), dtype=torch.float32,
                         device=dev)
    c = svgd_tile.column_center(cols)
    D = fused_median.dist_block_plain(cols[:256], cols, c)
    h2 = fused_median.warm_search_on_value(
        D, torch.zeros((), device=dev), 30) / np.log(n)
    return cols[:m].contiguous(), cols, grads, c, h2


@pytest.mark.parametrize("div_h2", [True, False])
@pytest.mark.parametrize("p", [55, 128, 303, 1000])
def test_b3_widths_and_exponent_orders(dev, p, div_h2):
    """The tensor-core tile at m=333 against n=777 columns (m != n, a
    ragged last tile), at widths that take one output chunk (55, 128), two
    (303) and the streamed-rows chunks (1000), in B3's exponent order and
    B1's: ku and ksum <= 1e-4 normalised against the plain version of the
    same order (f32 sums in other orders, 3xTF32 products); two calls
    bitwise equal."""
    rows, cols, grads, c, h2 = _tile_inputs(333, 777, p, dev, p)
    # Past p = 128 mma.sync is forced (tile_route's is the wide route).
    route = None if p <= svgd_tile.WGMMA_ROUTE_MAX_P else svgd_tile.MMA_SYNC
    got = svgd_tile._tile(rows, cols, grads, h2, c, None, "f32", div_h2,
                          route)
    again = svgd_tile._tile(rows, cols, grads, h2, c, None, "f32", div_h2,
                            route)
    want = svgd_tile.svgd_both_ksum_plain(rows, cols, grads, h2, c, "f32",
                                          div_h2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert _norm_err(got[0], want[0]) <= 1e-4
    assert _norm_err(got[1], want[1]) <= 1e-4


def _wgmma_case(dev, m, n, p, div_h2, seed):
    """The tile's wgmma route on [m, p] rows against [n, p] columns: ku and
    ksum <= 1e-5 normalised against the plain version of the same exponent
    order (3xTF32 products, f32 sums in other orders), two calls bitwise
    equal, one wgmma launch counted a call."""
    rows, cols, grads, c, h2 = _tile_inputs(m, n, p, dev, seed)
    before = svgd_tile.svgd_both_ksum.wgmma_launches
    got = svgd_tile._tile(rows, cols, grads, h2, c, None, "f32", div_h2,
                          svgd_tile.WGMMA)
    again = svgd_tile._tile(rows, cols, grads, h2, c, None, "f32", div_h2,
                            svgd_tile.WGMMA)
    torch.cuda.synchronize()
    assert svgd_tile.svgd_both_ksum.wgmma_launches == before + 2
    want = svgd_tile.svgd_both_ksum_plain(rows, cols, grads, h2, c, "f32",
                                          div_h2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert _norm_err(got[0], want[0]) <= 1e-5
    assert _norm_err(got[1], want[1]) <= 1e-5


@pytest.mark.parametrize("div_h2", [True, False])
@pytest.mark.parametrize("p", [55, 128])
def test_b3_wgmma_widths_and_exponent_orders(dev, p, div_h2):
    """The wgmma route at m=333 against n=777 (m != n, a ragged last tile)
    at a padded width (55) and the widest it takes (128), in B3's exponent
    order and B1's."""
    _wgmma_case(dev, 333, 777, p, div_h2, p)


@pytest.mark.parametrize("div_h2", [True, False])
@pytest.mark.parametrize("p", [129, 303])
def test_b3_wide_p_refuses_the_wgmma_route(dev, p, div_h2):
    """Past p = 128 (the NN's 303) a forced wgmma route raises before any
    launch, and the tile's own route (mma.sync to p = 160, the wide route
    past it) holds the plain version at 333x777 (<= 1e-4 normalised, two
    calls bitwise)."""
    rows, cols, grads, c, h2 = _tile_inputs(333, 777, p, dev, p)
    before = svgd_tile.svgd_both_ksum.launches
    with pytest.raises(ValueError, match="p <= 128"):
        svgd_tile._tile(rows, cols, grads, h2, c, None, "f32", div_h2,
                        svgd_tile.WGMMA)
    assert svgd_tile.svgd_both_ksum.launches == before
    assert svgd_tile.tile_route(333, 777, p) == (
        svgd_tile.MMA_SYNC if p < svgd_tile.WIDE_ROUTE_MIN_P
        else svgd_tile.WIDE)
    wg = svgd_tile.svgd_both_ksum.wgmma_launches
    got = svgd_tile._tile(rows, cols, grads, h2, c, None, "f32", div_h2)
    again = svgd_tile._tile(rows, cols, grads, h2, c, None, "f32", div_h2)
    torch.cuda.synchronize()
    assert svgd_tile.svgd_both_ksum.wgmma_launches == wg
    want = svgd_tile.svgd_both_ksum_plain(rows, cols, grads, h2, c, "f32",
                                          div_h2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert _norm_err(got[0], want[0]) <= 1e-4
    assert _norm_err(got[1], want[1]) <= 1e-4


@pytest.mark.parametrize("div_h2", [True, False])
@pytest.mark.parametrize("m,n,p", [(10240, 10240, 128), (1000, 1000, 128),
                                   (2048, 8192, 64), (2048, 2048, 64),
                                   (250, 1000, 128), (500, 1000, 128)])
def test_b3_wgmma_at_the_cells_shapes(dev, m, n, p, div_h2):
    """The wgmma route at the benchmark cells' tile shapes it can take
    (n10240, B1's n1000, a 4-card mesh rank's block) and the mesh paths'
    other blocks (meshL's ring arm; n=1000 on 4 ranks and on 2), both
    exponent orders."""
    _wgmma_case(dev, m, n, p, div_h2, m + p)


@pytest.mark.parametrize("m,n,p", [(10240, 10240, 128), (1000, 1000, 128),
                                   (1000, 1000, 303), (2048, 8192, 64),
                                   (3000, 3000, 303), (333, 777, 55),
                                   (2048, 2048, 64), (250, 1000, 128),
                                   (500, 1000, 128)])
def test_b3_wgmma_launches_follow_tile_route(dev, m, n, p):
    """svgd_both_ksum takes the route tile_route names: one launch of the
    tile, and one of the wgmma route exactly where it is picked; bf16
    never."""
    rows, cols, grads, c, h2 = _tile_inputs(m, n, p, dev, 5)
    counts = (svgd_tile.svgd_both_ksum.launches,
              svgd_tile.svgd_both_ksum.wgmma_launches)
    svgd_tile.svgd_both_ksum(rows, cols, grads, h2, c)
    svgd_tile.svgd_both_ksum(rows, cols, grads, h2, c, precision="bf16")
    torch.cuda.synchronize()
    wg = int(svgd_tile.tile_route(m, n, p) == svgd_tile.WGMMA)
    assert (svgd_tile.svgd_both_ksum.launches,
            svgd_tile.svgd_both_ksum.wgmma_launches) == (counts[0] + 2,
                                                        counts[1] + wg)


def _wide_case(dev, rows, cols, grads, c, h2, div_h2):
    """The tile's wide route: ku and ksum <= 1e-4 normalised against the
    plain version of the same exponent order (3xTF32 products with each
    run of 32 indices summed in fresh registers, as mma.sync's; f32 sums
    in other orders), two calls bitwise equal, one wide launch counted a
    call."""
    before = (svgd_tile.svgd_both_ksum.launches,
              svgd_tile.svgd_both_ksum.wide_launches)
    got = svgd_tile._tile(rows, cols, grads, h2, c, None, "f32", div_h2,
                          svgd_tile.WIDE)
    again = svgd_tile._tile(rows, cols, grads, h2, c, None, "f32", div_h2,
                            svgd_tile.WIDE)
    torch.cuda.synchronize()
    assert (svgd_tile.svgd_both_ksum.launches,
            svgd_tile.svgd_both_ksum.wide_launches) == (before[0] + 2,
                                                       before[1] + 2)
    want = svgd_tile.svgd_both_ksum_plain(rows, cols, grads, h2, c, "f32",
                                          div_h2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert _norm_err(got[0], want[0]) <= 1e-4
    assert _norm_err(got[1], want[1]) <= 1e-4


@pytest.mark.parametrize("div_h2", [True, False])
@pytest.mark.parametrize("m,n,p", [(2048, 2048, 9203), (1000, 1000, 303),
                                   (333, 777, 303), (333, 777, 55),
                                   (1000, 1000, 128)])
def test_b3_wide_route_against_plain(dev, m, n, p, div_h2):
    """The wide route (D once, then B10's tile about the centre) at the
    Year network's [2048, 2048], p = 9203, the NN's [1000, 1000], p = 303,
    m != n with a ragged last tile, a padded width and B1's n1000 shape,
    in both exponent orders."""
    rows, cols, grads, c, h2 = _tile_inputs(m, n, p, dev, m + p)
    _wide_case(dev, rows, cols, grads, c, h2, div_h2)


@pytest.mark.parametrize("n,p", [(2048, 9203), (1000, 303)])
def test_b3_wide_route_phi_on_shared_rows(dev, n, p):
    """phi on the wide route where the rows are the columns (one centred
    copy in the Gram stage's prep), as SVGDSampler's step calls it: <= 1e-4
    normalised against the plain phi, two calls bitwise."""
    _, theta, grads, c, h2 = _tile_inputs(n, n, p, dev, p)
    got = svgd_tile._tile(theta, theta, grads, h2, c, n, "f32", True,
                          svgd_tile.WIDE)
    again = svgd_tile._tile(theta, theta, grads, h2, c, n, "f32", True,
                            svgd_tile.WIDE)
    ku, ks = svgd_tile.svgd_both_ksum_plain(theta, theta, grads, h2, c)
    want = (ku + ks * (theta - c) / h2) / n
    assert torch.equal(got, again)
    assert _norm_err(got, want) <= 1e-4


def test_b3_wide_route_spans_in_an_eager_call(dev):
    """An eager call on the wide route under a profiler: svgd.phi.gram and
    svgd.phi.contract in profiling.summary(), each device-timed, and the
    route's launch under its own key."""
    from stein_tpu_torch.utils import profiling

    p = svgd_tile.WIDE_ROUTE_MIN_P
    _, theta, grads, c, h2 = _tile_inputs(64, 64, p, dev, 1)
    assert svgd_tile.tile_route(64, 64, p) == svgd_tile.WIDE
    profiling.reset()
    with torch.profiler.profile():
        svgd_tile.svgd_phi(theta, grads, h2, center=c)
    s = profiling.summary()
    for name in ("svgd.phi.gram", "svgd.phi.contract"):
        assert s["spans"][name]["count"] == 1
        assert s["spans"][name]["device_s"] > 0
    assert s["counters"]["launches"]["B3-wide"] >= 1
    profiling.reset()


@pytest.mark.parametrize("rule", ["adam", "adagrad"])
def test_b1_chain_on_the_wgmma_route(dev, monkeypatch, rule):
    """B1's chain with its tile on the wgmma route (tile_route forced):
    test_b1_against_plain_on_exact_d's comparison at n=1000, p=128, and the
    chain's wgmma launch counted."""
    monkeypatch.setattr(svgd_tile, "tile_route",
                        lambda *args, **kw: svgd_tile.WGMMA)
    before = svgd_tile.svgd_both_ksum.wgmma_launches
    test_b1_against_plain_on_exact_d(dev, rule, 1000, 128, 256)
    assert svgd_tile.svgd_both_ksum.wgmma_launches == before + 1


@pytest.mark.parametrize("m,n,p", [(1000, 1000, 303), (333, 777, 128),
                                   (2048, 2048, 64)])
def test_b3_bf16_against_plain(dev, m, n, p):
    """pallas_precision='bf16': <= 1e-3 normalised against the plain bf16
    version (the same casts; another f32 summation order can move a K entry
    across a bf16 rounding boundary, measured up to 4.2e-4 on the H100),
    and against the f32 plain version at the JAX suite's bf16 class (rtol
    0.05, atol 5e-3 of max|phi|); two calls bitwise equal."""
    rows, cols, grads, c, h2 = _tile_inputs(m, n, p, dev, m + p)
    got = svgd_tile.svgd_phi_rect(rows, cols, grads, h2, precision="bf16")
    again = svgd_tile.svgd_phi_rect(rows, cols, grads, h2, precision="bf16")
    assert torch.equal(got, again)
    for prec in ("bf16", "f32"):
        ku, ks = svgd_tile.svgd_both_ksum_plain(rows, cols, grads, h2, c,
                                                prec)
        want = (ku + ks * (rows - c) / h2) / n
        if prec == "bf16":
            assert _norm_err(got, want) <= 1e-3
        else:
            torch.testing.assert_close(got, want, rtol=0.05,
                                       atol=5e-3 * want.abs().max().item())


def _lattice_rows(n, p, dev):
    """_lattice for any n: an odd n adds a zero row, so the columns still
    sum to 0 and the centre is exactly 0."""
    return torch.cat([_lattice(n - n % 2, p, dev),
                      torch.zeros(n % 2, p, device=dev)])


@pytest.mark.parametrize("m,n,p", [(128, 3000, 303), (1, 17, 7), (17, 33, 1),
                                   (33, 1000, 303), (17, 3000, 33),
                                   (1, 1, 1)])
@pytest.mark.parametrize("lattice", [True, False])
def test_b4_against_plain(dev, m, n, p, lattice):
    """The [128, 3000] block at p=303 (the n=3000 NN path's) and ragged m,
    n and p: bitwise on lattice particles, <= 1e-5 normalised otherwise;
    two calls bitwise equal."""
    theta = (_lattice_rows(n, p, dev) if lattice else torch.tensor(
        np.random.default_rng(2).normal(size=(n, p)) + 2.0,
        dtype=torch.float32, device=dev))
    rows = subsample_rows(theta, m)
    rows = theta[:m] if rows is None else rows
    c = svgd_tile.column_center(theta)
    got = fused_median.dist_block(rows, theta, c)
    again = fused_median.dist_block(rows, theta, c)
    want = fused_median.dist_block_plain(rows, theta, c)
    assert got.shape == (m, n) and torch.equal(got, again)
    if lattice:
        assert torch.equal(got, want)
    else:
        assert _norm_err(got, want) <= 1e-5


@pytest.mark.parametrize("p,fits", [(46000, True), (47000, False)])
def test_b4_width_limit(dev, p, fits):
    """B4 runs the Gram stage at B5's budget: at p = 46000 it runs (bitwise
    on lattice particles); past the ring's room for one k-step the launch
    is refused, never an unwritten block returned."""
    theta = _lattice(64, p, dev)
    rows = theta[:32]
    c = svgd_tile.column_center(theta)
    if not fits:
        with pytest.raises(RuntimeError, match="CUDA error"):
            fused_median.dist_block(rows, theta, c)
        return
    got = fused_median.dist_block(rows, theta, c)
    assert torch.equal(got, fused_median.dist_block_plain(rows, theta, c))


def test_dist_block_is_one_launch(dev):
    """Each call of B4 launches dist_block_kernel once and nothing else on
    the card (its scratch is allocated, not filled): the profiler sees only
    that kernel, at most once a call, and the count rises by one a call."""
    from torch.profiler import ProfilerActivity, profile

    theta = torch.tensor(np.random.default_rng(4).normal(size=(3000, 303)),
                         dtype=torch.float32, device=dev)
    rows = subsample_rows(theta, 128)
    c = svgd_tile.column_center(theta)
    fused_median.dist_block(rows, theta, c)
    torch.cuda.synchronize()
    calls, before = 20, fused_median.dist_block.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fused_median.dist_block(rows, theta, c)
        torch.cuda.synchronize()
    assert fused_median.dist_block.launches == before + calls
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names and all("dist_block_kernel" in k for k in names), set(names)
    assert len(names) <= calls


@pytest.mark.parametrize("lattice", [True, False])
def test_b5_against_plain(dev, lattice):
    """Gram and warm search in one launch at (128, 1000, 303): bitwise on
    lattice particles; otherwise within one final interval of the tight
    bracket, (1.09 - 0.92) hint / 4^4."""
    n, p = 1000, 303
    theta = (_lattice(n, p, dev) if lattice else torch.tensor(
        np.random.default_rng(3).normal(size=(n, p)) * 0.01,
        dtype=torch.float32, device=dev))
    rows = subsample_rows(theta, 128)
    c = svgd_tile.column_center(theta)
    zero = torch.zeros((), device=dev)
    for hint, passes in ((None, 30), (1.01, 8)):
        cold = fused_median.fused_warm_median_from_theta(rows, theta, zero,
                                                         c, passes)
        med_prev = zero if hint is None else cold * hint
        got = fused_median.fused_warm_median_from_theta(rows, theta,
                                                        med_prev, c, passes)
        want = fused_median.warm_search_on_value(
            fused_median.dist_block_plain(rows, theta, c), med_prev, passes)
        if lattice:
            assert got.item() == want.item()
        elif hint is not None:
            width = (1.09 - 0.92) * med_prev.item() / 4 ** 4
            assert abs(got.item() - want.item()) <= width * 1.0001


@pytest.mark.parametrize("p,fits", [(46000, True), (47000, False)])
def test_b5_width_limit(dev, p, fits):
    """The Gram stage's ring stage holds at least one k-step of 8 indices
    beside the centre: at p = 46000 it runs (bitwise on lattice
    particles); past that room the launch is refused, never searched on
    an unwritten block."""
    theta = _lattice(64, p, dev)
    rows = theta[:32]
    c = svgd_tile.column_center(theta)
    zero = torch.zeros((), device=dev)
    if not fits:
        with pytest.raises(RuntimeError, match="CUDA error"):
            fused_median.fused_warm_median_from_theta(rows, theta, zero, c, 30)
        return
    got = fused_median.fused_warm_median_from_theta(rows, theta, zero, c, 30)
    want = fused_median.warm_search_on_value(
        fused_median.dist_block_plain(rows, theta, c), zero, 30)
    assert got.item() == want.item()


# B7's shapes: the NN path's and a second (f, H, B); every class of its
# grid (one particle or a ragged last block, H not a multiple of 32,
# several features, B past the 20-observation chunk); teams of 5-8 warps
# a particle with one unit a thread (H=200) and several (H=300); the Year
# network's (f = 90, B = 100: five chunks, 90 weights a thread).
_B7_SHAPES = [(1000, 20, 1, 100), (600, 12, 3, 50)] + [
    (n, B, f, H) for n in (1, 7, 1000, 3000) for H in (33, 100, 128)
    for f in (1, 3) for B in (1, 20, 64) if (n, B, f, H) != (1000, 20, 1, 100)
] + [(n, B, f, H) for n in (7, 1000) for H in (200, 300) for f in (1, 3)
     for B in (20, 64)] + [(2048, 100, 90, 100), (7, 100, 90, 100)]


@pytest.mark.parametrize("n,B,f,H", _B7_SHAPES)
def test_b7_against_plain(dev, n, B, f, H):
    """logp rtol 2e-5 / atol 1e-5, grads atol 2e-5 max|g| (the JAX suite's
    test_pallas_grads_match_autodiff); one launch a call, two calls
    bitwise."""
    rng = np.random.default_rng(0 if (n, B, f, H) in _B7_SHAPES[:2]
                                else n + H + f + B)
    model = BayesianNNModel(f, H, n_train=5 * B, n_batch=B, prior_beta=10.0)
    p = f * H + 2 * H + 3
    theta = torch.tensor(rng.normal(size=(n, p)) * 0.3, dtype=torch.float32,
                         device=dev)
    X = rng.uniform(size=(B, f))
    y = np.cos(10 * X[:, :1]) * (5 * X[:, :1]) + rng.normal(size=(B, 1)) * .1
    batch = {"X": torch.tensor(X, dtype=torch.float32, device=dev),
             "y": torch.tensor(y, dtype=torch.float32, device=dev)}
    launches = bayesian_nn.nn_grads.launches
    lp, g = model.pallas_grads()(theta, batch)
    assert bayesian_nn.nn_grads.launches == launches + 1
    again = model.pallas_grads()(theta, batch)
    lp_ref, g_ref = bayesian_nn.nn_grads_plain(
        theta, batch["X"], batch["y"].reshape(-1), f, H, model._consts())
    torch.testing.assert_close(lp, lp_ref, rtol=2e-5, atol=1e-5)
    scale = g_ref.abs().max().item()
    torch.testing.assert_close(g, g_ref, rtol=0, atol=2e-5 * scale)
    assert torch.equal(lp, again[0]) and torch.equal(g, again[1])


def test_nn_sampler_runs_through_its_kernels(dev):
    rng = np.random.default_rng(11)
    X = rng.uniform(size=(20, 1))
    y = rng.normal(np.cos(10 * X) * (5 * X), 0.1)
    model = BayesianNNModel(1, 100, 20, 20, prior_beta=10.0)
    s = SVGDSampler(1000, model.log_p, model.template(), Adam(0.1),
                    theta=rng.normal(size=(1000, 303)) * 0.01,
                    device="cuda", **throughput_config(1000, 303,
                                                       model=model))
    counts = (bayesian_nn.nn_grads, svgd_tile.svgd_both_ksum,
              fused_median.fused_warm_median_from_theta)
    for fn in counts:
        fn.launches = 0
    aux = s.run({"X": torch.tensor(X, dtype=torch.float32, device=dev),
                 "y": torch.tensor(y, dtype=torch.float32, device=dev)}, 5)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counts] == [5, 5, 6]
    assert all(torch.isfinite(v).all() for v in aux.values())


def _state(rule, n, p, dev, count=5):
    nu = torch.ones(n, p, device=dev)
    c = torch.full((), count, dtype=torch.int32, device=dev)
    lr = torch.full((), 0.1, device=dev)
    if rule == "adam":
        return Adam(1e-1, decay=0.99), AdamState(torch.zeros_like(nu), nu, c,
                                                 lr)
    return Adagrad(5e-2), AdagradState(nu, c, lr)


def _logistic_operands(n, d, N, dev, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, d))
    y = (X @ rng.normal(size=(d, 1)) > 0).astype(np.float64)
    model = LogisticRegressionModel(d, 581012, N)
    batch = {"X": torch.tensor(X, dtype=torch.float32, device=dev),
             "y": torch.tensor(y, dtype=torch.float32, device=dev)}
    theta = torch.tensor(rng.normal(size=(n, d + 1)) * 0.1,
                         dtype=torch.float32, device=dev)
    return model.inkernel_model(batch), theta


@pytest.mark.parametrize("p", [37, 128, 303])
@pytest.mark.parametrize("n", [50, 333, 1000])
def test_glm_stage_against_plain(dev, n, p):
    """logp rtol 2e-5 / atol 1e-5 of max|logp|, grads <= 2e-5 max|g| (B7's
    bounds: f32 sums in another order); two calls bitwise equal."""
    rng = np.random.default_rng(n + p)
    X = rng.normal(size=(2 * p, p))
    A = torch.tensor(X.T @ X + np.eye(p), dtype=torch.float32, device=dev)
    b = torch.tensor(rng.normal(size=(1, p)), dtype=torch.float32, device=dev)
    theta = torch.tensor(rng.normal(size=(n, p)) * 0.1, dtype=torch.float32,
                         device=dev)
    launches = model_grad.glm_grads.launches
    g, lp = model_grad.glm_grads(theta, A, b)
    g2, lp2 = model_grad.glm_grads(theta, A, b)
    assert model_grad.glm_grads.launches == launches + 2
    g0, lp0 = model_grad.glm_grads_plain(theta, A, b)
    assert torch.equal(g, g2) and torch.equal(lp, lp2)
    torch.testing.assert_close(lp, lp0, rtol=2e-5,
                               atol=1e-5 * lp0.abs().max().item())
    assert (g - g0).abs().max().item() <= 2e-5 * g0.abs().max().item()


@pytest.mark.parametrize("n,d,N", [(1000, 54, 50), (300, 6, 40),
                                   (97, 200, 33)] + [
    (n, d, N) for n in (1, 7, 1000) for N in (1, 64, 100)
    for d in (1, 100, 200)])
def test_logistic_stage_against_plain(dev, n, d, N):
    """The Covertype shape (n=1000, p=55, N=50) and others: a ragged last
    block of particles (n 1, 7, 97, 300); each split of a product's
    contraction, four lanes (N 1, 40, 50, 64; p 2, 7, 55), two (N 100; p
    101) and one (p 201); at the same bounds (the gradients carry
    n_train/n_batch, so they are held relative to max|g|); one launch a
    call, two calls bitwise equal."""
    ikm, theta = _logistic_operands(n, d, N, dev)
    launches = model_grad.logistic_grads.launches
    g, lp = ikm.grad_fn(theta, *ikm.operands)
    g2, lp2 = ikm.grad_fn(theta, *ikm.operands)
    assert model_grad.logistic_grads.launches == launches + 2
    assert torch.equal(g, g2) and torch.equal(lp, lp2)
    g0, lp0 = ikm.grad_fn.plain(theta, *ikm.operands)
    torch.testing.assert_close(lp, lp0, rtol=2e-5,
                               atol=1e-5 * lp0.abs().max().item())
    assert (g - g0).abs().max().item() <= 2e-5 * g0.abs().max().item()


@pytest.mark.parametrize("m,n,p", [(1000, 1000, 128), (333, 777, 50),
                                   (200, 500, 300), (1000, 1000, 303)])
def test_b10_against_plain(dev, m, n, p):
    """ku and ksum <= 1e-5 normalised against the plain version (f32 sums
    in another order, exp2f), two calls bitwise equal."""
    rng = np.random.default_rng(m + n + p)
    theta = torch.tensor(rng.normal(size=(n, p)), dtype=torch.float32,
                         device=dev)
    D = pairwise_sq_dists(theta)[:m].contiguous()
    h2 = fused_median.warm_search_on_value(D, torch.zeros((), device=dev),
                                           30) / np.log(n)
    u = torch.tensor(rng.normal(size=(n, p)), dtype=torch.float32,
                     device=dev) - theta / h2
    ku, ks = svgd_tile.svgd_both_ksum_on_D(D, u, h2)
    ku2, ks2 = svgd_tile.svgd_both_ksum_on_D(D, u, h2)
    ku0, ks0 = svgd_tile.svgd_both_ksum_on_D_plain(D, u, h2)
    assert torch.equal(ku, ku2) and torch.equal(ks, ks2)
    assert _norm_err(ku, ku0) <= 1e-5 and _norm_err(ks, ks0) <= 1e-5


@pytest.mark.parametrize("n,p", [(1000, 303), (1000, 128), (259, 40)])
def test_b10_with_u_formed_about_a_centre(dev, n, p):
    """B10's tile as B12's chain runs it (u = g - (theta - c) / h^2 formed
    in the kernel, the step tails' exponent order) on the centred D: <=
    1e-5 normalised, two calls bitwise; at n=1000 the grid covers the 132
    SMs."""
    from stein_tpu_torch import _cuda

    rng = np.random.default_rng(n + p)
    theta = torch.tensor(rng.normal(size=(n, p)), dtype=torch.float32,
                         device=dev)
    grads = torch.tensor(rng.normal(size=(n, p)), dtype=torch.float32,
                         device=dev)
    c = svgd_tile.column_center(theta)
    D = fused_median.dist_block_plain(theta, theta, c)
    h2 = fused_median.warm_search_on_value(D, torch.zeros((), device=dev),
                                           30) / np.log(n)
    args = (D, grads, theta, c, h2)
    ku, ks = svgd_tile.svgd_both_ksum_on_D_about(*args)
    ku2, ks2 = svgd_tile.svgd_both_ksum_on_D_about(*args)
    ku0, ks0 = svgd_tile.svgd_both_ksum_on_D_about_plain(*args)
    assert torch.equal(ku, ku2) and torch.equal(ks, ks2)
    assert _norm_err(ku, ku0) <= 1e-5 and _norm_err(ks, ks0) <= 1e-5
    if n == 1000:
        assert _cuda.library().lib.stein_on_d_blocks(n, n, p) >= 132


@pytest.mark.parametrize("hint,passes", [(0.0, 30), (1.01, 8), (0.5, 7),
                                         (1.3, 30)])
def test_b2_bitwise_with_eight_brackets(dev, hint, passes):
    """The kernel's limit of 8 brackets (16 pass-1 counts), cold at 30
    passes (15 rounds: 7 swept in pairs, one alone) and warm."""
    brackets = tuple((1.0 - 0.1 * (i + 1), 1.0 + 0.15 * (i + 1))
                     for i in range(8))
    rng = np.random.default_rng(4)
    theta = torch.tensor(rng.normal(size=(1000, 64)), dtype=torch.float32,
                         device=dev)
    D = row_subsample_block(theta, 256)
    med0 = fused_median.warm_search_on_value(
        D, torch.zeros((), device=dev), 30)
    med_prev = med0 * hint
    got = fused_median.fused_warm_median_rows(D, med_prev, passes, brackets)
    want = fused_median.warm_search_on_value(D, med_prev, passes, brackets)
    assert got.item() == want.item()
    assert fused_median.warm_search_folded(D, med_prev, passes,
                                           brackets).item() == want.item()


@pytest.mark.parametrize("rule", ["adam", "adagrad"])
def test_b6_against_plain(dev, rule):
    """The large-n epilogue at n=10240, p=128: rtol 2e-6 (the JAX suite's
    bound for the epilogue), the clip active."""
    n, p = 10240, 128
    rng = np.random.default_rng(7)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa
    theta = t(rng.normal(size=(n, p)))
    ku, ksum = t(rng.normal(size=(n, p))), t(rng.uniform(1, 2, (n, 1)))
    center = theta.mean(0, keepdim=True)
    gd, state = _state(rule, n, p, dev)
    norm = torch.full((), 40.0, device=dev)
    h2 = torch.full((), 0.7, device=dev)
    got = fused_step.fused_epilogue(ku, ksum, theta, center, h2, norm, state,
                                    gd, n_total=n)
    want = fused_step.fused_epilogue_plain(ku, ksum, theta, center, h2, norm,
                                           state, gd, 10.0, n)
    for a, b in zip([got[0], *got[1]], [want[0], *want[1]]):
        torch.testing.assert_close(a, b, rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("rule", ["adam", "adagrad"])
@pytest.mark.parametrize("kind", ["glm", "logistic", "d_given"])
def test_b1_branches_against_plain(dev, rule, kind):
    """B1's model and D-given chains against _plain_tail's forms. glm and
    D-given on lattice particles (glm with an integer A and b, so the
    gradients are exact too): median and h^2 bitwise, the rest <= 1e-5
    normalised. Logistic, on random particles (D from two dot orders, as
    on the main path's inputs): the median within one final interval of
    the tight bracket, the rest <= 1e-2 normalised."""
    n, p, rows = 1000, 128, 128
    model, D, D_sub, grads = None, None, None, None
    rng = np.random.default_rng(2)
    if kind == "logistic":
        model, theta = _logistic_operands(n, 54, 50, dev)
        p = 55
    else:
        theta = _lattice(n, p, dev)
    if kind == "glm":
        A = torch.tensor(rng.integers(-2, 3, size=(p, p)), dtype=torch.float32,
                         device=dev)
        b = torch.tensor(rng.integers(-3, 4, size=(p,)), dtype=torch.float32,
                         device=dev)
        model = fused_step.InKernelModel((A + A.T, b.reshape(1, p)),
                                         model_grad.GlmGrad())
    if kind == "d_given":
        D = pairwise_sq_dists(theta)
        D_sub = _strided_rows(D, rows)
        grads = torch.tensor(rng.normal(size=(n, p)), dtype=torch.float32,
                             device=dev)
        sub = None
    else:
        sub = subsample_rows(theta, rows)
    gd, state = _state(rule, n, p, dev)
    med_prev = fused_median.warm_search_on_value(
        D_sub if D is not None else row_subsample_block(theta, rows),
        torch.zeros((), device=dev), 30)
    k = fused_step.fused_warm_step_tail(
        theta, grads, D, D_sub, med_prev, state, gd,
        gram_in_kernel=D is None, theta_sub=sub, model=model)
    q = fused_step._plain_tail(theta, grads, sub, med_prev, state, gd, 10.0,
                               8, fused_step.DEFAULT_BRACKETS, D=D,
                               D_sub=D_sub, model=model)
    assert len(k[2]) == len(q[2]) == (3 if model is None else 4)
    if kind == "logistic":
        width = (1.09 - 0.92) * med_prev.item() / 4 ** 4
        assert abs(k[2][0].item() - q[2][0].item()) <= width * 1.0001
        bound = 1e-2
    else:
        assert k[2][0].item() == q[2][0].item()
        assert k[2][2].item() == q[2][2].item()
        bound = 1e-5
    for a, b in zip([k[0], *k[1], *k[2]], [q[0], *q[1], *q[2]]):
        assert _norm_err(a, b) <= bound


def test_new_paths_run_through_their_kernels(dev):
    """fused_glm, fused_model, fused and epilogue samplers: five steps
    each, with each path's launch counts."""
    rng = np.random.default_rng(0)
    f32 = torch.float32
    X = torch.tensor(rng.normal(size=(200, 16)), dtype=f32, device=dev)
    lr_batch = {"X": X, "y": X @ torch.ones(16, 1, device=dev)}
    lin = LinearRegressionModel(16)
    ikm_model = LogisticRegressionModel(15, 1000, 50)
    Xl = rng.normal(size=(50, 15))
    log_batch = {"X": torch.tensor(Xl, dtype=f32, device=dev),
                 "y": torch.tensor((Xl.sum(1, keepdims=True) > 0) * 1.0,
                                   dtype=f32, device=dev)}
    counters = (model_grad.glm_grads, model_grad.logistic_grads,
                fused_step.fused_warm_step_tail,
                svgd_tile.svgd_both_ksum_on_D, svgd_tile.svgd_both_ksum,
                fused_step.fused_epilogue, fused_median.fused_warm_median_rows)
    cases = [
        (lin, lin.sufficient_batch(lr_batch), 600,
         throughput_config(600, 16, model=lin), [5, 0, 5, 0, 0, 0, 0]),
        (ikm_model, log_batch, 600,
         throughput_config(600, 16, model=ikm_model), [0, 5, 5, 0, 0, 0, 0]),
        (lin, lr_batch, 600,
         dict(throughput_config(600, 16), step_impl="fused"),
         [0, 0, 5, 5, 0, 0, 1]),
        (lin, lr_batch, 4096,
         dict(throughput_config(4096, 16), step_impl="epilogue"),
         [0, 0, 0, 0, 5, 5, 6]),
    ]
    for model, batch, n, cfg, want in cases:
        s = SVGDSampler(n, model.log_p, model.template(), Adam(1e-1),
                        theta=rng.normal(size=(n, 16)) * 0.1, device="cuda",
                        **cfg)
        for fn in counters:
            fn.launches = 0
        aux = s.run(batch, 5)
        torch.cuda.synchronize()
        assert [fn.launches for fn in counters] == want, cfg["step_impl"]
        assert all(torch.isfinite(v).all() for v in aux.values())
        assert np.isfinite(s.samples).all()


def _bracket_inputs(dev, kind, m, n, p, seed=4):
    rng = np.random.default_rng(seed)
    if kind == "lattice":
        half = rng.integers(-3, 4, size=(n // 2, p))
        cols = np.concatenate([half, -half])
        rows = cols[:: max(n // m, 1)][:m]
    else:
        cols = rng.normal(size=(n, p)) * 0.3 + 1.0
        rows = rng.normal(size=(m, p)) * 0.3 + 1.0
    cols = torch.tensor(cols, dtype=torch.float32, device=dev)
    rows = torch.tensor(rows, dtype=torch.float32, device=dev)
    c = svgd_tile.column_center(cols)
    hib = 4.0 * torch.max(torch.sum((cols - c) ** 2, dim=1)) * 1.0001 + 1e-30
    med = fused_median.dist_block_plain(rows, cols, c).median() * 1.01
    return rows, cols, c, med, hib


@pytest.mark.parametrize("kind,m,n,p", [
    ("lattice", 256, 1000, 128), ("normal", 256, 1000, 128),
    ("normal", 256, 1000, 303), ("normal", 64, 250, 128),
    ("lattice", 48, 200, 40), ("normal", 1, 1, 1), ("normal", 1, 1, 303),
    ("lattice", 64, 1000, 128), ("normal", 64, 1000, 128)])
def test_b8_b9_against_plain(dev, kind, m, n, p):
    """B8 and B9 against their plain versions: on lattice particles D, mm
    and the counts bitwise; otherwise D <= 1e-5 normalised, and the counts
    and mm those of the kernel's own D, bitwise; two calls bitwise."""
    rows, cols, c, med, hib = _bracket_inputs(dev, kind, m, n, p)
    D, mm, cnts = fused_median.fused_bracket_pass(rows, cols, med, c)
    again = fused_median.fused_bracket_pass(rows, cols, med, c)
    G, gcnts = fused_median.fused_bracket_grid_pass(rows, cols, med, c, hib,
                                                    g1=8)
    torch.cuda.synchronize()
    Dp, mmp, cp = fused_median.fused_bracket_pass_plain(rows, cols, med, c)
    _, gp = fused_median.fused_bracket_grid_pass_plain(rows, cols, med, c,
                                                       hib, g1=8)
    assert all(torch.equal(a, b) for a, b in zip((D, mm, cnts), again))
    assert torch.equal(D, G)
    ends = fused_median._bracket_ends(med, fused_median.DEFAULT_BRACKETS)
    edges = fused_median.grid_edges(med, hib, fused_median.DEFAULT_BRACKETS,
                                    8)
    assert torch.equal(cnts, fused_median.count_le(D, ends))
    assert torch.equal(gcnts, fused_median.count_le(D, edges))
    assert torch.equal(mm, torch.stack([-torch.clamp(D.min(), max=0.0),
                                        D.max()]))
    if kind == "lattice":
        assert torch.equal(D, Dp) and torch.equal(mm, mmp)
        assert torch.equal(cnts, cp) and torch.equal(gcnts, gp)
    else:
        err = ((D - Dp).abs().max() / Dp.abs().max()).item()
        assert err <= 1e-5, err


F32_MAX = float(np.finfo(np.float32).max)
F32_TINY = float(np.finfo(np.float32).smallest_subnormal)


@pytest.mark.parametrize("g1", [1, 3, 8, 16])
@pytest.mark.parametrize("med,hib", [
    (None, None), (0.0, 0.0), (0.0, 5.0), (F32_TINY, 7 * F32_TINY),
    (2.5e-39, 1e-38), (1e30, 3e38), (0.731, 0.99 * F32_MAX),
    (0.5 * F32_MAX, F32_MAX)])
def test_bracket_pass_edges_bitwise(dev, g1, med, hib):
    """The thresholds the kernel forms and counts at: B9's equal
    ``grid_edges`` bitwise (down to the NaN of an inf - inf at the f32
    range's end), B8's the bracket endpoints; the counts are those of the
    kernel's D at them."""
    rows, cols, c, med0, hib0 = _bracket_inputs(dev, "normal", 64, 250, 16)
    med = med0 if med is None else torch.tensor(med, device=dev)
    hib = hib0 if hib is None else torch.tensor(hib, device=dev)
    br = fused_median.DEFAULT_BRACKETS
    D, _, cnts, thr = fused_median._launch_bracket(rows, cols, c, med, br,
                                                   hib, g1)
    D8, _, cnts8, thr8 = fused_median._launch_bracket(rows, cols, c, med, br)
    torch.cuda.synchronize()
    edges = fused_median.grid_edges(med, hib, br, g1)
    assert torch.equal(thr.view(torch.int32), edges.view(torch.int32))
    ends = fused_median._bracket_ends(med, br)
    assert torch.equal(thr8.view(torch.int32), ends.view(torch.int32))
    assert torch.equal(cnts, fused_median.count_le(D, edges))
    assert torch.equal(cnts8, fused_median.count_le(D8, ends))


@pytest.mark.parametrize("grid", [False, True])
def test_bracket_pass_is_one_launch(dev, monkeypatch, grid):
    """Each call of B8 or B9 launches bracket_kernel once and nothing else
    on the card (B9 forms no thresholds by torch ops): the profiler sees
    only that kernel, at most once a call, and each wrapper's count rises
    by one a call."""
    from torch.profiler import ProfilerActivity, profile

    rows, cols, c, med, hib = _bracket_inputs(dev, "normal", 256, 1000, 128)

    def no_torch_edges(*args, **kw):
        raise AssertionError("grid_edges ran on the card's path")

    monkeypatch.setattr(fused_median, "grid_edges", no_torch_edges)
    fn = fused_median.fused_bracket_grid_pass if grid else \
        fused_median.fused_bracket_pass
    args = (rows, cols, med, c, hib) if grid else (rows, cols, med, c)
    fn(*args)
    torch.cuda.synchronize()
    calls, before = 20, fn.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    assert fn.launches == before + calls
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names and all("bracket_kernel" in k for k in names), set(names)
    assert len(names) <= calls


def test_bracket_pass_guards_on_the_card(dev):
    """The kernel's limits still raise: 8 brackets, 2048 thresholds."""
    rows, cols, c, med, hib = _bracket_inputs(dev, "normal", 16, 64, 8)
    nine = tuple((0.5, 1.5) for _ in range(9))
    with pytest.raises(ValueError, match="8 brackets"):
        fused_median.fused_bracket_pass(rows, cols, med, c, nine)
    with pytest.raises(ValueError, match="2048"):
        fused_median.fused_bracket_grid_pass(rows, cols, med, c, hib,
                                             g1=1024)
    eight = tuple((0.5 + 0.01 * i, 1.5) for i in range(8))
    D, cnts = fused_median.fused_bracket_grid_pass(rows, cols, med, c, hib,
                                                   eight, g1=226)
    torch.cuda.synchronize()
    assert cnts.numel() == 9 * 227
    assert torch.equal(cnts, fused_median.count_le(
        D, fused_median.grid_edges(med, hib, eight, 226)))


def test_default_device_is_cuda0(dev):
    """No device given: the sampler and state_from_numpy take cuda:0."""
    from stein_tpu_torch.utils.convert import state_from_numpy

    m = LinearRegressionModel(4)
    s = SVGDSampler(8, m.log_p, m.template(), Adam(0.1))
    assert s.device == torch.device("cuda", 0)
    assert s.state.particles.device == torch.device("cuda", 0)
    st = state_from_numpy(np.zeros((8, 4), np.float32), {
        "hist": np.zeros((8, 4), np.float32), "count": 0,
        "learning_rate": np.float32(0.1)}, 0)
    assert st.particles.device == torch.device("cuda", 0)


def test_one_rank_nccl_fused_shard_at_the_class(dev):
    """step_impl='fused_shard' on a one-rank NCCL group, 5 steps of
    throughput_config(1000, 128, mesh=) against the same sampler on a gloo
    group on the CPU (the plain versions), at the fused_gram class
    (medians rtol 5e-3, samples rtol 2e-4 / atol 1e-6, phi_norm 1e-4); B8
    runs once per step."""
    import torch.distributed as dist

    from stein_tpu_torch.parallel import particle_mesh, setup_distributed

    setup_distributed("nccl", store=dist.HashStore(), world_size=1, rank=0,
                      device_id=dev)
    try:
        mesh = particle_mesh()
        cpu_mesh = particle_mesh(dist.new_group(backend="gloo"))
        rng = np.random.default_rng(0)
        X = rng.normal(size=(1000, 128))
        y = X @ rng.normal(size=(128, 1)) + rng.normal(size=(1000, 1)) * 0.3
        theta0 = rng.normal(size=(1000, 128)) * 0.01
        model = LinearRegressionModel(128)
        batch = {"X": torch.tensor(X, dtype=torch.float32),
                 "y": torch.tensor(y, dtype=torch.float32)}
        cfg = throughput_config(1000, 128, mesh=mesh)
        assert cfg["step_impl"] == "fused_shard"
        assert cfg["median_collectives"] == "rounds"
        runs = {}
        for d, m_ in (("cuda", mesh), ("cpu", cpu_mesh)):
            s = SVGDSampler(1000, model.log_p, model.template(), Adam(0.1),
                            theta=theta0, device=d, **dict(cfg, mesh=m_))
            fused_median.fused_bracket_pass.launches = 0
            aux = s.run({k: v.to(d) for k, v in batch.items()}, 5)
            runs[d] = (s.samples, {k: v.cpu().numpy() for k, v in
                                   aux.items()},
                       fused_median.fused_bracket_pass.launches)
        (gs, ga, glaunch), (cs, ca, _) = runs["cuda"], runs["cpu"]
        assert glaunch == 5
        np.testing.assert_allclose(ga["median"], ca["median"], rtol=5e-3)
        np.testing.assert_allclose(ga["phi_norm"], ca["phi_norm"], rtol=1e-4)
        np.testing.assert_allclose(gs, cs, rtol=2e-4, atol=1e-6)
    finally:
        dist.destroy_process_group()


def _sym_h2(theta, dev):
    """The median heuristic on a 128-row block, as the smoke's B11 cases
    take h^2 (0.7, the JAX suite's B11 value, for a single particle)."""
    n = theta.shape[0]
    if n < 2:
        return torch.full((), 0.7, device=dev)
    return fused_median.warm_search_on_value(
        row_subsample_block(theta, 128), torch.zeros((), device=dev),
        30) / np.log(n)


# The [large-n-sym] path's shape (n=10240, p=128), the NN shape, n=2048; off
# the origin, |theta| 3.8-5.3; n and p that fill no tile, no unit and no
# output group (n 1, 129, 257 x p 1, 7, 130); and lattice particles.
@pytest.mark.parametrize("n,p,shift,bound", [
    (10240, 128, 0.0, 1e-5), (1000, 303, 0.0, 1e-5), (2048, 64, 0.0, 1e-5),
    (300, 130, 0.25, 1e-4),
    *[(n, p, 0.0, 1e-5) for n in (1, 129, 257) for p in (1, 7, 130)],
    (1000, 64, "lattice", 1e-6), (512, 130, "lattice", 1e-6)])
def test_b11_against_plain(dev, n, p, shift, bound):
    """B11 (svgd_phi_sym) against its plain version: 1e-5 normalised near
    the origin, 1e-4 off it (B11 does not centre); two calls bitwise; the
    launch counted once per call. On lattice particles D is exact in f32 in
    any summation order (and in 3xTF32: integers of at most 11 bits are
    exact in tf32), so both form the same K and phi differs by the
    contraction's order only: 1e-6."""
    if shift == "lattice":
        theta = _lattice(n, p, dev)
        t64 = theta.double()
        rsq = (theta * theta).sum(1, keepdim=True)
        d32 = rsq + rsq.T - 2.0 * theta @ theta.T
        assert torch.equal(d32.double(),
                           ((t64[:, None] - t64[None]) ** 2).sum(-1))
    else:
        rng = np.random.default_rng(n + p)
        theta = torch.tensor(rng.normal(size=(n, p)) * 0.3 + shift,
                             dtype=torch.float32, device=dev)
    grads = torch.randn_like(theta)
    h2 = _sym_h2(theta, dev)
    svgd_tile.svgd_phi_sym.launches = 0
    got = svgd_tile.svgd_phi_sym(theta, grads, h2)
    again = svgd_tile.svgd_phi_sym(theta, grads, h2)
    want = svgd_tile.svgd_phi_sym_plain(theta, grads, h2)
    torch.cuda.synchronize()
    assert svgd_tile.svgd_phi_sym.launches == 2
    assert torch.equal(got, again)
    assert bool(got.isfinite().all())
    assert _norm_err(got, want) <= bound


@pytest.mark.parametrize("n,p", [(1000, 303), (2048, 64)])
def test_b11_deterministic(dev, monkeypatch, n, p):
    """Ten calls give the same bits, and so do grids of one and of seven
    blocks (svgd_tile.SYM_BLOCKS): the slices add their contributions in
    slot order whatever block takes whatever unit."""
    rng = np.random.default_rng(n)
    theta = torch.tensor(rng.normal(size=(n, p)) * 0.3, dtype=torch.float32,
                         device=dev)
    grads = torch.randn_like(theta)
    first = svgd_tile.svgd_phi_sym(theta, grads, 0.7)
    calls = [svgd_tile.svgd_phi_sym(theta, grads, 0.7) for _ in range(9)]
    for blocks in (1, 7):
        monkeypatch.setattr(svgd_tile, "SYM_BLOCKS", blocks)
        calls.append(svgd_tile.svgd_phi_sym(theta, grads, 0.7))
    torch.cuda.synchronize()
    assert all(torch.equal(first, c) for c in calls)


@pytest.mark.parametrize("rule", ["adam", "adagrad"])
@pytest.mark.parametrize("n,p", [(1000, 303), (259, 40)])
def test_b12_against_plain(dev, rule, n, p):
    """B12 (fused_warm_step_pblock) against _plain_tail with every row kept,
    on lattice particles (D exact in any order), cold and warm: median and
    h^2 bitwise, the rest <= 1e-5 normalised."""
    theta = _lattice(n - n % 2, p, dev)
    n = theta.shape[0]
    grads = torch.randn_like(theta)
    gd, state = _state(rule, n, p, dev)
    med_prev = torch.zeros((), device=dev)
    for _ in ("cold", "warm"):
        fused_step.fused_warm_step_pblock.launches = 0
        k = fused_step.fused_warm_step_pblock(theta, grads, med_prev, state,
                                              gd)
        q = fused_step._plain_tail(theta, grads, None, med_prev, state, gd,
                                   10.0, 8, fused_step.DEFAULT_BRACKETS)
        torch.cuda.synchronize()
        assert fused_step.fused_warm_step_pblock.launches == 1
        assert k[2][0].item() == q[2][0].item()
        assert k[2][2].item() == q[2][2].item()
        for a, b in zip([k[0], *k[1], *k[2]], [q[0], *q[1], *q[2]]):
            assert _norm_err(a, b) <= 1e-5
        med_prev = q[2][0] * 1.01


def test_new_defaults_land_on_the_current_card(dev):
    """No device given: Adam.init, Adagrad.init and init_particles (without
    a generator) take cuda:<current>."""
    from stein_tpu_torch.utils.ravel import init_particles

    here = torch.device("cuda", torch.cuda.current_device())
    for gd in (Adam(0.1), Adagrad(0.1)):
        assert all(t.device == here for t in gd.init((4, 3)))
    assert init_particles(None, 4, 3).device == here


def _logistic_on_card(dev, n_rows=2000, d=15, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_rows, d))
    data = {"X": torch.tensor(X, dtype=torch.float32, device=dev),
            "y": torch.tensor((X.sum(1, keepdims=True) > 0) * 1.0,
                              dtype=torch.float32, device=dev)}
    model = LogisticRegressionModel(d, n_rows, 50)
    theta0 = rng.normal(size=(1000, d + 1)) * 0.1
    cfg = throughput_config(1000, d + 1, model=model)

    def make():
        return SVGDSampler(1000, model.log_p, model.template(), Adam(1e-1),
                           theta=theta0, device="cuda", **cfg)
    return data, make


def test_train_minibatched_on_the_card(dev):
    """train_minibatched through fused_model on the card (the logistic
    stage and B1 every step, B2 once): bitwise equal to train_on_batches on
    the batches minibatch_indices draws for the same key, and to a second
    call from the same state and key."""
    from stein_tpu_torch.api import minibatch_indices

    data, make = _logistic_on_card(dev)
    counters = (model_grad.logistic_grads, fused_step.fused_warm_step_tail,
                fused_median.fused_warm_median_rows)
    a, b, c = make(), make(), make()
    for fn in counters:
        fn.launches = 0
    aux = a.train_minibatched(data, 20, 50, 7)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counters] == [20, 20, 1]
    idx = minibatch_indices(7, 20, 50, 2000, dev)
    assert idx.device == dev
    aux_b = b.train_on_batches({k: v[idx] for k, v in data.items()})
    c.train_minibatched(data, 20, 50, 7)
    assert np.array_equal(a.samples, b.samples)
    assert np.array_equal(a.samples, c.samples)
    for key in aux:
        assert torch.equal(aux[key], aux_b[key])
    assert a.train_minibatched(data, 0, 50, 7)["phi_norm"].shape == (0,)


def test_checkpoint_round_trip_on_the_card(dev, tmp_path):
    """save then restore on the card: a fresh sampler resumes bitwise, and
    its leaves lie on the card."""
    data, make = _logistic_on_card(dev)
    batch = {k: v[:50] for k, v in data.items()}
    a = make()
    a.run(batch, 5)
    a.save(tmp_path / "card.npz")
    a.run(batch, 5)
    b = make()
    b.restore(tmp_path / "card.npz")
    assert b.state.particles.device == dev and int(b.state.step) == 5
    b.run(batch, 5)
    assert np.array_equal(a.samples, b.samples)


# The steps replayed from CUDA graphs (utils/graphs.py) against the eager
# loop (SVGDSampler._eager) from the same state: bitwise, with the same
# launch counts, through every entry point (cuda_graph_ranks.compare). The
# kernels are the same and their atomics integer or order-free, so a path
# that is not bitwise names the op that is not.

def _graph_paths(dev):
    """{name: (make_sampler, batch, data)}: every captured single-card
    path at its main path's widths (large-n at n=4096)."""
    from stein_tpu_torch.kernels import InverseMultiquadricKernel

    rng = np.random.default_rng(0)
    f32 = torch.float32

    def t(a):
        return torch.tensor(a, dtype=f32, device=dev)

    X = rng.normal(size=(1000, 128))
    lr = {"X": t(X), "y": t(X @ rng.normal(size=(128, 1)))}
    lin = LinearRegressionModel(128)
    nn = BayesianNNModel(1, 100, 20, 20, prior_beta=10.0)
    Xn = rng.normal(size=(20, 1))
    nn_batch = {"X": t(Xn), "y": t(np.sin(Xn))}
    logm = LogisticRegressionModel(54, 581012, 50)
    Xl = rng.normal(size=(2000, 54))
    log_data = {"X": t(Xl), "y": t((Xl.sum(1, keepdims=True) > 0) * 1.0)}

    def lin_make(n, p, **cfg):
        m = LinearRegressionModel(p)
        theta = rng.normal(size=(n, p)) * 0.1
        return lambda: SVGDSampler(n, m.log_p, m.template(), Adam(1e-1),
                                   theta=theta, device="cuda", **cfg)

    def nn_make(n, **over):
        cfg = dict(throughput_config(n, 303, model=nn), **over)
        theta = rng.normal(size=(n, 303)) * 0.1
        return lambda: SVGDSampler(n, nn.log_p, nn.template(), Adam(1e-1),
                                   theta=theta, device="cuda", **cfg)
    theta_l = rng.normal(size=(1000, 55)) * 0.1
    big = LinearRegressionModel(128)
    return {
        "fused_gram": (lin_make(1000, 128, **throughput_config(1000, 128)),
                       lr, lr),
        "fused_glm": (lin_make(1000, 128, **throughput_config(
            1000, 128, model=lin)), lin.sufficient_batch(lr), None),
        "fused_model": (lambda: SVGDSampler(
            1000, logm.log_p, logm.template(), Adam(1e-1), theta=theta_l,
            device="cuda", **throughput_config(1000, 55, model=logm)),
            {k: v[:50] for k, v in log_data.items()}, log_data),
        "fused": (lin_make(1000, 128, **dict(throughput_config(1000, 128),
                                             step_impl="fused")), lr, lr),
        "epilogue": (lin_make(4096, 128, **dict(throughput_config(4096, 128),
                                                step_impl="epilogue")),
                     lr, lr),
        "large-n": (lin_make(4096, 128, **throughput_config(4096, 128)),
                    lr, lr),
        # The n10240 cell's path, whose tile takes the wgmma route.
        "large-n-wgmma": (lin_make(10240, 128,
                                   **throughput_config(10240, 128)), lr, lr),
        "nn": (nn_make(1000), nn_batch, nn_batch),
        "nn-bf16": (nn_make(1000, pallas_precision="bf16"), nn_batch,
                    nn_batch),
        "nn-large": (nn_make(3000), nn_batch, nn_batch),
        "nn-remat": (nn_make(1000, custom_grads=None, remat=True), nn_batch,
                     nn_batch),
        "xla-exact": (lin_make(1000, 128), lr, lr),
        "xla-warm": (lin_make(1000, 128, median="bisect", warm_median=True),
                     lr, lr),
        "subsample": (lin_make(4096, 64, median="subsample",
                               kernel_impl="pallas", median_max_rows=128),
                      {"X": lr["X"][:, :64], "y": lr["y"]}, None),
        # 4000 = 15 row blocks of 256 and a remainder of 160.
        "binned": (lin_make(4000, 64, median="binned", kernel_impl="pallas"),
                   {"X": lr["X"][:, :64], "y": lr["y"]},
                   {"X": lr["X"][:, :64], "y": lr["y"]}),
        "imq": (lin_make(1000, 128, kernel=InverseMultiquadricKernel()),
                lr, lr),
        "big-glm": (lambda: SVGDSampler(
            50, big.log_p, big.template(), Adagrad(0.1),
            theta=rng.normal(size=(50, 128)), device="cuda",
            **throughput_config(50, 128, model=big)),
            big.sufficient_batch(lr), None),
    }


@pytest.mark.parametrize("path", [
    "fused_gram", "fused_glm", "fused_model", "fused", "epilogue",
    "large-n", "large-n-wgmma", "nn", "nn-bf16", "nn-large", "nn-remat",
    "xla-exact", "xla-warm", "subsample", "binned", "imq", "big-glm"])
def test_graphs_equal_the_eager_loop(dev, path):
    from cuda_graph_ranks import compare

    make, batch, data = _graph_paths(dev)[path]
    compare(path, make(), batch, data,
            expect=("B3-wgmma",) if path == "large-n-wgmma" else ())


@pytest.mark.parametrize("path", ["rounds", "grid", "ring", "glm", "nn",
                                  "2d", "2d-grid", "2d-nn", "binned",
                                  "ring-binned"])
def test_mesh_graphs_equal_the_eager_loop(dev, path):
    """The 1-D and 2-D mesh steps on a one-process NCCL group: the graphs
    capture the collectives (all_reduce, all_gather_into_tensor); the
    binned median's histograms, gathered and around the ring, with the
    bin-count kernel."""
    import torch.distributed as dist

    from stein_tpu_torch.parallel import (
        mesh_2d,
        particle_mesh,
        setup_distributed,
    )
    from stein_tpu_torch.utils import graphs

    setup_distributed("nccl", store=dist.HashStore(), world_size=1, rank=0,
                      device_id=dev)
    try:
        rng = np.random.default_rng(0)
        X = rng.normal(size=(1000, 128))
        batch = {"X": torch.tensor(X, dtype=torch.float32, device=dev),
                 "y": torch.tensor(X @ rng.normal(size=(128, 1)),
                                   dtype=torch.float32, device=dev)}
        model, p = LinearRegressionModel(128), 128
        if path.startswith("2d"):
            mesh = mesh_2d(1, 1)
            kw = dict(model_axis="model")
        else:
            mesh = particle_mesh()
            kw = {}
        if path.endswith("nn"):
            model, p = BayesianNNModel(1, 100, 20, 20, prior_beta=10.0), 303
            Xn = rng.normal(size=(20, 1))
            batch = {"X": torch.tensor(Xn, dtype=torch.float32, device=dev),
                     "y": torch.tensor(np.sin(Xn), dtype=torch.float32,
                                       device=dev)}
        cfg = throughput_config(1000, p, mesh=mesh, model=(
            model if path in ("glm", "nn") else None), **kw)
        if path.endswith("binned"):
            cfg = dict(mesh=mesh, median="binned", kernel_impl="pallas",
                       comm="ring" if path == "ring-binned" else "all_gather")
        if path in ("grid", "2d-grid"):
            cfg["median_collectives"] = "grid"
        if path == "ring":
            cfg.update(comm="ring", median_collectives="grid")
        if path == "glm":
            batch = model.sufficient_batch(batch)
        s = SVGDSampler(1000, model.log_p, model.template(), Adam(1e-1),
                        theta=rng.normal(size=(1000, p)) * 0.1,
                        device="cuda", **cfg)
        from cuda_graph_ranks import compare
        compare(path, s, batch, None if path == "glm" else batch)
    finally:
        graphs.release()
        dist.destroy_process_group()


def _bin_count_case(kind, dtype, n_bins, dev):
    """(G, r, c, two windows) of the bin-count kernel's shapes, D = (r +
    c^T) - 2 G: a [256, 10240] block of the large-n path at the first
    level's interval and at a second level's (one first-level bin about
    the median: nearly every entry in an end bin), the n=10000 path's
    remainder block [16, 10000], and the mesh paths' blocks at n=1000: the
    one-process gathered step's remainder [232, 1000], a gathered rank's
    [250, 1000] on 4 ranks, the ring's rotation [1000, 1000] on one rank
    and [250, 250] on 4 (the second window a second level's); the two
    middle ranks' second levels ("second"); and "edges": G and r zero but
    for entries whose 2 g overflows (and a NaN) in the last row, c a
    lattice on the bin edges, below lo and past the last edge, NaN and
    infinities, over windows (-2, 0.5) and (-1.75, 0.5)."""
    from stein_tpu_torch.ops import median

    rng = np.random.default_rng(n_bins)
    if kind == "edges":
        k = np.arange(-5, n_bins + 6, dtype=np.float64)
        c = np.concatenate([-2.0 + 0.5 * k, -2.0 + 0.5 * k + 0.25,
                            [-1e3, -2.5, 1e6, np.nan, -np.inf, np.inf]])
        c = torch.tensor(c, dtype=dtype, device=dev)
        G = torch.zeros(3, c.numel(), dtype=dtype, device=dev)
        G[2, :8] = 3e38
        G[2, 8] = float("nan")
        r = torch.zeros(3, dtype=dtype, device=dev)
        return G, r, c, [(torch.tensor(lo, dtype=dtype, device=dev),
                          torch.tensor(0.5, dtype=dtype, device=dev))
                         for lo in (-2.0, -1.75)]
    n, rows = {"gather4": (1000, 250), "ring4": (250, 250),
               "mesh_remainder": (1000, 232), "ring1": (1000, 1000),
               "remainder": (10000, 16)}.get(kind, (10240, 256))
    theta = torch.tensor(rng.normal(size=(n, 64)) * 0.01, dtype=dtype,
                         device=dev)
    rsq = torch.sum(theta * theta, dim=1)
    blk, r = theta[-rows:], rsq[-rows:]
    D = median._row_block_sq_dists(blk, theta, r, rsq)
    lo, hi = median._binned_range(torch.max(rsq), dtype)
    width = (hi - lo) / n_bins
    b = torch.floor((median.exact_median(D.double()).to(dtype) - lo)
                    / width)
    second = [(lo + (b + i) * width, width / n_bins) for i in (0, 1)]
    wins = second if kind == "second" else [(lo, width), second[0]]
    return torch.matmul(blk, theta.T), r, rsq, wins


@pytest.mark.parametrize("n_windows", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("n_bins", [4096, 2048, 1])
@pytest.mark.parametrize("kind", ["first", "second", "remainder",
                                  "mesh_remainder", "gather4", "ring1",
                                  "ring4", "edges"])
def test_bin_count_against_plain(dev, kind, n_bins, dtype, n_windows):
    """The bin-count kernel's counts bitwise the plain version's
    (``_gram_bin_counts``, itself ``_bin_counts`` of the plain D a window),
    alone and added to a running histogram; two calls bitwise; one launch
    each."""
    from stein_tpu_torch.ops import median

    G, r, c, wins = _bin_count_case(kind, dtype, n_bins, dev)
    wins = wins[:n_windows]
    want = median._gram_bin_counts(G, r, c, wins, n_bins)
    D = median._sq_dists_from_gram(G, r, c)
    assert torch.equal(want, torch.stack(
        [median._bin_counts(D, lo, w, n_bins) for lo, w in wins]))
    before = median.bin_count.launches
    got = median.bin_count(G, r, c, wins, n_bins)
    again = median.bin_count(G, r, c, wins, n_bins)
    acc = torch.arange(n_windows * n_bins, dtype=torch.float32,
                       device=dev).reshape(n_windows, n_bins) * 2.0 ** 20
    summed = median.bin_count(G, r, c, wins, n_bins, acc.clone())
    torch.cuda.synchronize()
    assert median.bin_count.launches - before == 3
    assert torch.equal(got, want) and torch.equal(again, got)
    assert torch.equal(summed, acc + want)
    assert (got.sum(dim=1) == G.numel()).all()


@pytest.mark.parametrize("n_windows,n_bins", [(1, 60000), (2, 60000),
                                              (2, 30000)])
@pytest.mark.parametrize("kind", ["first", "edges"])
def test_bin_count_past_shared_memory(dev, kind, n_windows, n_bins):
    """Past a block's 227 KB of shared memory (60000 bins a window, or two
    windows of 30000): the kernel counts in the global scratch, bitwise
    the plain version's."""
    from stein_tpu_torch.ops import median

    G, r, c, wins = _bin_count_case(kind, torch.float32, n_bins, dev)
    wins = wins[:n_windows]
    want = median._gram_bin_counts(G, r, c, wins, n_bins)
    got = median.bin_count(G, r, c, wins, n_bins)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and (got.sum(dim=1) == G.numel()).all()


def test_bin_count_guards(dev):
    """The wrapper refuses what the kernel does not take."""
    from stein_tpu_torch.ops import median

    G = torch.ones(4, 4, device=dev)
    r = torch.ones(4, device=dev)
    lo = torch.zeros((), device=dev)
    win = [(lo, lo)]
    with pytest.raises(TypeError):
        median.bin_count(G.half(), r.half(), r.half(),
                         [(lo.half(), lo.half())], 8)
    with pytest.raises(TypeError):
        median.bin_count(G, r, r, [(lo.double(), lo)], 8)
    with pytest.raises(TypeError):
        median.bin_count(G, r.double(), r, win, 8)
    with pytest.raises(ValueError):
        median.bin_count(G, r, r, win, 0)
    with pytest.raises(ValueError):
        median.bin_count(G, r, r, win * 3, 8)
    with pytest.raises(ValueError):
        median.bin_count(G, r[:3], r, win, 8)
    with pytest.raises(ValueError):
        median.bin_count(G, r, r, win, 8, torch.zeros(1, 7, device=dev))


@pytest.mark.parametrize("n_levels", [1, 2, 3])
@pytest.mark.parametrize("n", [10240, 10000])
def test_binned_median_equals_the_per_window_sweep(dev, n, n_levels):
    """large_particle.py's binned median (n=10240, p=64; and n=10000, a
    remainder block) with the kernel's shared sweeps bitwise the per-window
    sweep's with the plain count (binned_sweep.reference_binned_median),
    with one launch a row block and level."""
    from binned_sweep import reference_binned_median
    from stein_tpu_torch.ops import median

    rng = np.random.default_rng(3)
    theta = torch.tensor(rng.normal(size=(n, 64)) * 0.01,
                         dtype=torch.float32, device=dev)
    before = median.bin_count.launches
    got = median.binned_median(theta, n_levels=n_levels)
    launches = median.bin_count.launches - before
    want = reference_binned_median(theta, n_levels=n_levels)
    assert torch.equal(got, want), (got.item(), want.item())
    assert launches == -(-n // 256) * n_levels


def test_mesh_graphs_across_cards(dev):
    """tests/cuda_mesh_cards.py on 2 or 4 cards, one NCCL rank a card: every
    mesh path's graphs, the sampler's own choice, against its eager loop
    (collectives and the ring's P2P sends inside the graphs), the ranks in
    bitwise agreement, the gathered samples against one card, each kernel
    at its rank shapes and the timings; then both teardowns (the graphs
    released and the group destroyed; neither, at the interpreter's exit)
    and the two torchrun CLIs; the crash-and-resume drill on meshL and
    production_run.py stopped and relaunched. Every process must exit 0
    (the drill's crash 17) within its limit, on the normal teardown; one
    past it is killed and the test fails. Each
    process's log is written under build/mesh_cards/ as it runs. One card
    skips."""
    import cuda_mesh_cards

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs 2 or more cards (one NCCL rank a card)")
    world = 4 if cards >= 4 else 2
    assert cuda_mesh_cards.main(["--world", str(world)]) == 0


# ------------------------------------------------------ the data products
# ops/data_product.py (csrc/data_product.cu): the folded products of the
# linear models' log_p at the paths' row counts (n, N, p), chip_smoke.py's
# [kernels] data_product cases: [main] 1000, [large-n] 10240, a 4-card
# shard 250, the mesh's median block 256, meshL's 4-card shard 2048 and
# large_particle's 2560 (p 64), then the transpose's split at its edges (a
# ragged last chunk of 103 and rows of 55, chunks of 512, a single row).
# Each entry point within 1e-5 normalised of its plain version (f32 sums
# of up to 4096 terms in another order, the kernel's in 3xTF32), and
# row-invariant: every block of rows launched alone, at every offset, is
# bitwise the full launch's rows.

DP_BLOCKS = (250, 97, 33, 1)


def _bits(t):
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.contiguous().view(ints[t.element_size()])


def _dp_operands(dev, n, N, p, dtype=torch.float32, seed=17):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=shape), dtype=dtype, device=dev)
            for shape in ((N, p), (n, p), (n, N))]


@pytest.mark.parametrize("n,N,p", [(1000, 1000, 128), (10240, 1000, 128),
                                   (250, 1000, 128), (256, 1000, 128),
                                   (2048, 1000, 64), (2560, 1000, 64),
                                   (1000, 128, 128), (1000, 50, 54),
                                   (97, 999, 55), (256, 4096, 64),
                                   (1, 1000, 128)])
def test_data_product_against_plain_and_row_invariant(dev, n, N, p):
    from stein_tpu_torch.ops import data_product as dp

    M, W, R = _dp_operands(dev, n, N, p)
    for fn, plain, A in ((dp.data_product, dp.data_product_plain, W),
                         (dp.data_product_t, dp.data_product_t_plain, R)):
        before = fn.launches
        got = fn(M, A)
        assert fn.launches == before + 1
        assert _norm_err(got, plain(M, A)) <= 1e-5
        assert torch.equal(_bits(fn(M, A)), _bits(got))
        for b in DP_BLOCKS:
            parts = torch.cat([fn(M, A[a:a + b]) for a in range(0, n, b)])
            assert torch.equal(_bits(parts), _bits(got)), (fn.__name__, b)


@pytest.mark.parametrize("dtype,bound,n", [(torch.float64, 1e-12, 1000),
                                           (torch.bfloat16, 8e-3, 1000),
                                           (torch.bfloat16, 8e-3, 250)])
def test_data_product_other_dtypes(dev, dtype, bound, n):
    """f64 sums in f64; bf16 operands sum in f32 and round once (two bf16
    ulps of the plain version's cuBLAS product); both row-invariant, at
    [main]'s shape and (bf16) at a 4-card shard's."""
    from stein_tpu_torch.ops import data_product as dp

    M, W, R = _dp_operands(dev, n, 1000, 128, dtype)
    for fn, plain, A in ((dp.data_product, dp.data_product_plain, W),
                         (dp.data_product_t, dp.data_product_t_plain, R)):
        got = fn(M, A)
        assert got.dtype == dtype
        assert _norm_err(got, plain(M, A)) <= bound
        assert torch.equal(_bits(fn(M, A)), _bits(got))
        for b in DP_BLOCKS:
            parts = torch.cat([fn(M, A[a:a + b]) for a in range(0, n, b)])
            assert torch.equal(_bits(parts), _bits(got)), (fn.__name__, b)
    with pytest.raises(TypeError, match="float32, float64 or bfloat16"):
        dp.data_product(M.half(), W.half())


@pytest.mark.parametrize("kind", ["lr-X", "lr-A", "logistic"])
def test_model_gradients_through_the_data_products(dev, kind):
    """_make_grad_all of the linear models' log_p on the card: one launch
    of each product a call (remat=True: the forward twice), no bmm left;
    the plain and remat routes bitwise equal; against the CPU run (values
    rtol 1e-5, gradients 1e-5 normalised: f32 sums of up to 1000 terms in
    another order, the data products' [kernels] bound); and C10's
    contract: the gradients of a block of 250 particles are the same bits
    as those rows of the block of 1000 (the logistic model's weight
    columns: its log_alpha column is a torch.sum over the weights)."""
    from stein_tpu_torch.api import _make_grad_all
    from stein_tpu_torch.ops import data_product as dp
    from stein_tpu_torch.utils.ravel import template_unraveler

    rng = np.random.default_rng(3)
    n_obs, d = (50, 54) if kind == "logistic" else (1000, 128)
    X = rng.normal(size=(n_obs, d)) * (0.25 if kind == "logistic" else 0.05)
    if kind == "logistic":
        model = LogisticRegressionModel(d, 2 * n_obs, n_obs)
        y = (X @ rng.normal(size=(d, 1)) > 0) * 1.0
        p = d + 1
    else:
        model = LinearRegressionModel(d)
        y = X @ rng.normal(size=(d, 1)) + rng.normal(size=(n_obs, 1)) * 0.3
        p = d
    cpu = {"X": torch.tensor(X, dtype=torch.float32),
           "y": torch.tensor(y, dtype=torch.float32)}
    if kind == "lr-A":
        cpu = model.sufficient_batch(cpu)
    batch = {k: v.to(dev) for k, v in cpu.items()}
    theta = torch.tensor(rng.normal(size=(1000, p)) * 0.5,
                         dtype=torch.float32)
    unravel = template_unraveler(model.template())[1]
    grad_all = _make_grad_all(model.log_p, unravel)
    remat = _make_grad_all(model.log_p, unravel, remat=True)
    counts = (dp.data_product, dp.data_product_t)
    before = [fn.launches for fn in counts]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        v, g = grad_all(theta.to(dev), batch)
        torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counts, before)] == [1, 1]
    assert "aten::bmm" not in {e.key for e in prof.key_averages()}
    v1, g1 = remat(theta.to(dev), batch)
    assert [fn.launches - b for fn, b in zip(counts, before)] == [3, 2]
    assert torch.equal(v, v1) and torch.equal(g, g1)
    v_cpu, g_cpu = grad_all(theta, cpu)
    np.testing.assert_allclose(v.cpu().numpy(), v_cpu.numpy(), rtol=1e-5)
    assert _norm_err(g, g_cpu) <= 1e-5
    cols = (model._ravel_layout()[1].to(dev) if kind == "logistic"
            else torch.arange(p, device=dev))
    for a in range(0, 1000, 250):
        _, g_blk = grad_all(theta[a:a + 250].to(dev), batch)
        assert torch.equal(_bits(g_blk[:, cols]), _bits(g[a:a + 250, cols]))


def test_sampler_counts_the_data_products(dev):
    """A torch.func LR path (fused_gram) launches each product once a
    step, through the graphs (counts added per replay)."""
    from stein_tpu_torch.ops import data_product as dp

    rng = np.random.default_rng(0)
    X = torch.tensor(rng.normal(size=(200, 16)), dtype=torch.float32,
                     device=dev)
    batch = {"X": X, "y": X @ torch.ones(16, 1, device=dev)}
    lin = LinearRegressionModel(16)
    s = SVGDSampler(600, lin.log_p, lin.template(), Adam(1e-1),
                    theta=rng.normal(size=(600, 16)) * 0.1, device="cuda",
                    **throughput_config(600, 16))
    dp.data_product.launches = dp.data_product_t.launches = 0
    s.run(batch, 37)
    torch.cuda.synchronize()
    assert (dp.data_product.launches, dp.data_product_t.launches) == (37, 37)
