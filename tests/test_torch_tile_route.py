"""The streaming tile's route (ops/svgd_tile.py:tile_route): which kernel
each shape takes, the guards of a forced route, and the wgmma and wide
routes' launch counters in the registry and in profiling.summary()."""

import pytest
import torch

from stein_tpu_torch.ops import svgd_tile
from stein_tpu_torch.utils import graphs, profiling

# The benchmark cells' tile shapes ([m, n], p) and the route PERF.md's route
# table records for each (the H100's timings of both routes).
CELL_ROUTES = {
    "linreg-p128.n10240": ((10240, 10240, 128), svgd_tile.WGMMA),
    "linreg-p128.n1000": ((1000, 1000, 128), svgd_tile.WGMMA),
    "bnn-1x100x1.n1000": ((1000, 1000, 303), svgd_tile.WIDE),
    "linreg-p64-suff.n8192-mesh4": ((2048, 8192, 64), svgd_tile.WGMMA),
    "main-nn-large": ((3000, 3000, 303), svgd_tile.WIDE),
    "bnn-year-90x100x1.n2048": ((2048, 2048, 9203), svgd_tile.WIDE),
}

# PERF.md's route table: every timed shape ([m, n], p) and the route that
# timed fastest there of those the rule may pick.
TIMED_ROUTES = {
    (10240, 10240, 128): svgd_tile.WGMMA, (1000, 1000, 128): svgd_tile.WGMMA,
    (1000, 1000, 303): svgd_tile.WIDE, (2048, 8192, 64): svgd_tile.WGMMA,
    (3000, 3000, 303): svgd_tile.WIDE, (100, 100, 55): svgd_tile.MMA_SYNC,
    (50, 50, 128): svgd_tile.MMA_SYNC, (700, 700, 128): svgd_tile.WGMMA,
    (768, 1024, 128): svgd_tile.WGMMA, (800, 800, 128): svgd_tile.WGMMA,
    (900, 900, 128): svgd_tile.WGMMA, (2048, 2048, 64): svgd_tile.WGMMA,
    (2048, 2048, 9203): svgd_tile.WIDE, (2048, 2048, 256): svgd_tile.WIDE,
    (2048, 2048, 512): svgd_tile.WIDE, (2048, 2048, 1024): svgd_tile.WIDE,
    (2048, 2048, 2048): svgd_tile.WIDE, (2048, 2048, 4096): svgd_tile.WIDE,
    (1000, 1000, 640): svgd_tile.WIDE, (1000, 1000, 1024): svgd_tile.WIDE,
    (1000, 1000, 160): svgd_tile.MMA_SYNC, (2048, 2048, 160): svgd_tile.MMA_SYNC,
    (1000, 1000, 192): svgd_tile.WIDE, (250, 1000, 303): svgd_tile.WIDE,
    (10240, 10240, 192): svgd_tile.WIDE, (10240, 10240, 303): svgd_tile.WIDE,
    (2560, 10240, 303): svgd_tile.WIDE,
}


@pytest.mark.parametrize("cell", sorted(CELL_ROUTES))
def test_tile_route_at_the_cells(cell):
    (m, n, p), route = CELL_ROUTES[cell]
    assert svgd_tile.tile_route(m, n, p) == route
    assert svgd_tile.tile_route(m, n, p, "f32") == route


@pytest.mark.parametrize("shape", sorted(TIMED_ROUTES))
def test_tile_route_at_the_timed_shapes(shape):
    """Every shape of the route table keeps the route timed fastest
    there."""
    assert svgd_tile.tile_route(*shape) == TIMED_ROUTES[shape]


@pytest.mark.parametrize("m,n,p", [(10240, 10240, 128), (1000, 1000, 128),
                                   (1000, 1000, 303), (2048, 8192, 64),
                                   (4096, 4096, 128), (1, 1, 1),
                                   (2048, 2048, 9203)])
def test_bf16_keeps_the_mma_sync_route(m, n, p):
    assert svgd_tile.tile_route(m, n, p, "bf16") == svgd_tile.MMA_SYNC


@pytest.mark.parametrize("p", [129, 140, 144, 150, 159, 160])
def test_wide_p_keeps_the_mma_sync_route(p):
    """Past WGMMA_ROUTE_MAX_P the wgmma route's rows and rings do not fit
    one block's shared memory; mma.sync takes the widths whose output is
    one chunk of at most 160 columns (its dot runs once)."""
    assert svgd_tile.tile_route(10240, 10240, p) == svgd_tile.MMA_SYNC


@pytest.mark.parametrize("p", [161, 303, 320, 321, 640, 1000, 9203])
@pytest.mark.parametrize("m,n", [(10240, 10240), (2048, 2048), (50, 50),
                                 (1, 700)])
def test_wider_p_takes_the_wide_route(m, n, p):
    """From WIDE_ROUTE_MIN_P on, where mma.sync would repeat the dot for
    each output chunk, the wide route, whatever the rows and columns."""
    assert p >= svgd_tile.WIDE_ROUTE_MIN_P
    assert svgd_tile.tile_route(m, n, p) == svgd_tile.WIDE


@pytest.mark.parametrize("p", [1, 32, 55, 64, 100, 128])
def test_narrow_p_takes_the_wgmma_route(p):
    assert svgd_tile.tile_route(4096, 4096, p) == svgd_tile.WGMMA


@pytest.mark.parametrize("m,n,p", [(50, 50, 128), (100, 100, 55),
                                   (512, 512, 64), (1000, 512, 128),
                                   (10240, 699, 64)])
def test_small_blocks_keep_the_mma_sync_route(m, n, p):
    """Below WGMMA_ROUTE_MIN_COLS columns the wgmma route's prep and few
    tiles lose ([50, 50] and [100, 100] timed), whatever the rows."""
    assert n < svgd_tile.WGMMA_ROUTE_MIN_COLS
    assert svgd_tile.tile_route(m, n, p) == svgd_tile.MMA_SYNC


@pytest.mark.parametrize("m,n,p", [(700, 700, 128), (768, 1024, 128),
                                   (800, 800, 128), (900, 900, 128),
                                   (2048, 2048, 64), (512, 1024, 128),
                                   (500, 1000, 128), (250, 1000, 128),
                                   (1, 700, 1)])
def test_blocks_of_many_columns_take_the_wgmma_route(m, n, p):
    """From WGMMA_ROUTE_MIN_COLS columns on, the wgmma route, whatever the
    rows (timed: all but the last; it wins at the first five, meshL's ring
    arm among them, and the mesh's n=1000 blocks take it too, as their
    whole problem does)."""
    assert n >= svgd_tile.WGMMA_ROUTE_MIN_COLS
    assert svgd_tile.tile_route(m, n, p) == svgd_tile.WGMMA


@pytest.mark.parametrize("n,p,ranks", [(1000, 128, 2), (1000, 128, 4),
                                       (8192, 64, 4), (10240, 128, 4),
                                       (1000, 303, 4), (100, 55, 2)])
def test_a_row_block_takes_its_whole_problems_route(n, p, ranks):
    """A mesh rank's [n / ranks, n] block takes the route of the whole [n,
    n] problem on one card, which the mesh's results are held to."""
    assert (svgd_tile.tile_route(n // ranks, n, p)
            == svgd_tile.tile_route(n, n, p))


def test_route_depends_on_the_shape_alone():
    """The same shape gives the same route, whatever else has run."""
    first = [svgd_tile.tile_route(m, n, p) for m, n, p in
             ((10240, 10240, 128), (1000, 1000, 128), (2048, 8192, 64))]
    svgd_tile.svgd_both_ksum.wgmma_launches += 1
    again = [svgd_tile.tile_route(m, n, p) for m, n, p in
             ((10240, 10240, 128), (1000, 1000, 128), (2048, 8192, 64))]
    svgd_tile.svgd_both_ksum.wgmma_launches -= 1
    assert first == again


def _small():
    g = torch.Generator().manual_seed(3)
    cols = torch.randn(40, 9, generator=g)
    grads = torch.randn(40, 9, generator=g)
    return cols[:17], cols, grads, svgd_tile.column_center(cols)


@pytest.mark.parametrize("route,precision,match", [
    (svgd_tile.WGMMA, "bf16", "wgmma route takes f32"),
    (svgd_tile.WIDE, "bf16", "wide route takes f32"),
    (7, "f32", "unknown route"),
])
def test_forced_route_guards(route, precision, match):
    rows, cols, grads, c = _small()
    with pytest.raises(ValueError, match=match):
        svgd_tile._tile(rows, cols, grads, 1.5, c, None, precision,
                        route=route)


def test_forced_route_guards_wide_p():
    _forced_wide_p(400)


@pytest.mark.parametrize("p", [129, 303])
def test_forced_route_guards_the_widths_past_128(p):
    _forced_wide_p(p)


def _forced_wide_p(p):
    """A forced wgmma route past WGMMA_ROUTE_MAX_P raises before any
    launch (the kernel has no instance there), on the CPU as on a card."""
    g = torch.Generator().manual_seed(4)
    cols = torch.randn(8, p, generator=g)
    before = graphs.read_counts()
    with pytest.raises(ValueError, match="p <= 128"):
        svgd_tile._tile(cols, cols, cols, 1.5, svgd_tile.column_center(cols),
                        None, "f32", route=svgd_tile.WGMMA)
    assert graphs.read_counts() == before


@pytest.mark.parametrize("route", [svgd_tile.MMA_SYNC, svgd_tile.WGMMA,
                                   svgd_tile.WIDE])
def test_cpu_runs_the_plain_version_on_either_route(route):
    """On the CPU a forced route still runs the plain version (the wide
    route its two plain stages): the same bits as the default, and no
    launch is counted."""
    rows, cols, grads, c = _small()
    before = graphs.read_counts()
    got = svgd_tile._tile(rows, cols, grads, 1.5, c, None, "f32",
                          route=route)
    want = svgd_tile.svgd_both_ksum(rows, cols, grads, 1.5, c)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert graphs.read_counts() == before


def test_wgmma_counter_in_the_registry_and_summary():
    reg = graphs.launch_counters()
    assert reg["B3-wgmma"] == (svgd_tile.svgd_both_ksum, "wgmma_launches")
    assert isinstance(svgd_tile.svgd_both_ksum.wgmma_launches, int)
    launches = profiling.summary()["counters"]["launches"]
    assert "B3-wgmma" in launches
    assert launches["B3-wgmma"] == svgd_tile.svgd_both_ksum.wgmma_launches


def test_wide_counter_in_the_registry_and_summary():
    reg = graphs.launch_counters()
    assert reg["B3-wide"] == (svgd_tile.svgd_both_ksum, "wide_launches")
    assert isinstance(svgd_tile.svgd_both_ksum.wide_launches, int)
    launches = profiling.summary()["counters"]["launches"]
    assert launches["B3-wide"] == svgd_tile.svgd_both_ksum.wide_launches
