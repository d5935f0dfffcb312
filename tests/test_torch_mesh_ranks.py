"""The port's 1-D particle mesh in 4 gloo processes (subprocesses running
tests/torch_mesh_runner.py) against the JAX package's mesh sampler on 4 of
the 8 fake CPU devices, every scenario; tests/test_torch_mesh.py has the
scenarios, the one- and two-process runs. Every scenario also checks that
the ranks agree bitwise on median, h2, phi_norm and log_p_mean."""

import numpy as np
import pytest

from test_torch_mesh import (
    ALL,
    check_collectives,
    check_multi_process,
    port_runs,
)


@pytest.mark.parametrize("name", ALL)
def test_four_process_mesh_matches_jax(name):
    check_multi_process(4, name)


def test_collectives_four_processes():
    check_collectives(4)


def test_fused_epilogue_matches_xla_epilogue():
    """make_sharded_fused_warm_step with epilogue='fused' (kernel B6's
    plain version here) against 'xla', 3 steps on 4 processes, at
    tests/test_sharded.py:682's tolerance."""
    res = port_runs(4)
    np.testing.assert_allclose(res["epilogue_fused"]["samples"],
                               res["epilogue_xla"]["samples"], rtol=1e-5,
                               atol=1e-9)
    assert bool(res["epilogue_fused"]["agree"])


def test_glm_ring_matches_autodiff_ring():
    """The ring fused_shard with quadratic_form (theta circulates, the
    visiting block's gradients recomputed) against the autodiff ring
    (tests/test_sharded.py:919's tolerance), 4 processes."""
    res = port_runs(4)
    np.testing.assert_allclose(res["fs_glm_ring"]["samples"],
                               res["fs_ring"]["samples"], rtol=1e-4,
                               atol=1e-7)


def test_grid_and_ring_match_rounds_at_step_one():
    """tests/test_sharded.py:807 and :884 on the port, 4 processes: the
    grid and the ring searches subdivide the rounds search's verified
    bracket, so the first medians agree to width/256 and the samples to
    the bandwidth-perturbation class."""
    res = port_runs(4)
    for name in ("fs_grid", "fs_ring"):
        np.testing.assert_allclose(res[name]["median"][0],
                                   res["fs_rounds"]["median"][0], rtol=3e-3)
        np.testing.assert_allclose(res[name]["samples"],
                                   res["fs_rounds"]["samples"], rtol=2e-2,
                                   atol=2e-4)
