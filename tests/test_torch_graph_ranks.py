"""The step graphs across ranks (stein_tpu_torch/utils/graphs.py) on gloo
processes of the CPU, the graphs recorded by ``cuda_graph_ranks.recorder``.

A mesh of more than one rank captures collectively: each call sums every
rank's "capture needed" flags, so a batch that moves on one rank makes
every rank capture again (a rank that captured alone would run a warm-up
step's collectives that the others never run), and a capture that fails on
one rank raises on all of them. ``graphs.release`` frees every live
sampler's graphs before the process group goes; it also runs from atexit.
Each case runs tests/cuda_graph_ranks.py --scenario on 2 or 4 processes
under a timeout of its own: a hang fails the test."""

import os
import subprocess
import sys

import pytest

from torch_mesh_runner import _free_port

RUNNER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "cuda_graph_ranks.py")
TIMEOUT_S = 120


def scenario(name, world):
    """Every rank's (return code, output); a rank past TIMEOUT_S is killed
    and reads (None, output so far)."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, RUNNER, str(r), str(world), str(port), "--scenario",
         name], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    out = []
    for p in procs:
        try:
            text = p.communicate(timeout=TIMEOUT_S)[0].decode()
            out.append((p.returncode, text))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out.append((None, p.communicate()[0].decode()))
    return out


def _ok(out):
    for rank, (rc, text) in enumerate(out):
        assert rc == 0 and f"SCENARIO-OK-{rank}" in text, text[-3000:]


@pytest.mark.parametrize("world", [2, 4])
def test_moved_batch_captures_on_every_rank(world):
    """One rank's batch moves to a new address: every rank captures again
    (equal counts), each call bitwise the eager loop's, ranks in
    agreement."""
    _ok(scenario("moved", world))


def test_failed_capture_raises_on_every_rank():
    """A capture refused on one rank raises on every rank, none hangs."""
    out = scenario("fail", 2)
    _ok(out)
    assert "capture refused on this rank" in out[1][1]
    assert "failed on another rank of the mesh" in out[0][1]


def test_release_frees_every_graph():
    """graphs.release frees every live sampler's graphs; the group is then
    destroyed and every rank exits; a released sampler captures again."""
    _ok(scenario("release", 2))


def test_release_runs_at_exit():
    """With no release and no destroy, the atexit hook of the first capture
    on the mesh frees every graph before the interpreter's teardown."""
    out = scenario("release_at_exit", 2)
    _ok(out)
    for rank, (_, text) in enumerate(out):
        assert f"RELEASED-AT-EXIT-{rank}" in text, text[-3000:]


def test_profile_writes_a_trace_per_rank():
    """profiling.trace on 2 ranks: trace.rank0.json and trace.rank1.json in
    one directory, and each rank's summary holds svgd.agree, the
    capture-flag psum, in both calls."""
    _ok(scenario("profile", 2))
