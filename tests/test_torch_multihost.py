"""The port's multi-process crash drill, counterpart of
tests/test_multihost.py::test_two_process_crash_resume (:97): two gloo
processes (tests/torch_crash_runner.py), process 1 dies hard after the
first checkpoint and process 0 follows; a full relaunch resumes through
train_with_recovery (the multi-process branch of
stein_tpu_torch/utils/recovery.py: process 0's decision to resume,
broadcast) and ends on the uninterrupted trajectory: the port's own
single-device run (checked in the runner) and the JAX package's. Also two
replicas of one job, each a one-rank mesh with a checkpoint of its own:
each takes its own writer's decision to resume (ROADMAP C8); and
examples_torch/production_run.py --mesh under torchrun on 2 gloo
processes, stopped and relaunched, against its uninterrupted run (C9)."""

import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np

import stein_tpu as sj
from stein_tpu.models import LinearRegressionModel as JLR

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import cuda_mesh_cards as M  # noqa: E402
import torch_crash_runner as R  # noqa: E402

LIMIT_S = 240   # each process, as tests/test_multihost.py


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(port, ckpt, mode):
    """Both processes of one launch; (exit codes, outputs), "<timeout>" for
    a process past LIMIT_S (every process is then killed)."""
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_crash_runner.py"),
             str(pid), "2", str(port), ckpt, mode],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(HERE))
        for pid in range(2)
    ]
    codes, outs = [], []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=LIMIT_S)
            outs.append(out.decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.wait()
            outs.append("<timeout>")
        codes.append(p.returncode)
    return codes, outs


def _launch_once_more(ckpt, mode):
    """A launch, and one retry on a fresh port where a process timed out
    (the port can be taken between the probe and the bind)."""
    for _ in range(2):
        codes, outs = _launch(_free_port(), ckpt, mode)
        if "<timeout>" not in outs:
            break
    return codes, outs


def _jax_uninterrupted():
    """The JAX package's uninterrupted single-device run of the same
    batches, in f64."""
    X, y, theta0 = R.inputs()
    model = JLR(3)
    ref = sj.SVGDSampler(
        n_particles=16, log_p=model.log_p,
        param_template=model.template(jnp.float64),
        gd=sj.Adam(learning_rate=1e-1),
        theta=jnp.asarray(theta0, jnp.float64), dtype=jnp.float64)
    b = R.batch_arrays(X, y, 0, R.N_ITERS)
    ref.train_on_batches({k: jnp.asarray(v.numpy(), jnp.float64)
                          for k, v in b.items()})
    return np.asarray(ref.samples)


def test_two_process_crash_resume(tmp_path):
    ckpt = str(tmp_path / "crash_ck")
    codes, outs = _launch_once_more(ckpt, "crash")
    assert codes == [17, 17], (codes, outs)
    assert all("CRASH-MODE-DID-NOT-CRASH" not in o for o in outs), outs
    # The step-2 checkpoint survived the crash, and nothing else beside it.
    assert os.path.exists(ckpt)
    with np.load(ckpt) as ck:
        paths = str(ck["__meta__"][1]).split("|")
        assert int(ck[f"leaf_{paths.index('.step')}"]) == R.CKPT_EVERY
    assert sorted(os.listdir(tmp_path)) == ["crash_ck"]

    codes, outs = _launch_once_more(ckpt, "resume")
    for pid, (code, out) in enumerate(zip(codes, outs)):
        assert code == 0, f"resume process {pid} failed:\n{out}"
        assert f"CRASH-RESUME-OK-{pid}" in out, out
        assert (f"executed {R.N_ITERS - R.CKPT_EVERY} steps to step "
                f"{R.N_ITERS}") in out, out

    # The resumed trajectory against the JAX package's uninterrupted run, at
    # ROADMAP's f64 class against the reference.
    np.testing.assert_allclose(np.load(ckpt + ".samples.npy"),
                               _jax_uninterrupted(), rtol=1e-8, atol=1e-12)


def test_replicas_resume_on_their_own_meshes(tmp_path):
    """C8: train_with_recovery broadcast process 0's decision over the
    whole group, so a replica on a subgroup mesh took another replica's
    answer (here process 1 restarted from step 0 over its own step-2
    checkpoint). Each mesh's rank 0 now decides for its mesh."""
    ckpt = str(tmp_path / "replica_ck")
    codes, outs = _launch_once_more(ckpt, "replicas")
    for pid, (code, out) in enumerate(zip(codes, outs)):
        assert code == 0, f"replica process {pid} failed:\n{out}"
        assert f"REPLICAS-OK-{pid}" in out, out


def test_production_run_resumes_under_torchrun(tmp_path):
    """C9: under torchrun every rank wrote production_run.py's --csv file
    (rows repeated and overwritten). A job stopped at 20 steps and
    relaunched to 60 on the same --ckpt and --csv prints the uninterrupted
    run's step and final KSD^2 lines and leaves its CSV rows (the wall-time
    columns aside), as tests/cuda_mesh_cards.py checks on 4 cards."""
    ckpt = str(tmp_path / "prod.ckpt")
    csv_a, csv_b = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    args = ["--mesh", "--device", "cpu", "--n-particles", "8", "--n-batch",
            "16", "--ckpt-every", "20", "--ckpt", ckpt]
    outs = {}
    for name, extra in (("whole", ["--n-iters", "60", "--csv", csv_b]),
                        ("stopped", ["--n-iters", "20", "--csv", csv_a]),
                        ("resumed", ["--n-iters", "60", "--csv", csv_a])):
        if name != "resumed" and os.path.exists(ckpt):
            os.unlink(ckpt)
        rcs, logs, _ = M.cli("production_run.py", args + extra, 2,
                             str(tmp_path), name, True)
        assert rcs == [0], logs[0]
        outs[name] = M.unspliced(logs[0])
    assert "executed 40 steps" in outs["resumed"], outs["resumed"]
    assert "total step count 60" in outs["resumed"]
    assert M.step_lines(outs["resumed"]) == M.step_lines(outs["whole"], 20)
    assert len(M.step_lines(outs["resumed"])) == 2
    ksd = [M.lines(o, lambda ln: ln.startswith("final KSD^2:"))
           for o in (outs["resumed"], outs["whole"])]
    assert ksd[0] == ksd[1] != ""
    assert M.csv_rows(csv_a) == M.csv_rows(csv_b)
    assert [row[0] for row in M.csv_rows(csv_b)] == ["20", "40", "60"]
