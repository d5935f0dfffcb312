"""Worker of the port's two-process crash drill
(tests/test_torch_multihost.py::test_two_process_crash_resume), the
counterpart of tests/multihost_crash_runner.py on a gloo process group.
Imports torch and stein_tpu_torch only.

    python tests/torch_crash_runner.py PID NPROC PORT CKPT MODE

A worker process dies after the first checkpoint, the job is torn down (a
scheduler kills every process of a job that lost one), and a full relaunch
resumes from the last checkpoint through train_with_recovery, whose
decision to resume process 0 broadcasts (utils/recovery.py).

- crash: ckpt_every=2 for N_ITERS=6; in the hook of the step-2 checkpoint
  process 1 exits hard (os._exit(17)) and process 0 follows a second later
  (it would otherwise wait for ever in the next chunk's first collective);
- resume: the relaunch restores step 2 and runs to step 6 (executed 4);
  the gathered samples must equal the port's uninterrupted single-device
  run at rtol 1e-9 / atol 1e-12 (the JAX runner's bar). Process 0 saves
  them to CKPT + ".samples.npy"; every process prints
  CRASH-RESUME-OK-<pid>;
- replicas: two replicas of one job, each process a one-rank mesh of its
  own with its own checkpoint (CKPT.p<pid>); process 1's holds step 2,
  process 0 has none. Each replica must take its own writer's decision:
  process 1 resumes (executed 4), process 0 starts afresh (executed 6),
  and both end on the uninterrupted run; each prints REPLICAS-OK-<pid>.
"""

import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:   # run as a script from tests/
    sys.path.insert(0, ROOT)

from stein_tpu_torch import Adam, SVGDSampler  # noqa: E402
from stein_tpu_torch.models import LinearRegressionModel  # noqa: E402
from stein_tpu_torch.parallel import (  # noqa: E402
    particle_mesh,
    replicate_batch,
    setup_distributed,
)
from stein_tpu_torch.utils.recovery import train_with_recovery  # noqa: E402

N_ITERS, CKPT_EVERY = 6, 2
F64 = torch.float64


def inputs():
    """The JAX runner's inputs: X [40, 3], y, theta0 [16, 3] from
    default_rng(0)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(40, 3))
    y = X @ rng.normal(size=(3, 1)) + rng.normal(size=(40, 1)) * 0.3
    theta0 = rng.normal(size=(16, 3)) * 0.01
    return X, y, theta0


def batch_arrays(X, y, start, k, m=8):
    """Minibatches of m rows for steps [start, start + k), deterministic in
    start (train_with_recovery's contract for a bit-identical resume)."""
    n_obs = X.shape[0]
    idx = np.stack([(np.arange(m) + s * m) % n_obs
                    for s in range(start, start + k)])
    return {"X": torch.tensor(X[idx], dtype=F64),
            "y": torch.tensor(y[idx], dtype=F64)}


def make_sampler(model, theta0, mesh=None):
    return SVGDSampler(
        n_particles=16, log_p=model.log_p,
        param_template=model.template(F64), gd=Adam(learning_rate=1e-1),
        theta=theta0, dtype=F64, device="cpu", mesh=mesh)


def uninterrupted(X, y, theta0):
    """The port's single-device run over the same batches."""
    ref = make_sampler(LinearRegressionModel(3), theta0)
    ref.train_on_batches(batch_arrays(X, y, 0, N_ITERS))
    return ref.samples


def replicas(pid, nproc, ckpt, X, y, theta0):
    """The replicas mode (module docstring)."""
    groups = [dist.new_group([r]) for r in range(nproc)]
    mesh = particle_mesh(groups[pid])
    path = f"{ckpt}.p{pid}"

    def make_batches(start, k):
        return replicate_batch(batch_arrays(X, y, start, k), mesh)

    if pid == 1:
        first = make_sampler(LinearRegressionModel(3), theta0, mesh)
        first.train_on_batches(make_batches(0, CKPT_EVERY))
        first.save(path)
    sampler = make_sampler(LinearRegressionModel(3), theta0, mesh)
    executed = train_with_recovery(sampler, N_ITERS, make_batches, path,
                                   ckpt_every=CKPT_EVERY)
    want = N_ITERS - CKPT_EVERY if pid == 1 else N_ITERS
    if executed != want or int(sampler.state.step) != N_ITERS:
        raise RuntimeError(f"replica {pid} executed {executed} steps to "
                           f"step {int(sampler.state.step)}, not {want}")
    np.testing.assert_allclose(sampler.samples, uninterrupted(X, y, theta0),
                               rtol=1e-9, atol=1e-12)
    dist.destroy_process_group()
    print(f"REPLICAS-OK-{pid}", flush=True)
    return 0


def main(argv):
    pid, nproc, port, ckpt, mode = (int(argv[0]), int(argv[1]), argv[2],
                                    argv[3], argv[4])
    torch.set_num_threads(1)
    setup_distributed("gloo", init_method=f"tcp://localhost:{port}",
                      world_size=nproc, rank=pid)
    X, y, theta0 = inputs()
    if mode == "replicas":
        return replicas(pid, nproc, ckpt, X, y, theta0)
    mesh = particle_mesh()
    sampler = make_sampler(LinearRegressionModel(3), theta0, mesh)

    def make_batches(start, k):
        return replicate_batch(batch_arrays(X, y, start, k), mesh)

    if mode == "crash":
        def die_after_first_chunk(step, aux):
            if step == CKPT_EVERY:
                if pid == 1:
                    os._exit(17)   # the lost worker: no cleanup at all
                time.sleep(1.0)    # the scheduler's teardown of the job
                os._exit(17)

        train_with_recovery(sampler, N_ITERS, make_batches, ckpt,
                            ckpt_every=CKPT_EVERY,
                            on_checkpoint=die_after_first_chunk)
        print(f"CRASH-MODE-DID-NOT-CRASH-{pid}", flush=True)
        return 1

    executed = train_with_recovery(sampler, N_ITERS, make_batches, ckpt,
                                   ckpt_every=CKPT_EVERY)
    if executed != N_ITERS - CKPT_EVERY or int(sampler.state.step) != N_ITERS:
        raise RuntimeError(f"resumed run executed {executed} steps to step "
                           f"{int(sampler.state.step)}")
    samples = sampler.samples   # a collective: every process reads it
    np.testing.assert_allclose(samples, uninterrupted(X, y, theta0),
                               rtol=1e-9, atol=1e-12)
    if pid == 0:
        np.save(ckpt + ".samples.npy", samples)
    print(f"executed {executed} steps to step {int(sampler.state.step)}",
          flush=True)
    dist.destroy_process_group()
    print(f"CRASH-RESUME-OK-{pid}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
