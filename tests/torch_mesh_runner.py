"""Mesh scenarios of the port (stein_tpu_torch), run on a gloo process group.

Imports torch and stein_tpu_torch only. tests/test_torch_mesh.py runs the
scenarios in-process on a one-process group and, through ``launch``, in 2
and 4 processes, each running this file:

    python tests/torch_mesh_runner.py RANK WORLD PORT OUT.npz NAME [NAME ...]

Every rank builds the same sampler from the same numpy data, runs the named
scenarios and checks that the ranks agree bitwise on every aux scalar;
rank 0 writes the all-gathered samples and aux of each scenario, and the
results of the collectives' checks, to OUT.npz.
"""

import contextlib
import os
import socket
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:   # run as a script from tests/
    sys.path.insert(0, ROOT)

import stein_tpu_torch as st  # noqa: E402
from stein_tpu_torch.models import (  # noqa: E402
    BayesianNNModel,
    LinearRegressionModel,
)
from stein_tpu_torch.parallel import collectives as coll  # noqa: E402
from stein_tpu_torch.parallel import particle_mesh  # noqa: E402

_FS = dict(median="bisect", warm_median=True, warm_passes=8,
           step_impl="fused_shard")
_WARM = dict(median="bisect", warm_median=True, warm_passes=8)

# name -> (model, step rule, steps, how, sampler options, gradient hook).
# "run" is run(batch, steps); "train" is steps train_on_batch calls.
SCENARIOS = {
    "fs_rounds": ("lr", "Adam", 5, "run",
                  dict(_FS, median_collectives="rounds"), None),
    "fs_grid": ("lr", "Adam", 5, "run", dict(_FS), None),
    "fs_ring": ("lr", "Adam", 5, "run", dict(_FS, comm="ring"), None),
    "fs_glm": ("glm", "Adam", 5, "run", dict(_FS), "quadratic_form"),
    "fs_glm_ring": ("glm", "Adam", 5, "run", dict(_FS, comm="ring"),
                    "quadratic_form"),
    "fs_adagrad": ("lr", "Adagrad", 3, "run",
                   dict(_FS, median_collectives="rounds"), None),
    "fs_nn": ("nn", "Adam", 3, "run",
              dict(_FS, median_collectives="rounds"), "custom_grads"),
    "warm_xla": ("lr", "Adam", 5, "run", dict(_WARM), None),
    "warm_ring": ("lr", "Adam", 5, "run", dict(_WARM, comm="ring"), None),
    "warm_pallas": ("lr", "Adam", 5, "run",
                    dict(_WARM, kernel_impl="pallas"), None),
    "warm_pallas_ring": ("lr", "Adam", 5, "run",
                         dict(_WARM, kernel_impl="pallas", comm="ring"),
                         None),
    "cold_exact": ("lr", "Adam", 3, "train", dict(median="exact"), None),
    "cold_bisect": ("lr", "Adam", 3, "train", dict(median="bisect"), None),
    "cold_ring": ("lr", "Adam", 3, "train",
                  dict(median="bisect", comm="ring"), None),
    "cold_pallas": ("lr", "Adam", 3, "train",
                    dict(median="bisect", kernel_impl="pallas"), None),
    "cold_pallas_ring": ("lr", "Adam", 3, "train",
                         dict(median="bisect", kernel_impl="pallas",
                              comm="ring"), None),
    "cold_nn": ("nn", "Adam", 3, "train", dict(median="bisect"),
                "custom_grads"),
}
# make_sharded_fused_warm_step with either epilogue, 3 steps (no sampler).
EPILOGUES = ("epilogue_fused", "epilogue_xla")
# save on the mesh, restore into a fresh mesh sampler (port only).
CHECKPOINT = "checkpoint"
LR = {"lr": 1e-1, "glm": 1e-1, "nn": 1e-2}


def linreg_data(seed=0, n_obs=40, n_feats=3, n_particles=16):
    """tests/test_sharded.py's _linreg recipe (f32)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_obs, n_feats))
    y = X @ (rng.normal(size=(n_feats, 1)) * 2.0) + rng.normal(
        size=(n_obs, 1)) * 0.3
    theta0 = rng.normal(size=(n_particles, n_feats)) * 0.01
    return (X.astype(np.float32), y.astype(np.float32),
            theta0.astype(np.float32))


def nn_data(n_particles=16):
    """tests/test_sharded.py's custom_grads recipe: BayesianNNModel(1, 8,
    20, 20), 20 observations from seed 4, p = 27."""
    rng = np.random.default_rng(4)
    X = rng.uniform(size=(20, 1))
    y = np.cos(10 * X) * (5 * X) + rng.normal(size=(20, 1)) * 0.1
    theta0 = rng.normal(size=(n_particles, 27)) * 0.05
    return (X.astype(np.float32), y.astype(np.float32),
            theta0.astype(np.float32))


def _problem(kind, device):
    """(model, batch, theta0) of a scenario's model."""
    if kind == "nn":
        X, y, theta0 = nn_data()
        model = BayesianNNModel(1, 8, 20, 20)
    else:
        X, y, theta0 = linreg_data()
        model = LinearRegressionModel(3)
    batch = {"X": torch.from_numpy(X).to(device),
             "y": torch.from_numpy(y).to(device)}
    if kind == "glm":
        batch = model.sufficient_batch(batch)
    return model, batch, theta0


def _agree(aux, mesh):
    """Whether every rank holds bitwise the same aux values."""
    for v in aux.values():
        g = coll.all_gather(v.reshape(1, -1), mesh)
        if not bool((g == g[0]).all()):
            return False
    return True


def port_scenario(name, mesh, workdir=None):
    """Run one scenario on ``mesh``; returns its all-gathered samples, its
    aux arrays and whether the ranks agreed bitwise on the aux. The
    checkpoint scenario writes its file into ``workdir``."""
    if name in EPILOGUES:
        return _epilogue_scenario(name.split("_")[1], mesh)
    if name == CHECKPOINT:
        return _checkpoint_scenario(mesh, workdir)
    kind, rule, steps, how, cfg, hook = SCENARIOS[name]
    dev = mesh.device
    model, batch, theta0 = _problem(kind, dev)
    kw = dict(cfg)
    if hook == "quadratic_form":
        kw["quadratic_form"] = model.quadratic_form
    elif hook == "custom_grads":
        kw["custom_grads"] = model.pallas_grads()
    s = st.SVGDSampler(theta0.shape[0], model.log_p, model.template(),
                       getattr(st, rule)(learning_rate=LR[kind]),
                       theta=theta0, device=dev, mesh=mesh, **kw)
    if how == "run":
        aux = s.run(batch, steps)
    else:
        auxes = [s.train_on_batch(batch) for _ in range(steps)]
        aux = {k: torch.stack([a[k] for a in auxes]) for k in auxes[0]}
    out = {k: v.cpu().numpy() for k, v in aux.items()}
    out["samples"] = s.samples
    out["agree"] = np.asarray(_agree(aux, mesh))
    return out


def _epilogue_scenario(mode, mesh):
    from stein_tpu_torch.parallel.sharded import shard_state
    from stein_tpu_torch.parallel.sharded_fused import (
        make_sharded_fused_warm_step,
    )

    model, batch, theta0 = _problem("lr", mesh.device)
    gd = st.Adam(learning_rate=1e-1)
    s = st.SVGDSampler(16, model.log_p, model.template(), gd, theta=theta0,
                       device=mesh.device, median="bisect", warm_median=True)
    step_fn, init_med = make_sharded_fused_warm_step(
        model.log_p, s.unravel_fn, gd, 16, s.state, mesh, epilogue=mode)
    state = shard_state(s.state, mesh)
    carry = (state, init_med(state.particles))
    for _ in range(3):
        carry, aux = step_fn(carry, batch)
    return {"samples": coll.all_gather(carry[0].particles, mesh).numpy(),
            "agree": np.asarray(_agree(aux, mesh))}


def _checkpoint_scenario(mesh, workdir):
    """The warm LR mesh sampler (Adam with decay) runs 3 steps, saves to
    workdir/mesh_ckpt.npz (rank 0 writes the gathered state) and runs 3
    more; a fresh mesh sampler restores the file (every rank its block)
    and runs the same 3. Returns both samples, the restored step and
    whether the ranks agreed on the last aux."""
    model, batch, theta0 = _problem("lr", mesh.device)

    def make():
        return st.SVGDSampler(16, model.log_p, model.template(),
                              st.Adam(learning_rate=1e-1, decay=0.99),
                              theta=theta0, device=mesh.device, mesh=mesh,
                              **_WARM)
    path = os.path.join(workdir, "mesh_ckpt.npz")
    a = make()
    a.run(batch, 3)
    a.save(path)
    a.run(batch, 3)
    b = make()
    b.restore(path)
    step = int(b.state.step)
    aux = b.run(batch, 3)
    return {"samples": a.samples, "restored": b.samples,
            "step": np.asarray(step), "agree": np.asarray(_agree(aux, mesh))}


def check_collectives(mesh):
    """The collectives on rank-dependent values, for the test to check."""
    r = mesh.rank
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2) + 10 * r
    i = torch.tensor([r + 1, 2 * r], dtype=torch.int32)
    f = torch.tensor(1.5 * r - 1.0)
    return {
        "gather": coll.all_gather(x, mesh).numpy(),
        "gather_untiled": coll.all_gather(f, mesh, tiled=False).numpy(),
        "ring": coll.ppermute_ring(x, mesh).numpy(),
        "psum_i32": coll.psum(i, mesh).numpy(),
        "psum_f32": coll.psum(f, mesh).numpy(),
        "pmax": coll.pmax(i, mesh).numpy(),
        "pmin": coll.pmin(f, mesh).numpy(),
        "pmean": coll.pmean(f, mesh).numpy(),
        "index_size": np.asarray([coll.axis_index(mesh),
                                  coll.axis_size(mesh)]),
        "input_kept": np.asarray(bool((x == torch.arange(
            6, dtype=torch.float32).reshape(3, 2) + 10 * r).all())),
    }


@contextlib.contextmanager
def one_process_mesh():
    """A one-process gloo group (no environment needed) and its mesh."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield particle_mesh()
    finally:
        dist.destroy_process_group()


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(world, names, out, timeout=240):
    """Run this file in ``world`` processes on a fresh localhost port (one
    retry: the port can be taken between the probe and the bind). Returns
    (ok, outputs)."""
    for _ in range(2):
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank),
             str(world), str(port), out, *names],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=ROOT)
            for rank in range(world)]
        outs, ok = [], True
        for p in procs:
            try:
                outs.append(p.communicate(timeout=timeout)[0].decode())
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                outs.append("<timeout>")
                ok = False
                continue
            ok = ok and p.returncode == 0
        if ok:
            break
    return ok, outs


def main(argv):
    rank, world, port, out = int(argv[0]), int(argv[1]), int(argv[2]), argv[3]
    names = argv[4:]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = particle_mesh()
        results = {f"coll/{k}": v
                   for k, v in check_collectives(mesh).items()}
        workdir = os.path.dirname(os.path.abspath(out))
        for name in names:
            for k, v in port_scenario(name, mesh, workdir).items():
                results[f"{name}/{k}"] = v
        if rank == 0:
            np.savez(out, **results)
    finally:
        dist.destroy_process_group()
    print(f"TORCH-MESH-OK-{rank}")


if __name__ == "__main__":
    main(sys.argv[1:])
