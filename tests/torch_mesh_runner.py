"""Mesh scenarios of the port (stein_tpu_torch), run on a gloo process group.

Imports torch and stein_tpu_torch only. tests/test_torch_mesh.py runs the
scenarios in-process on a one-process group and, through ``launch``, in 2
and 4 processes, each running this file:

    python tests/torch_mesh_runner.py RANK WORLD PORT OUT.npz NAME [NAME ...]

Every rank builds the same sampler from the same numpy data, runs the named
scenarios and checks that the ranks agree bitwise on every aux scalar;
rank 0 writes the all-gathered samples and aux of each scenario, and the
results of the collectives' checks, to OUT.npz. A name "2d:NAME" runs the
2-D mesh scenario NAME (SCENARIOS_2D) on every layout dp x mp of the world
(LAYOUTS_2D), under "2d:NAME@DPxMP" in OUT.npz (tests/test_torch_sharded2d.py).
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
from stein_tpu_torch.kernels import InverseMultiquadricKernel  # noqa: E402
from stein_tpu_torch.models import (  # noqa: E402
    BayesianNNModel,
    LinearRegressionModel,
)
from stein_tpu_torch.parallel import collectives as coll  # noqa: E402
from stein_tpu_torch.parallel import mesh_2d, particle_mesh  # noqa: E402
from binned_sweep import (  # noqa: E402
    reference_binned_median,
    reference_ring_binned_median,
)

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
    # median='binned' (tests/test_sharded.py:64, :140), 10 steps.
    "binned_gather": ("lr", "Adam", 10, "train", dict(median="binned"),
                      None),
    "binned_ring": ("lr", "Adam", 10, "train",
                    dict(median="binned", comm="ring"), None),
    "binned_pallas": ("lr", "Adam", 10, "train",
                      dict(median="binned", kernel_impl="pallas",
                           binned_bins=1024, binned_block_rows=3), None),
}
# make_sharded_fused_warm_step with either epilogue, 3 steps (no sampler).
EPILOGUES = ("epilogue_fused", "epilogue_xla")
# save on the mesh, restore into a fresh mesh sampler (port only).
CHECKPOINT = "checkpoint"
# binned_median and ring_binned_median on the rank's block (no sampler).
MEDIANS = "medians"
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
    """Whether every rank holds bitwise the same aux values (on a Mesh2D,
    every rank of both axes)."""
    for v in aux.values():
        k = max(v.numel(), 1)
        g = coll.all_gather(v.reshape(1, -1), mesh)
        g = g.reshape(g.shape[0], -1, k).reshape(-1, k)
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
    if name == MEDIANS:
        return median_functions(mesh)
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


# 2-D mesh scenarios (tests/test_sharded2d.py's cases, f64): name ->
# (sampler options, "run" or "train", steps, offset added to theta0).
_W2 = dict(median="bisect", warm_median=True, warm_passes=8)
SCENARIOS_2D = {
    "exact": (dict(), "train", 5, 0.0),
    "imq": (dict(kernel="imq"), "train", 5, 0.0),
    "bisect": (dict(median="bisect"), "train", 5, 0.0),
    "pallas": (dict(median="bisect", kernel_impl="pallas"), "train", 3,
               0.0),
    "rounds": (dict(_W2, median_collectives="rounds"), "run", 5, 0.0),
    "grid": (dict(_W2, median_collectives="grid"), "run", 5, 0.0),
    "warm_xla": (dict(_W2), "run", 4, 0.0),
    "warm_pallas": (dict(_W2, kernel_impl="pallas"), "run", 4, 0.0),
    "rounds_off": (dict(_W2, median_collectives="rounds"), "run", 5, 100.0),
    "grid_off": (dict(_W2, median_collectives="grid"), "run", 5, 100.0),
}
# The 2-D checkpoint scenario and the diagnostics scenario.
CHECKPOINT_2D = "ckpt"
DIAGNOSTICS_2D = "diagnostics"
LAYOUTS_2D = {1: ((1, 1),), 2: ((1, 2), (2, 1)), 4: ((2, 2),)}


def linreg2d_data(n_particles=16, n_feats=8, seed=0):
    """tests/test_sharded2d.py's _setup (f64)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(40, n_feats))
    y = X @ rng.normal(size=(n_feats, 1)) + rng.normal(size=(40, 1)) * 0.3
    theta0 = rng.normal(size=(n_particles, n_feats)) * 0.01
    return X, y, theta0


def _sampler_2d(mesh, theta0, cfg, gd=None):
    model = LinearRegressionModel(theta0.shape[1])
    kw = dict(cfg)
    if kw.get("kernel") == "imq":
        kw["kernel"] = InverseMultiquadricKernel(c=1.0, beta=-0.5)
    return st.SVGDSampler(theta0.shape[0], model.log_p, model.template(),
                          gd or st.Adam(learning_rate=1e-1), theta=theta0,
                          dtype=torch.float64, device=mesh.device, mesh=mesh,
                          model_axis="model", **kw)


def scenario_2d(name, mesh, workdir=None):
    """Run one 2-D scenario on the Mesh2D ``mesh``: its all-gathered
    samples, aux arrays and whether every rank agreed bitwise."""
    X, y, theta0 = linreg2d_data()
    batch = {"X": torch.from_numpy(X).to(mesh.device),
             "y": torch.from_numpy(y).to(mesh.device)}
    if name == CHECKPOINT_2D:
        path = os.path.join(workdir, f"ckpt2d_{mesh.particles.size}x"
                                     f"{mesh.model.size}.npz")
        gd = lambda: st.Adam(learning_rate=1e-1, decay=0.99)  # noqa: E731
        a = _sampler_2d(mesh, theta0, _W2, gd())
        a.run(batch, 3)
        a.save(path)
        a.run(batch, 3)
        b = _sampler_2d(mesh, theta0, _W2, gd())
        b.restore(path)
        step = int(b.state.step)
        aux = b.run(batch, 3)
        return {"samples": a.samples, "restored": b.samples,
                "step": np.asarray(step),
                "agree": np.asarray(_agree(aux, mesh))}
    if name == DIAGNOSTICS_2D:
        s = _sampler_2d(mesh, theta0, {})
        aux = s.train_on_batch(batch)
        model = LinearRegressionModel(theta0.shape[1])
        return {"samples": s.samples,
                "posterior": s.function_posterior(model.predict, batch),
                "posterior_mean": s.function_posterior(model.predict, batch,
                                                       axis=0),
                "ksd": np.asarray(s.ksd(batch)),
                "theta_w": s.theta["w"].cpu().numpy(),
                "agree": np.asarray(_agree(aux, mesh))}
    cfg, how, steps, offset = SCENARIOS_2D[name]
    s = _sampler_2d(mesh, theta0 + offset, cfg)
    out = {}
    if how == "run":
        aux = s.run(batch, steps)
    else:
        auxes, path = [], []
        for _ in range(steps):
            auxes.append(s.train_on_batch(batch))
            path.append(s.samples)
        aux = {k: torch.stack([a[k] for a in auxes]) for k in auxes[0]}
        out["path"] = np.stack(path)
    out.update({k: v.cpu().numpy() for k, v in aux.items()})
    out["samples"] = s.samples
    out["agree"] = np.asarray(_agree(aux, mesh))
    return out


def check_layout_2d(mesh):
    """Where this rank sits on the Mesh2D and the 2-D collectives, for the
    test to check: rank 0 receives every rank's (rank, particle index,
    model index), the model-axis gather along dim 1 of a rank-dependent
    block, and the two-axis psum."""
    r = dist.get_rank()
    pos = torch.tensor([[r, mesh.particles.rank, mesh.model.rank]],
                       dtype=torch.int32)
    x = torch.full((2, 1), float(r)) + torch.arange(2.0).reshape(2, 1)
    return {
        "pos": coll.all_gather(coll.all_gather(pos, mesh.model),
                               mesh.particles).numpy(),
        "gather_dim1": coll.all_gather(x, mesh.model, dim=1).numpy(),
        "gather_2d": coll.all_gather(x, mesh).numpy(),
        "psum_2d": coll.psum(torch.tensor(float(r + 1)), mesh).numpy(),
        "rank": np.asarray(mesh.rank),
    }


def medians_theta(dtype):
    """The particles of the mesh median functions' check: 64 x 3, numpy
    seed 9."""
    return np.random.default_rng(9).normal(size=(64, 3)).astype(dtype)


def median_functions(mesh):
    """binned_median (the all-gather step's: local rows against the
    gathered columns) and ring_binned_median on this rank's block, f32 and
    f64, at n_levels 1, 2 and 3; under "ref_" the per-window sweeps'
    (reference_binned_median, reference_ring_binned_median)."""
    from stein_tpu_torch.ops.median import binned_median, ring_binned_median

    out = {}
    for name, dt in (("f32", np.float32), ("f64", np.float64)):
        theta = torch.from_numpy(medians_theta(dt))
        n_loc = theta.shape[0] // mesh.size
        loc = theta[mesh.rank * n_loc:(mesh.rank + 1) * n_loc]
        for levels in (1, 2, 3):
            kw = dict(n_bins=512, n_levels=levels)
            gathered = dict(kw, block_rows=5, mesh=mesh, theta_cols=theta)
            out[f"binned_{name}_{levels}"] = binned_median(
                loc, **gathered).numpy()
            out[f"ref_binned_{name}_{levels}"] = reference_binned_median(
                loc, **gathered).numpy()
            out[f"ring_{name}_{levels}"] = ring_binned_median(
                loc, mesh, **kw).numpy()
            out[f"ref_ring_{name}_{levels}"] = reference_ring_binned_median(
                loc, mesh, **kw).numpy()
    return out


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
        # Every rank makes the same meshes in the same order.
        meshes = ({lay: mesh_2d(*lay) for lay in LAYOUTS_2D[world]}
                  if any(n.startswith("2d:") for n in names) else {})
        for (dp, mp), m2 in meshes.items():
            for k, v in check_layout_2d(m2).items():
                results[f"2d:layout@{dp}x{mp}/{k}"] = v
        for name in names:
            if name.startswith("2d:"):
                for (dp, mp), m2 in meshes.items():
                    for k, v in scenario_2d(name[3:], m2, workdir).items():
                        results[f"{name}@{dp}x{mp}/{k}"] = v
                continue
            for k, v in port_scenario(name, mesh, workdir).items():
                results[f"{name}/{k}"] = v
        if rank == 0:
            np.savez(out, **results)
    finally:
        dist.destroy_process_group()
    print(f"TORCH-MESH-OK-{rank}")


if __name__ == "__main__":
    main(sys.argv[1:])
