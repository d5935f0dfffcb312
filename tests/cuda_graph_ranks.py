"""The mesh steps replayed from CUDA graphs across ranks: one process per
card on an NCCL group (or, with --cpu, per CPU process on gloo with the
graphs' CPU recorder, to rehearse the harness).

    python tests/cuda_graph_ranks.py RANK WORLD PORT [--cpu]

Every rank builds the same samplers (n=1000, p=128 linear regression; the
Bayesian NN, p=303; n=64 with --cpu) on the mesh, drives run,
train_on_batch, train_on_batches and train_minibatched through the graphs
and through the eager loop from the same state, and checks that each
rank's block and aux agree bitwise and that the launch counts are equal.
The paths: fused_shard with median_collectives 'grid' and 'rounds',
comm='ring' (its P2P sends inside the graph), quadratic_form,
custom_grads, the warm xla step on the ring, and the 2-D mesh at every
layout of the world. A mesh of more than one rank is eager by
graphs.eager_reason (the ranks did not exit after their graphs); this
check captures it all the same. Rank 0 prints one line a path; a failed
check prints its traceback, and the process exits non-zero.
"""

import os
import sys
import traceback

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
from stein_tpu_torch.parallel import mesh_2d, particle_mesh  # noqa: E402
from stein_tpu_torch.utils import graphs  # noqa: E402


def recorder(warm, body):
    """The CPU stand-in for ``graphs.cuda_capture``: the
    warm-up, one pass of the body (a capture runs its Python once), and a
    replay that calls the body on the static buffers. A graph's replay runs
    no Python, so the replay leaves the launch counters as it found them."""
    warm()
    body()

    def replay():
        counts = graphs.read_counts()
        body()
        graphs.set_counts(counts)
    return replay


def compare(label, s, batch, data, rank=0):
    """Each entry point through the graphs, then the eager loop, from the
    same state: bitwise, with equal launch counts (train_minibatched when
    ``data`` is given)."""
    if s._graphs is None:
        raise RuntimeError(f"{label}: the sampler runs no graphs")
    k = graphs.CHUNK + 3
    state0 = graphs.tree_map(torch.clone, s.state)
    stacked = graphs.tree_map(
        lambda l: l.unsqueeze(0).expand(k, *l.shape).contiguous(), batch)
    calls = [("run", (batch, k)), ("train_on_batch", (batch,)),
             ("train_on_batches", (stacked,))]
    if data is not None:
        calls.append(("train_minibatched", (data, k, 20, 3)))
    for method, args in calls:
        out = []
        for eager in (False, True):
            s.load_state(graphs.tree_map(torch.clone, state0))
            graphs.set_counts(dict.fromkeys(graphs.read_counts(), 0))
            aux = (s._eager(method, *args) if eager
                   else getattr(s, method)(*args))
            if s.device.type == "cuda":
                torch.cuda.synchronize()
            out.append((graphs.tensor_leaves(s.state), aux,
                        graphs.read_counts()))
        (sg, ag, ng), (se, ae, ne) = out
        if ng != ne:
            raise RuntimeError(f"{label} {method}: launches {ng} vs {ne}")
        if not (all(torch.equal(a, b) for a, b in zip(sg, se))
                and all(torch.equal(ag[key], ae[key]) for key in ae)):
            raise RuntimeError(f"{label} {method}: graphs differ from the "
                               "eager loop")
    if rank == 0:
        print(f"[ranks] {label}: {graphs.CHUNK + 3} steps of run, "
              "train_on_batch, train_on_batches"
              + (", train_minibatched" if data is not None else "")
              + f" bitwise equal to the eager loop on every rank, launches "
              f"equal ({s._graphs.captures} graphs)", flush=True)


def main(argv):
    rank, world, port = int(argv[0]), int(argv[1]), int(argv[2])
    cpu = "--cpu" in argv
    n = 64 if cpu else 1000
    if cpu:
        dev = torch.device("cpu")
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
    else:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world, device_id=dev)
    try:
        rng = np.random.default_rng(0)
        X = rng.normal(size=(n, 128))
        lin_batch = {"X": torch.tensor(X, dtype=torch.float32, device=dev),
                     "y": torch.tensor(X @ rng.normal(size=(128, 1)),
                                       dtype=torch.float32, device=dev)}
        Xn = rng.normal(size=(20, 1))
        nn_batch = {"X": torch.tensor(Xn, dtype=torch.float32, device=dev),
                    "y": torch.tensor(np.sin(Xn), dtype=torch.float32,
                                      device=dev)}
        lin = LinearRegressionModel(128)
        nn = BayesianNNModel(1, 100, 20, 20, prior_beta=10.0)
        mesh = particle_mesh()
        layouts = [(dp, world // dp) for dp in range(1, world + 1)
                   if world % dp == 0]
        paths = {
            "fused_shard grid": (lin, lin_batch, {}),
            "fused_shard rounds": (lin, lin_batch,
                                   {"median_collectives": "rounds"}),
            "fused_shard ring": (lin, lin_batch, {"comm": "ring"}),
            "fused_shard quadratic_form": (lin, lin_batch, {"model": lin}),
            "fused_shard custom_grads": (nn, nn_batch, {"model": nn}),
            "warm xla ring": (lin, lin_batch, {"xla_ring": True}),
        }
        for dp, mp in layouts:
            paths[f"2-D {dp}x{mp}"] = (lin, lin_batch, {"layout": (dp, mp)})
        for label, (model, batch, opt) in paths.items():
            print(f"[ranks] rank {rank}: {label} ...", flush=True)
            p = 303 if model is nn else 128
            if "layout" in opt:
                m = mesh_2d(*opt["layout"])
                cfg = st.throughput_config(n, p, mesh=m, model_axis="model")
            elif opt.get("xla_ring"):
                cfg = dict(mesh=mesh, median="bisect", warm_median=True,
                           comm="ring")
            else:
                cfg = st.throughput_config(n, p, mesh=mesh,
                                           model=opt.get("model"))
                cfg.update({k: v for k, v in opt.items() if k != "model"})
                if cfg.get("comm") == "ring":
                    cfg["median_collectives"] = "grid"
            theta0 = np.random.default_rng(1).normal(size=(n, p)) * 0.1
            s = st.SVGDSampler(n, model.log_p, model.template(),
                               st.Adam(1e-1), theta=theta0, device=dev,
                               **cfg)
            # A mesh of more than one rank is eager by graphs.eager_reason
            # (its teardown, below); the check captures it all the same.
            s._graphs = graphs.StepGraphs(
                capture=recorder if cpu else graphs.cuda_capture)
            b = batch
            if opt.get("model") is lin:
                b = lin.sufficient_batch(batch)
            compare(label, s, b, None if b is not batch else batch, rank)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    if cpu:
        dist.destroy_process_group()
        return
    # With the graphs alive, the NCCL ranks did not exit after their checks
    # on 4 cards (the process group's teardown; ROADMAP S16), so the check
    # ends here.
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    main(sys.argv[1:])
