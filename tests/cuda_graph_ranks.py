"""The particle mesh across cards: one process per card on an NCCL group
(or, with --cpu, one CPU process per rank on gloo, the graphs recorded by
the CPU recorder below, at n=64, to rehearse the harness).

    python tests/cuda_graph_ranks.py RANK WORLD PORT [--cpu] [--timing]
        [--teardown destroy|exit] [--paths LABEL,LABEL...]
    python tests/cuda_graph_ranks.py RANK WORLD PORT --scenario NAME
    python tests/cuda_graph_ranks.py RANK WORLD PORT [--cpu]
        --recovery crash|resume|whole --ckpt PATH

Every rank builds the same samplers through the entry points a user calls
(``particle_mesh`` / ``mesh_2d``, ``SVGDSampler(mesh=,
**throughput_config(...))``) and checks each path (PATHS: fused_shard with
'rounds', 'grid', comm='ring', quadratic_form and the Bayesian NN's
custom_grads; the warm xla step on the ring; median='binned' with the tile,
gathered and around the ring; the 2-D mesh at every layout of the world;
bench_torch's meshL rows at n=8192, p=64):

- (i) run, train_on_batch, train_on_batches and train_minibatched through
  the sampler's own graphs (on a card it must have chosen them) against
  its eager loop from the same state, CHUNK + 3 steps: bitwise, with equal
  launch counts;
- (ii) every rank bitwise equal on median, h2, phi_norm and log_p_mean;
- (iii) the gathered samples after 10 steps (the chaotic 2-D mesh: 5)
  against the same configuration on rank 0's card alone (a
  one-rank group) at the classes of ROADMAP's contracts (SHARD_CLASS and
  the rest below), with 200 median rows for the n=1000 paths: every fifth
  particle on one rank and on 2 or 4, where throughput_config's 256 take
  other particles on each (other D entries, another median); the
  torch.func paths (fused_shard rounds, grid, ring) are also held at
  tests/test_sharded.py:628's class over its own 5 steps, and on the card
  their gradients (like the binned and the warm ring's) must be the same
  bits on a rank's block as in the gathered block (gradient_blocks);
- (iv) each kernel of the path once at this rank's shapes against its
  plain version (chip_smoke.py's [kernels] bounds).

A check that fails on a rank is reported there; the ranks agree at the
end of each path whether one failed.

With --timing, rank 0 also reports run(batch, 4 * CHUNK)'s µs/step by CUDA
events after a barrier, the maximum over the ranks, in turns eager, graph,
graph, eager; under torch.profiler (rank 0) the graph's device µs/step,
busy share, kernels a step and the NCCL kernels' share of the device time;
and for the meshL rows the same configuration on rank 0's card alone, in
turns with the mesh. Rank 0 prints a line per check and per path, then
``[result] ranks {...}`` (JSON). After a failed path the run goes on to
the next; the process exits 1 if any failed.

--teardown destroy (the default) frees the graphs (``graphs.release``) and
destroys the process group; exit leaves both to the interpreter's exit,
where ``graphs.release`` runs from atexit. --scenario runs one of the CPU
tests' scenarios (SCENARIOS; tests/test_torch_graph_ranks.py) on gloo.

--recovery runs one launch of the crash-and-resume drill on meshL rounds
(bench_torch's n=8192, p=64 fused_shard row; 256 particles with --cpu):
``train_with_recovery`` for RECOVERY_STEPS steps, a checkpoint at PATH
every RECOVERY_EVERY (two whole graph chunks), the sufficient batch
stacked k times. tests/cuda_mesh_cards.py runs the three launches in turn,
each on fresh processes and a fresh port:

- crash: in the hook of the first checkpoint rank 1 exits hard
  (os._exit(17)); every other rank sleeps 1 s and exits 17 too, its graphs
  live and its group never destroyed, as a scheduler's teardown leaves it;
- resume: every rank restores its block, must report executed
  RECOVERY_STEPS - RECOVERY_EVERY and the last step, and must have
  replayed graphs; rank 0 writes the gathered state and the chunks' aux
  to PATH.resume.npz and prints the walls of the restore, of the first
  capture after it and of the run;
- whole: the uninterrupted run from a fresh checkpoint path (PATH.whole):
  its gathered particles, Adam moments, step and aux must equal the
  resumed run's bitwise; the 4 ranks restored from the crash's checkpoint
  (PATH.step64, kept by the caller) must agree with rank 0's card alone (a
  one-rank group) restored from it at the meshL rounds path's (iii) class
  over its 10 steps; and, a reading past the class's steps, the whole run
  beside the same run on rank 0's card alone (PATH.one).
"""

import argparse
import atexit
import json
import os
import sys
import time
import traceback
from types import SimpleNamespace

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
from stein_tpu_torch.parallel import mesh_2d, particle_mesh  # noqa: E402
from stein_tpu_torch.parallel.mesh import Mesh2D  # noqa: E402
from stein_tpu_torch.utils import graphs  # noqa: E402


class Recorded:
    """A recorded graph: ``replay`` calls the body on the static buffers
    and leaves the launch counters as it found them (a graph's replay runs
    no Python); ``reset`` drops the body, after which a replay raises."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        counts = graphs.read_counts()
        self.body()
        graphs.set_counts(counts)

    def reset(self):
        self.body = None


def recorder(warm, body):
    """The CPU stand-in for ``graphs.cuda_capture``: the warm-up, one pass
    of the body (a capture runs its Python once), and the recorded graph."""
    warm()
    body()
    return Recorded(body)


def compare(label, s, batch, data, rank=0, expect=()):
    """Each entry point through the graphs, then the eager loop, from the
    same state: bitwise, with equal launch counts (train_minibatched when
    ``data`` is given). ``expect`` names launch counts that must not be 0
    in either (the route a path is there to take, e.g. "B3-wgmma")."""
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
    bad = []
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
            bad.append(f"{method}: launches {ng} vs {ne}")
        bad.extend(f"{method}: no {key} launches" for key in expect
                   if not (ng[key] and ne[key]))
        if not (all(torch.equal(a, b) for a, b in zip(sg, se))
                and all(torch.equal(ag[key], ae[key]) for key in ae)):
            bad.append(f"{method}: graphs differ from the eager loop")
    if bad:   # after every entry point: a mesh's ranks ran the same calls
        raise RuntimeError(f"{label}: " + "; ".join(bad))
    if rank == 0:
        print(f"[ranks] {label}: {graphs.CHUNK + 3} steps of run, "
              "train_on_batch, train_on_batches"
              + (", train_minibatched" if data is not None else "")
              + f" bitwise equal to the eager loop on every rank, launches "
              f"equal ({s._graphs.captures} graphs)", flush=True)


# ROADMAP's contract classes for (iii): (name, medians rtol, phi_norm
# rtol, samples rtol, samples atol, steps).
# - tests/test_sharded.py:628's class of the fused mesh step (samples 5e-5
#   / 1e-7, medians 1e-6), where a particle's gradient is the same bits in
#   a block of 250 and of 1000: quadratic_form's model stage, B7, and the
#   torch.func gradients of the linear model, whose data products
#   (ops/data_product.py) sum every element in one fixed order whatever
#   the block (gradient_blocks checks it on the card). The torch.func
#   paths are also held at :628's own 5 steps, and the fused_gram class's
#   verdict is printed beside them;
# - the warm mesh steps: the warm bisect class;
# - the 2-D mesh, chaotic (its D rows are psum'd partial Grams): the
#   fused_gram class for 5 steps;
# - meshL: the JAX suite's class of fused_shard in another fp order
#   (tests_tpu/test_tpu_fidelity.py:776-777, samples rtol 2e-2 / atol
#   1e-4 after 10 steps; its medians and phi_norm at the same rtol): from
#   step 2 the Adam eps-regime coordinates of step 1 (76 of 524288) spread
#   through the quadratic form's A (entries ~1e3) into every gradient; the
#   fused_gram class's verdict is printed beside it.
SHARD_CLASS = ("tests/test_sharded.py:628's", 1e-6, 1e-4, 5e-5, 1e-7, 10)
GRAM_CLASS = ("the fused_gram", 5e-3, 1e-4, 2e-4, 1e-6, 10)
# The binned paths: the cold step with B3's tile, whose D is formed in the
# kernel (ROADMAP C: the fused_gram class), the cold mesh step's class of
# the xla step (rtol 1e-5 / atol 1e-6) printed beside it.
BINNED_CLASS = ("the fused_gram (B3's tile)", 5e-3, 1e-4, 2e-4, 1e-6, 10)
COLD_CLASS = ("the cold mesh step's", 1e-5, 1e-5, 1e-5, 1e-6, 10)
WARM_CLASS = ("the warm bisect", 5e-3, 1e-4, 2e-4, 1e-6, 10)
CLASS_2D = ("the fused_gram", 5e-3, 1e-4, 2e-4, 1e-6, 5)
MESHL_CLASS = ("tests_tpu/test_tpu_fidelity.py:776's", 2e-2, 2e-2, 2e-2,
               1e-4, 10)
# The stricter class whose verdict (iii) prints beside a path's own.
BESIDE = {MESHL_CLASS: GRAM_CLASS,
          BINNED_CLASS: COLD_CLASS}
# The n=1000 paths' median rows for (iii) (see the module docstring).
SAME_ROWS = 200
# chip_smoke.py's [kernels] bounds: B3 and B8/B9's D normalised, B10
# normalised; B7's logp (rtol, atol) and grads (of max |g|).
B3_BOUND, BRACKET_BOUND, B10_BOUND = 1e-4, 1e-5, 1e-5
B7_LOGP, B7_GRADS = (2e-5, 1e-5), 2e-5
# (iii)'s second gate of the torch.func paths, :628's own step count.
SHARD_CLASS_5 = SHARD_CLASS[:-1] + (5,)
# --timing: steps a reading (whole chunks), and profiled steps.
TIMED_STEPS = 4 * graphs.CHUNK
# --recovery: the drill's steps and its checkpoint interval (whole chunks).
RECOVERY_STEPS, RECOVERY_EVERY = 8 * graphs.CHUNK, 2 * graphs.CHUNK


def log(rank, *parts):
    if rank == 0:
        print(*parts, flush=True)


def norm_err(a, b):
    """max |a - b| / max |b| (0 when both are 0)."""
    a, b = a.double().cpu(), b.double().cpu()
    scale = b.abs().max().item()
    diff = (a - b).abs().max().item()
    return diff / scale if scale else diff


def adam_eps_regime(phi1, lr=0.1, b1=0.9, b2=0.999, eps=1e-8):
    """chip_smoke.adam_eps_regime: the coordinates where Adam's first step
    amplifies phi's roundings past a slope of 10 (|phi| < ~1e-6), where no
    bound on the samples follows from one on phi."""
    slope = lr / (1 - b1) * eps / (eps + np.abs(phi1) / np.sqrt(1 - b2)) ** 2
    return slope > 10


def paths(world, n, dev):
    """{label: (model, batch, options)} of the mesh paths at n particles
    (p=128 linear regression, p=303 Bayesian NN; meshL at n=8192, p=64,
    on the CPU at 256 particles)."""
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
    out = {
        "fused_shard rounds": (lin, lin_batch,
                               {"median_collectives": "rounds"}),
        "fused_shard grid": (lin, lin_batch,
                             {"median_collectives": "grid"}),
        "fused_shard ring": (lin, lin_batch, {"comm": "ring",
                                              "median_collectives": "grid"}),
        "fused_shard quadratic_form": (lin, lin_batch, {"model": lin}),
        "fused_shard custom_grads": (nn, nn_batch, {"model": nn}),
        "warm xla ring": (lin, lin_batch, {"xla_ring": True}),
        "binned gathered": (lin, lin_batch, {"binned": "all_gather"}),
        "binned ring": (lin, lin_batch, {"binned": "ring"}),
    }
    for dp in range(1, world + 1):
        if world % dp == 0:
            out[f"2-D {dp}x{world // dp}"] = (lin, lin_batch,
                                             {"layout": (dp, world // dp)})
    out["meshL rounds"] = (None, None, {"meshL": "rounds"})
    out["meshL grid"] = (None, None, {"meshL": "grid"})
    return out


class Meshes:
    """The world's meshes, made in one order on every rank: the 1-D mesh,
    the 2-D mesh of each layout, and rank 0's one-rank groups (a 1-D mesh
    and a 1 x 1 2-D mesh: the same configuration on one card)."""

    def __init__(self, world, layouts):
        self.world = particle_mesh()
        self.two_d = {lay: mesh_2d(*lay) for lay in layouts}
        solo = [dist.new_group([0]) for _ in range(3)]
        self.solo = self.solo_2d = None
        if self.world.rank == 0:
            self.solo = particle_mesh(solo[0])
            self.solo_2d = Mesh2D(particle_mesh(solo[1], "particles"),
                                  particle_mesh(solo[2], "model"))


def build(model, batch, opt, meshes, n, dev):
    """The path: make(mesh, median rows) -> sampler, its batch, the data of
    train_minibatched (or None), the (iii) class, the mesh, the one-card
    mesh (None on ranks past 0) and the sampler's options."""
    if "meshL" in opt:
        import bench_torch

        if dev.type == "cpu":
            bench_torch.MESHL_N = 256
        arm = bench_torch.MESHL_ARMS[
            "meshL_fused_shard" + ("_grid" if opt["meshL"] == "grid"
                                   else "")]
        cfg = dict(bench_torch.MESHL_KW, **arm)
        _, batch = bench_torch.make_meshL_sampler(meshes.world, device=dev,
                                                  **arm)

        def make(mesh, rows=None):
            return bench_torch.make_meshL_sampler(mesh, device=dev, **arm)[0]
        return SimpleNamespace(make=make, batch=batch, data=None,
                               torch_func=False,
                               klass=MESHL_CLASS, mesh=meshes.world,
                               solo=meshes.solo, cfg=cfg)
    p = 303 if isinstance(model, BayesianNNModel) else 128
    if "layout" in opt:
        mesh, solo = meshes.two_d[opt["layout"]], meshes.solo_2d
        cfg = st.throughput_config(n, p, mesh=mesh, model_axis="model")
        klass = CLASS_2D
    elif opt.get("xla_ring"):
        mesh, solo = meshes.world, meshes.solo
        cfg = dict(median="bisect", warm_median=True, comm="ring")
        klass = WARM_CLASS
    elif "binned" in opt:
        mesh, solo = meshes.world, meshes.solo
        cfg = dict(median="binned", kernel_impl="pallas", comm=opt["binned"])
        klass = BINNED_CLASS
    else:
        mesh, solo = meshes.world, meshes.solo
        cfg = st.throughput_config(n, p, mesh=mesh, model=opt.get("model"))
        cfg.update({k: v for k, v in opt.items() if k != "model"})
        klass = SHARD_CLASS
    theta0 = np.random.default_rng(1).normal(size=(n, p)) * 0.1

    def make(m, rows=None):
        kw = dict(cfg, mesh=m)
        if rows is not None:
            kw["median_max_rows"] = rows
        return st.SVGDSampler(n, model.log_p, model.template(),
                              st.Adam(1e-1), theta=theta0, device=dev, **kw)
    data = batch
    if opt.get("model") is model and hasattr(model, "sufficient_batch"):
        batch, data = model.sufficient_batch(batch), None
    return SimpleNamespace(make=make, batch=batch, data=data, klass=klass,
                           mesh=mesh, solo=solo, cfg=cfg,
                           torch_func=klass is SHARD_CLASS
                           and "model" not in opt)


def ranks_agree(label, aux, world):
    """(ii): every rank's median, h2, phi_norm and log_p_mean bitwise equal
    to rank 0's."""
    keys = ("median", "h2", "phi_norm", "log_p_mean")
    mine = torch.stack([aux[k].float() for k in keys])
    every = coll.all_gather(mine, world, tiled=False)
    same = [bool(torch.equal(every[r], every[0])) for r in range(world.size)]
    log(world.rank, f"[ranks] {label}: median, h2, phi_norm, log_p_mean of "
        f"{aux['median'].shape[0]} steps bitwise equal on every rank: "
        f"{same}")
    if not all(same):
        raise RuntimeError(f"{label}: the ranks disagree on the aux "
                           f"scalars ({same})")


def trial(s, batch, steps):
    """(iii)'s record of a sampler: the first clipped phi (Adam's mu after
    step 1, gathered), and the gathered samples, medians and phi_norm after
    ``steps`` steps (1 + steps - 1: both sides alike)."""
    a1 = s.run(batch, 1)
    phi1 = coll.all_gather(s.state.opt_state.mu, s.mesh).cpu().numpy()
    a2 = s.run(batch, steps - 1)
    return {"phi1": phi1, "samples": s.samples,
            "median": torch.cat([a1["median"], a2["median"]]).cpu().numpy(),
            "phi_norm": torch.cat([a1["phi_norm"],
                                   a2["phi_norm"]]).cpu().numpy()}


def class_excess(klass, got, want, eps_rule=True):
    """(pass, the line's numbers) of got against want at ``klass``; the
    samples in Adam's eps regime (at most 1 coordinate in 1000) held
    through phi at step 1 only. Without ``eps_rule`` (a trial from a
    restored state, whose Adam moments are not zero, so its first step
    amplifies nothing) every coordinate is held."""
    _, med_tol, norm_tol, rtol, atol, _ = klass
    ill = (adam_eps_regime(want["phi1"]) if eps_rule
           else np.zeros(want["phi1"].shape, bool))

    def excess(a, b):
        return float(np.max(np.abs(a - b) - (atol + rtol * np.abs(b))))
    med_rel = float(np.max(np.abs(got["median"] / want["median"] - 1)))
    norm_rel = float(np.max(np.abs(got["phi_norm"] / want["phi_norm"]
                                   - 1)))
    phi_ex = excess(got["phi1"], want["phi1"])
    s_ex = excess(got["samples"][~ill], want["samples"][~ill])
    ok = (med_rel <= med_tol and norm_rel <= norm_tol and phi_ex <= 0
          and s_ex <= 0 and ill.mean() <= 1e-3)
    return ok, (f"median rel {med_rel:.3e} (class {med_tol:g}), phi_norm "
                f"rel {norm_rel:.3e} ({norm_tol:g}), phi at step 1 excess "
                f"{phi_ex:.3e}, samples excess over rtol {rtol:g} / atol "
                f"{atol:g} {s_ex:.3e} ({int(ill.sum())} coordinates in "
                "Adam's eps regime)")


def one_card(label, path, rows):
    """(iii): the mesh's gathered trial against the one-card run of the
    same configuration, on rank 0, at the path's class (and the verdict
    of the class BESIDE it); the torch.func paths are also held at
    SHARD_CLASS_5, :628's own 5 steps, with the fused_gram class's verdict
    printed beside."""
    name, steps = path.klass[0], path.klass[-1]
    torch_func = getattr(path, "torch_func", False)
    got = trial(path.make(path.mesh, rows), path.batch, steps)
    got5 = (trial(path.make(path.mesh, rows), path.batch, SHARD_CLASS_5[-1])
            if torch_func else None)
    if path.solo is None:
        return
    want = trial(path.make(path.solo, rows), path.batch, steps)
    ok, line = class_excess(path.klass, got, want)
    rows_txt = f"{rows} median rows" if rows else "its median rows"
    diff = np.abs(got["samples"] - want["samples"]).max()
    print(f"[ranks] {label}: {steps} steps vs one card ({rows_txt}): "
          f"samples max abs {diff:.3e}; at {name} class: {line}: "
          f"{'within' if ok else 'OUTSIDE'}", flush=True)
    beside = GRAM_CLASS if torch_func else BESIDE.get(path.klass)
    if beside is not None:
        also_ok, also = class_excess(beside, got, want)
        print(f"[ranks] {label}: at {beside[0]} class: {also}: "
              f"{'within' if also_ok else 'outside'}", flush=True)
    if got5 is not None:
        want5 = trial(path.make(path.solo, rows), path.batch,
                      SHARD_CLASS_5[-1])
        ok5, line5 = class_excess(SHARD_CLASS_5, got5, want5)
        print(f"[ranks] {label}: {SHARD_CLASS_5[-1]} steps vs one card at "
              f"{SHARD_CLASS_5[0]} class (its own step count): {line5}: "
              f"{'within' if ok5 else 'OUTSIDE'}", flush=True)
        ok = ok and ok5
    if not ok:
        raise RuntimeError(f"{label}: the mesh left the one-card run's "
                           "class")


def gradient_blocks(label, s, model, batch, world):
    """The torch.func gradients of this rank's particles against the same
    rows of the gathered block's: on the card the same bits on every rank
    (the data products' row invariance), else it raises; rank 0 prints the
    verdict and the largest relative difference. With --cpu the plain
    version's torch.matmul makes no such promise: printed only."""
    from stein_tpu_torch.api import _make_grad_all
    from stein_tpu_torch.utils.ravel import template_unraveler

    grad_all = _make_grad_all(model.log_p,
                              template_unraveler(model.template())[1])
    blk = s.state.particles
    cols = coll.all_gather(blk, s.mesh)
    _, g_blk = grad_all(blk, batch)
    _, g_all = grad_all(cols, batch)
    n_loc = blk.shape[0]
    rows = g_all[s.mesh.rank * n_loc:(s.mesh.rank + 1) * n_loc]
    rel = ((g_blk - rows).abs().max() / rows.abs().max()).reshape(1)
    eq = torch.tensor([int(torch.equal(g_blk, rows))], dtype=torch.int32,
                      device=blk.device)
    eq, rel = coll.all_gather(eq, world), coll.all_gather(rel, world)
    log(world.rank, f"[ranks] {label}: torch.func gradients of each rank's "
        f"{n_loc} particles against the same rows of all {cols.shape[0]}: "
        f"the same bits {eq.tolist()}, max relative difference "
        f"{rel.max().item():.3e}")
    if blk.device.type == "cuda" and not bool(eq.all()):
        raise RuntimeError(f"{label}: a rank's torch.func gradients are not "
                           "the same bits as the gathered block's rows")


def bracket_case(rows, cols):
    """B8 and B9 (g1 8) on one block against their plain versions: D
    normalised error, the counts of the kernel's own D, two calls bitwise.
    Returns (ok, D's normalised error)."""
    from stein_tpu_torch.ops import fused_median as fm
    from stein_tpu_torch.ops import svgd_tile
    from stein_tpu_torch.ops.median import DEFAULT_BRACKETS, count_le

    zero = torch.zeros((), dtype=torch.float32, device=rows.device)
    c = svgd_tile.column_center(cols)
    med = fm.warm_search_on_value(fm.dist_block_plain(rows, cols, c), zero,
                                  30)
    hib = 4.0 * torch.max(torch.sum((cols - c) ** 2, dim=1)) * 1.0001 \
        + 1e-30
    D, mm, cnts = fm.fused_bracket_pass(rows, cols, med, c)
    again = fm.fused_bracket_pass(rows, cols, med, c)
    D9, cnts9 = fm.fused_bracket_grid_pass(rows, cols, med, c, hib, g1=8)
    Dp, _, _ = fm.fused_bracket_pass_plain(rows, cols, med, c)
    own = (torch.equal(cnts, count_le(D, fm._bracket_ends(
               med, DEFAULT_BRACKETS)))
           and torch.equal(cnts9, count_le(D9, fm.grid_edges(
               med, hib, DEFAULT_BRACKETS, 8)))
           and torch.equal(D9, D)
           and all(torch.equal(a, b) for a, b in zip((D, mm, cnts), again)))
    err = norm_err(D, Dp)
    return own and err <= BRACKET_BOUND, err


def b3_case(rows, cols, grads):
    """B3's phi against its plain version: (ok, normalised error)."""
    from stein_tpu_torch.ops import svgd_tile

    h2 = torch.tensor(float(torch.median(
        torch.cdist(rows[:64].double(), cols[:256].double()) ** 2)),
        dtype=torch.float32, device=rows.device)
    got = svgd_tile.svgd_phi_rect(rows, cols, grads, h2)
    again = svgd_tile.svgd_phi_rect(rows, cols, grads, h2)
    c = svgd_tile.column_center(cols)
    ku, ks = svgd_tile.svgd_both_ksum_plain(rows, cols, grads, h2, c)
    want = (ku + ks * (rows - c) / h2) / cols.shape[0]
    err = norm_err(got, want)
    return err <= B3_BOUND and torch.equal(got, again), err


def binned_kernels(blk, mesh, cfg, gen):
    """(iv) of a binned path: B3's tile on this rank's rows against the
    gathered columns (gathered) or against its own block (a ring
    rotation's tile), and the bin count of this rank's Gram block (its
    rows against every column, or against its own block) at the first
    level's interval and at both middle ranks' second levels in one
    launch, bitwise its plain version (itself the plain D's count) and
    repeat bitwise. Returns (ok, the line)."""
    from stein_tpu_torch.ops import median

    ring = cfg.get("comm") == "ring"
    cols = blk if ring else coll.all_gather(blk, mesh)
    grads = torch.randn(cols.shape, generator=gen, device=blk.device)
    ok, err = b3_case(blk, cols, grads)
    rsq, csq = torch.sum(blk * blk, dim=1), torch.sum(cols * cols, dim=1)
    G = torch.matmul(blk, cols.T)
    D = median._row_block_sq_dists(blk, cols, rsq, csq)
    n_bins = 4096   # SVGDSampler's binned_bins, on both paths
    lo, hi = median._binned_range(coll.pmax(torch.max(rsq), mesh), blk.dtype)
    w = (hi - lo) / n_bins
    b = torch.floor((median.exact_median(D) - lo) / w)
    for wins in ([(lo, w)], [(lo + (b + i) * w, w / n_bins)
                             for i in (0, 1)]):
        want = median._gram_bin_counts(G, rsq, csq, wins, n_bins)
        plain_d = torch.stack([median._bin_counts(D, lo_, w_, n_bins)
                               for lo_, w_ in wins])
        got = median.bin_count(G, rsq, csq, wins, n_bins)
        again = median.bin_count(G, rsq, csq, wins, n_bins)
        ok &= (torch.equal(want, plain_d) and torch.equal(got, want)
               and torch.equal(again, got))
    return ok, (f"B3 [{blk.shape[0]}, {cols.shape[0]}] p={blk.shape[1]}: "
                f"normalised error {err:.3e}; bin_count [{G.shape[0]}, "
                f"{G.shape[1]}] at {n_bins} bins, the first level and both "
                f"ranks' second levels, bitwise")


def kernels_at_rank_shapes(label, s, model, batch, cfg, world):
    """(iv): each kernel of the path once at this rank's shapes against its
    plain version; every rank must pass. Prints rank 0's shapes."""
    from stein_tpu_torch.models import bayesian_nn
    from stein_tpu_torch.ops import svgd_tile
    from stein_tpu_torch.ops.median import _local_row_idx
    from stein_tpu_torch.parallel.sharded2d import _d_rows_2d

    mesh = s.mesh
    blk = s.state.particles
    gen = torch.Generator(device=blk.device).manual_seed(world.rank)
    lines, ok = [], True
    if isinstance(mesh, Mesh2D):
        cols = coll.all_gather(blk, mesh.particles)
        D, _ = _d_rows_2d(blk, cols, mesh.model)
        h2 = torch.quantile(D[:, :512].flatten(), 0.5) / np.log(cols.shape[0])
        u = torch.randn(cols.shape, generator=gen, device=blk.device)
        ku, ks = svgd_tile.svgd_both_ksum_on_D(D, u, h2)
        ku2, ks2 = svgd_tile.svgd_both_ksum_on_D(D, u, h2)
        ku0, ks0 = svgd_tile.svgd_both_ksum_on_D_plain(D, u, h2)
        err = max(norm_err(ku, ku0), norm_err(ks, ks0))
        good = (err <= B10_BOUND and torch.equal(ku, ku2)
                and torch.equal(ks, ks2))
        ok &= good
        lines.append(f"B10 D {list(D.shape)} x u {list(u.shape)}: "
                     f"normalised error {err:.3e}")
    elif cfg.get("step_impl") == "fused_shard":
        cols = coll.all_gather(blk, mesh)
        grads = torch.randn(cols.shape, generator=gen, device=blk.device)
        good, err = b3_case(blk, cols, grads)
        ok &= good
        lines.append(f"B3 [{blk.shape[0]}, {cols.shape[0]}] p="
                     f"{blk.shape[1]}: normalised error {err:.3e}")
        idx, _ = _local_row_idx(blk.shape[0], mesh, cfg["median_max_rows"],
                                blk.device)
        ring = cfg.get("comm") == "ring"
        good, err = bracket_case(blk[idx], blk if ring else cols)
        ok &= good
        lines.append(f"B8/B9 [{idx.shape[0]}, "
                     f"{(blk if ring else cols).shape[0]}] p={blk.shape[1]}: "
                     f"D normalised error {err:.3e}")
        if isinstance(model, BayesianNNModel):
            lp, g = model.pallas_grads()(blk, batch)
            lp2, g2 = model.pallas_grads()(blk, batch)
            lp0, g0 = bayesian_nn.nn_grads_plain(
                blk, batch["X"], batch["y"].reshape(-1), model.n_feats,
                model.n_hidden, model._consts())
            lp_ex = ((lp - lp0).abs() - (B7_LOGP[1] + B7_LOGP[0]
                                          * lp0.abs())).max().item()
            g_err = (g - g0).abs().max().item()
            good = (lp_ex <= 0 and g_err <= B7_GRADS * g0.abs().max().item()
                    and torch.equal(lp, lp2) and torch.equal(g, g2))
            ok &= good
            lines.append(f"B7 [{blk.shape[0]}, {blk.shape[1]}]: grads max "
                         f"abs {g_err:.3e}")
    elif cfg.get("median") == "binned":
        good, line = binned_kernels(blk, mesh, cfg, gen)
        ok &= good
        lines.append(line)
    else:
        lines.append("no kernel (the xla step)")
    flags = coll.all_gather(torch.tensor([int(ok)], dtype=torch.int32,
                                         device=blk.device), world)
    log(world.rank, f"[kernels] {label} at rank 0's shapes: "
        + "; ".join(lines) + f"; every rank within the bounds and repeat "
        f"bitwise: {flags.tolist()}")
    if not bool(flags.all()):
        raise RuntimeError(f"{label}: a kernel disagrees with its plain "
                           "version on a rank")


def elapsed_ms(fn, dev):
    """fn()'s time in ms: CUDA events on a card, the host clock on the CPU
    (the rehearsal)."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def timed_ms(fn, world, dev):
    """elapsed_ms after a barrier; the maximum over the ranks."""
    dist.barrier()
    t = torch.tensor([elapsed_ms(fn, dev)], device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.item()


def profiled(fn, steps, rank, dev):
    """torch.profiler over fn() on rank 0 (every rank runs fn): (device
    µs/step, kernels/step, NCCL kernels' µs/step, the eight largest kernels
    and the port's own as [name, µs/step, launches/step]), kernel events
    only (none on the CPU)."""
    if rank != 0:
        elapsed_ms(fn, dev)
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        elapsed_ms(fn, dev)
    rows = []
    for e in prof.key_averages():   # the spans' device ranges left out
        t = (getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0) or 0)
        if getattr(e, "device_type", None) == DeviceType.CUDA and t > 0 \
                and not getattr(e, "is_user_annotation", False):
            rows.append((t / steps, e.key, e.count / steps))
    rows.sort(reverse=True)
    shown = rows[:8] + [r for r in rows[8:] if "stein::" in r[1]]
    return (sum(r[0] for r in rows), sum(r[2] for r in rows),
            sum(r[0] for r in rows if "nccl" in r[1].lower()),
            [[k[:60], round(t, 2), round(c, 2)] for t, k, c in shown])


def timing(label, s, batch, world, make_solo):
    """--timing: the path's µs/step, graph and eager, in turns (the
    maximum over the ranks); the profiler's split on rank 0; with
    make_solo (meshL) the same configuration on rank 0's card alone, in
    turns with the mesh, and the strong-scaling numbers. Returns the
    summary dict."""
    k, dev = TIMED_STEPS, s.device
    graphs.set_counts(dict.fromkeys(graphs.read_counts(), 0))
    s.run(batch, k)
    launches = {key: v for key, v in graphs.read_counts().items() if v}
    s._eager("run", batch, 2)
    wall = {True: [], False: []}
    for eager in (True, False, False, True):
        ms = timed_ms(lambda: s._eager("run", batch, k) if eager
                      else s.run(batch, k), world, dev)
        wall[eager].append(ms * 1e3 / k)
    out = {"graph_us": wall[False], "eager_us": wall[True],
           "captures": s._graphs.captures, "steps": k, "launches": launches}
    prof = profiled(lambda: s.run(batch, k), k, world.rank, dev)
    if prof is not None:
        dev_us, launches, nccl_us, top = prof
        out.update(device_us=dev_us, busy=dev_us / np.mean(wall[False]),
                   kernels=launches, nccl_us=nccl_us,
                   nccl_share=nccl_us / dev_us if dev_us else None, top=top)
    if make_solo is not None:
        one = make_solo()
        if one is not None:
            one.run(batch, k)
        t1, tw = [], []
        for solo in (True, False, False, True):
            if not solo:
                tw.append(timed_ms(lambda: s.run(batch, k), world, dev)
                          * 1e3 / k)
                continue
            dist.barrier()
            if one is not None:
                t1.append(elapsed_ms(lambda: one.run(batch, k), dev)
                          * 1e3 / k)
        if world.rank == 0:   # particle-updates: n a step (bench_torch's)
            n, w = s.n_particles, world.size
            out.update(one_card_us=t1, cards_us=tw,
                       updates_per_s_1=n / (np.mean(t1) * 1e-6),
                       updates_per_s=n / (np.mean(tw) * 1e-6),
                       updates_per_s_per_card=n / (np.mean(tw) * 1e-6) / w,
                       efficiency=np.mean(t1) / (w * np.mean(tw)))
    if world.rank == 0:
        print(f"[timing] {label}: " + json.dumps(out), flush=True)
    return out


def check_path(label, spec, meshes, n, dev, cpu, timing_on):
    """Checks (i)-(iv) of one path, then --timing's. A check that fails on
    a rank is reported there and the rank goes on with the others' calls
    (rank 0's one-card run is its own); the ranks then agree on whether
    any failed, and all raise together."""
    model, batch, opt = spec
    path = build(model, batch, opt, meshes, n, dev)
    s = path.make(path.mesh)
    if cpu:   # gloo is the eager rule's: the recorder stands in
        s._graphs = graphs.StepGraphs(capture=recorder, mesh=path.mesh)
    elif s._graphs is None or s._eager_reason is not None:
        raise RuntimeError(f"{label}: the sampler chose the eager loop "
                           f"({s._eager_reason})")
    solo = None
    if "meshL" in opt:
        solo = lambda: (None if path.solo is None     # noqa: E731
                        else path.make(path.solo))
    rows = None if "meshL" in opt else SAME_ROWS
    checks = [
        lambda: compare(label, s, path.batch, path.data, meshes.world.rank),
        lambda: ranks_agree(label, s.run(path.batch, graphs.CHUNK + 3),
                            meshes.world),
        lambda: one_card(label, path, rows)]
    if path.torch_func or path.klass in (BINNED_CLASS, WARM_CLASS):
        checks.append(lambda: gradient_blocks(label, s, model, path.batch,
                                              meshes.world))
    if not cpu:
        checks.append(lambda: kernels_at_rank_shapes(
            label, s, model, path.batch, path.cfg, meshes.world))
    if timing_on:
        checks.append(lambda: timing(label, s, path.batch, meshes.world,
                                     solo))
    failed, out = False, None
    for check in checks:
        try:
            out = check()
        except Exception:   # reported; this rank goes on with the others
            traceback.print_exc()
            sys.stdout.flush()
            failed = True
    flags = coll.all_gather(torch.tensor([int(failed)], dtype=torch.int32,
                                         device=dev), meshes.world)
    if flags.any():
        raise RuntimeError(f"{label}: a check failed on the ranks "
                           f"{flags.nonzero().flatten().tolist()}")
    return out


# ------------------------------------------- the crash-and-resume drill

def _timed(fn, walls, dev):
    """``fn``, each call's wall seconds (the card synchronised before and
    after) appended to ``walls``."""
    def call(*args, **kw):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return out
    return call


def drill_sampler(mesh, dev, cpu):
    """meshL rounds on ``mesh``, its steps replayed from graphs (recorded
    on the CPU): (sampler, its batch, make_batches: the batch stacked k
    times)."""
    import bench_torch

    if cpu:
        bench_torch.MESHL_N = 256
    s, batch = bench_torch.make_meshL_sampler(
        mesh, device=dev, **bench_torch.MESHL_ARMS["meshL_fused_shard"])
    if cpu:
        s._graphs = graphs.StepGraphs(capture=recorder, mesh=mesh)
    elif s._graphs is None or s._eager_reason is not None:
        raise RuntimeError("meshL rounds chose the eager loop "
                           f"({s._eager_reason})")

    def make_batches(start, k):
        return graphs.tree_map(
            lambda l: l.unsqueeze(0).expand(k, *l.shape), batch)
    return s, batch, make_batches


def drill_run(s, make_batches, path):
    """train_with_recovery over the drill's schedule: (steps executed, the
    aux of this invocation's chunks concatenated as numpy, wall s)."""
    from stein_tpu_torch.utils.recovery import train_with_recovery

    auxes = []
    t0 = time.perf_counter()
    executed = train_with_recovery(
        s, RECOVERY_STEPS, make_batches, path, ckpt_every=RECOVERY_EVERY,
        on_checkpoint=lambda step, aux: auxes.append(aux))
    if s.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    aux = {k: torch.cat([a[k] for a in auxes]).cpu().numpy()
           for k in auxes[0]} if auxes else {}
    return executed, aux, wall


def drill_state(s, aux):
    """The gathered particles and Adam moments, the optimizer's scalars,
    the step and the chunks' aux, as numpy (a collective)."""
    opt = s.state.opt_state
    out = {"particles": s.samples,
           "mu": coll.all_gather(opt.mu, s.mesh).cpu().numpy(),
           "nu": coll.all_gather(opt.nu, s.mesh).cpu().numpy(),
           "count": opt.count.cpu().numpy(),
           "learning_rate": opt.learning_rate.cpu().numpy(),
           "step": s.state.step.cpu().numpy()}
    out.update({f"aux_{k}": v for k, v in aux.items()})
    return out


def every_rank(values, world, dev):
    """[rank][value] of a few integers from every rank."""
    t = torch.tensor(values, dtype=torch.int64, device=dev)
    return coll.all_gather(t, world, tiled=False).cpu().tolist()


def recovery(mode, ckpt, meshes, dev, cpu, t_start):
    """One launch of the drill (module docstring). Returns the exit code;
    in crash mode the process exits 17 from the checkpoint's hook."""
    from stein_tpu_torch.utils.recovery import train_with_recovery

    world = meshes.world
    rank = world.rank
    lib_s = None
    if not cpu:   # the kernels' library, built before the launch: its load
        from stein_tpu_torch import _cuda

        t0 = time.perf_counter()
        _cuda.library()
        lib_s = time.perf_counter() - t0
    s, batch, make_batches = drill_sampler(world, dev, cpu)
    if mode == "crash":
        t0 = time.perf_counter()

        def die(step, aux):
            if step != RECOVERY_EVERY:
                return
            log(rank, f"[recovery] crash: checkpoint of step {step} in "
                f"{time.perf_counter() - t0:.3f} s from train_with_recovery's "
                f"call ({time.perf_counter() - t_start:.3f} s from main's "
                "start); rank 1 exits 17, the others 1 s later")
            sys.stdout.flush()
            if rank == 1:
                os._exit(17)    # the lost worker: no cleanup at all
            time.sleep(1.0)     # the scheduler's teardown of the job
            os._exit(17)

        train_with_recovery(s, RECOVERY_STEPS, make_batches, ckpt,
                            ckpt_every=RECOVERY_EVERY, on_checkpoint=die)
        print(f"CRASH-MODE-DID-NOT-CRASH-{rank}", flush=True)
        return 1

    bad = []
    if mode == "resume":
        restores, captures, warm_ups = [], [], []

        def capture(warm, body, inner=s._graphs.capture):
            return inner(_timed(warm, warm_ups, dev), body)
        s.restore = _timed(s.restore, restores, dev)
        s._graphs.capture = _timed(capture, captures, dev)
        executed, aux, wall = drill_run(s, make_batches, ckpt)
        want = RECOVERY_STEPS - RECOVERY_EVERY
        state = drill_state(s, aux)
        by_rank = every_rank([executed, int(s.state.step),
                              s._graphs.captures, len(restores)], world, dev)
        log(rank, f"[recovery] resume: [executed, step, graph captures, "
            f"restores] by rank {by_rank}; restore {restores[0]:.4f} s, "
            f"first capture after it {captures[0]:.4f} s (of which its "
            f"warm-up step, the process's first, {warm_ups[0]:.4f} s), "
            f"train_with_recovery {wall:.4f} s for {want}"
            f" steps ({time.perf_counter() - t_start:.3f} s from main's "
            f"start; the kernels' library loaded in {lib_s} s before it)")
        if any(r[:2] != [want, RECOVERY_STEPS] or r[2] < 1 or r[3] != 1
               for r in by_rank):
            bad.append(f"resume: a rank did not restore, run {want} steps "
                       "to the end and replay graphs")
        launches = {k: v for k, v in graphs.read_counts().items() if v}
        log(rank, f"[recovery] resume: launches on rank 0 {launches}")
        if rank == 0:
            np.savez(ckpt + ".resume.npz", **state)
    else:
        whole = ckpt + ".whole"
        if rank == 0 and os.path.exists(whole):
            os.remove(whole)
        executed, aux, wall = drill_run(s, make_batches, whole)
        state = drill_state(s, aux)
        log(rank, f"[recovery] whole: executed {executed} steps to step "
            f"{int(s.state.step)} in {wall:.4f} s")
        if executed != RECOVERY_STEPS:
            bad.append(f"whole: executed {executed}")
        # (iii) from the crash's checkpoint: the mesh's restore against one
        # card's, over the class's steps.
        at = f"{ckpt}.step{RECOVERY_EVERY}"
        restored, _, _ = drill_sampler(world, dev, cpu)
        restored.restore(at)
        got = trial(restored, batch, MESHL_CLASS[-1])
        if rank == 0:
            bad += compare_drill(ckpt, at, state, got, meshes.solo, dev, cpu)
    flags = every_rank([int(bool(bad))], world, dev)
    for line in bad:
        print(f"[recovery] rank {rank}: FAILED {line}", flush=True)
    if any(f[0] for f in flags):
        return 1
    log(rank, f"[recovery] {mode}: OK on every rank")
    return 0


def compare_drill(ckpt, at, whole, got, solo, dev, cpu):
    """Rank 0: the resumed state against the whole run's, bitwise (the
    resumed chunks' aux against the same chunks'); the mesh's trial from
    the crash's checkpoint ``at`` against rank 0's card alone from it, at
    the meshL rounds path's (iii) class; and, as a reading, the whole run
    against the same run on one card. Returns the failures."""
    bad = []
    with np.load(ckpt + ".resume.npz") as f:
        resumed = dict(f)
    skip = RECOVERY_EVERY
    same = {k: bool(np.array_equal(
        v, whole[k][skip:] if k.startswith("aux_") else whole[k]))
        for k, v in resumed.items()}
    print(f"[recovery] resumed against whole, bitwise (aux of steps "
          f"{skip}-{RECOVERY_STEPS}): {same}", flush=True)
    if not all(same.values()) or set(same) != set(whole):
        bad.append("the resumed state differs from the uninterrupted run")

    one, batch, make_batches = drill_sampler(solo, dev, cpu)
    one.restore(at)
    want = trial(one, batch, MESHL_CLASS[-1])
    ok, line = class_excess(MESHL_CLASS, got, want, eps_rule=False)
    print(f"[recovery] restored at step {RECOVERY_EVERY} from the crash's "
          f"checkpoint, {MESHL_CLASS[-1]} steps, 4 ranks against rank 0's "
          f"card alone (a one-rank group): at {MESHL_CLASS[0]} class: "
          f"{line}: {'within' if ok else 'OUTSIDE'}", flush=True)
    if not ok:
        bad.append("the restored mesh left the one-card run's class")

    # The reading: RECOVERY_STEPS steps on one card beside the mesh's.
    path = ckpt + ".one"
    if os.path.exists(path):
        os.remove(path)
    one, _, make_batches = drill_sampler(solo, dev, cpu)
    _, aux, _ = drill_run(one, make_batches, path)
    _, med_tol, norm_tol, rtol, atol, _ = MESHL_CLASS
    med = np.abs(whole["aux_median"] / aux["median"] - 1)
    norm = np.abs(whole["aux_phi_norm"] / aux["phi_norm"] - 1)
    left = np.flatnonzero((med > med_tol) | (norm > norm_tol))
    excess = np.max(np.abs(whole["particles"] - one.samples)
                    - (atol + rtol * np.abs(one.samples)))
    print(f"[recovery] reading: the whole run against the same run on one "
          f"card, {RECOVERY_STEPS} steps: median rel max {med.max():.3e}, "
          f"phi_norm rel max {norm.max():.3e}, first step past "
          f"{MESHL_CLASS[0]} class's medians or phi_norm "
          f"{int(left[0]) + 1 if left.size else None}; samples at step "
          f"{RECOVERY_STEPS} excess over rtol {rtol:g} / atol {atol:g} "
          f"{excess:.3e}", flush=True)
    return bad


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--timing", action="store_true")
    ap.add_argument("--teardown", choices=("destroy", "exit"),
                    default="destroy")
    ap.add_argument("--paths", default=None)
    ap.add_argument("--scenario", choices=sorted(SCENARIOS), default=None)
    ap.add_argument("--recovery", choices=("crash", "resume", "whole"),
                    default=None)
    ap.add_argument("--ckpt", default=None)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    rank, world = args.rank, args.world
    cpu = args.cpu or args.scenario is not None
    if cpu:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{args.port}", rank=rank,
            world_size=world)
    else:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group(
            "nccl", init_method=f"tcp://localhost:{args.port}", rank=rank,
            world_size=world, device_id=dev)
    if args.scenario is not None:
        return SCENARIOS[args.scenario](rank, world)
    if args.recovery is not None:
        code = recovery(args.recovery, args.ckpt, Meshes(world, []), dev,
                        cpu, t_start)
        graphs.release()
        dist.destroy_process_group()
        return code
    n = 64 if cpu else 1000
    todo = paths(world, n, dev)
    if args.paths:
        todo = {k: todo[k] for k in args.paths.split(",")}
    meshes = Meshes(world, [v[2]["layout"] for v in todo.values()
                            if "layout" in v[2]])
    failed, summary = [], {}
    for label, spec in todo.items():
        print(f"[ranks] rank {rank}: {label} ...", flush=True)
        t0 = time.perf_counter()
        try:
            summary[label] = check_path(label, spec, meshes, n, dev, cpu,
                                        args.timing)
        except Exception:   # reported; the next path still runs
            traceback.print_exc()
            sys.stdout.flush()
            failed.append(label)
        print(f"[ranks] rank {rank}: {label} done in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    if rank == 0:
        print("[result] ranks " + json.dumps(
            {"world": world, "failed": failed, "paths": summary}),
            flush=True)
    print(f"[ranks] rank {rank}: teardown {args.teardown}", flush=True)
    if args.teardown == "destroy":
        graphs.release()
        dist.destroy_process_group()
    return 1 if failed else 0


# ------------------------------------------------ the CPU tests' scenarios
# tests/test_torch_graph_ranks.py runs each on 2 or 4 gloo processes, the
# graphs recorded (``recorder``); each rank prints SCENARIO-OK-<rank>.

def _small_sampler(mesh, graph=True, capture=recorder):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(40, 4)).astype(np.float32)
    batch = {"X": torch.from_numpy(X),
             "y": torch.from_numpy(X @ rng.normal(size=(4, 1))
                                   .astype(np.float32))}
    model = LinearRegressionModel(4)
    s = st.SVGDSampler(16, model.log_p, model.template(), st.Adam(1e-1),
                       theta=rng.normal(size=(16, 4)) * 0.1, device="cpu",
                       mesh=mesh, median="bisect", warm_median=True)
    if graph:
        s._graphs = graphs.StepGraphs(capture=capture, mesh=mesh)
    return s, batch


def scenario_moved(rank, world):
    """One rank's batch moves to a new address between calls: every rank
    captures again (the same count on every rank), and each call stays
    bitwise the eager loop's; the ranks agree on the aux."""
    mesh = particle_mesh()
    s, batch = _small_sampler(mesh)
    e, _ = _small_sampler(mesh, graph=False)
    k = graphs.CHUNK + 1
    moved = {key: v.clone() for key, v in batch.items()}
    for b, captures in ((batch, 2), (batch, 2),
                        (moved if rank == world - 1 else batch, 4),
                        (moved if rank == world - 1 else batch, 4)):
        ag, ae = s.run(b, k), e.run(b, k)
        for x, y in zip(graphs.tensor_leaves(s.state),
                        graphs.tensor_leaves(e.state)):
            assert torch.equal(x, y)
        assert all(torch.equal(ag[key], ae[key]) for key in ae)
        every = coll.all_gather(torch.tensor([s._graphs.captures]), mesh)
        assert every.tolist() == [captures] * world, every.tolist()
        ranks_agree("moved", ag, mesh)
    dist.destroy_process_group()
    print(f"SCENARIO-OK-{rank}", flush=True)
    return 0


def scenario_fail(rank, world):
    """A capture that fails on the last rank raises on every rank."""
    mesh = particle_mesh()

    def flaky(warm, body):
        graph = recorder(warm, body)
        if rank == world - 1:
            raise RuntimeError("capture refused on this rank")
        return graph
    s, batch = _small_sampler(mesh, capture=flaky)
    try:
        s.run(batch, graphs.CHUNK)
    except RuntimeError as err:
        print(f"RAISED: {err}", flush=True)
    else:
        raise AssertionError("the failed capture did not raise here")
    assert not s._graphs.graphs
    dist.destroy_process_group()
    print(f"SCENARIO-OK-{rank}", flush=True)
    return 0


def _samplers_with_graphs(mesh):
    out = [_small_sampler(mesh) for _ in range(2)]
    for s, batch in out:
        s.run(batch, graphs.CHUNK + 1)
        s.train_on_batch(batch)
    recorded = [g.graph for s, _ in out for g in s._graphs.graphs.values()]
    assert len(recorded) == 6 and all(r.body is not None for r in recorded)
    return out, recorded


def scenario_release(rank, world):
    """graphs.release frees every live sampler's graphs; the group is then
    destroyed and the process exits. A sampler captures again after it."""
    mesh = particle_mesh()
    samplers, recorded = _samplers_with_graphs(mesh)
    graphs.release()
    assert all(r.body is None for r in recorded)
    assert all(not s._graphs.graphs for s, _ in samplers)
    s, batch = samplers[0]
    s.run(batch, 2)
    assert s._graphs.captures == 4
    graphs.release()
    dist.destroy_process_group()
    print(f"SCENARIO-OK-{rank}", flush=True)
    return 0


def scenario_release_at_exit(rank, world):
    """No release and no destroy: the atexit hook registered at the first
    capture on the mesh frees every graph before the interpreter's
    teardown (checked by a hook registered before it, which runs after)."""
    mesh = particle_mesh()
    held = []

    def after():
        assert all(r.body is None for r in held)
        assert all(not s._graphs.graphs for s, _ in samplers)
        print(f"RELEASED-AT-EXIT-{rank}", flush=True)
    atexit.register(after)
    samplers, recorded = _samplers_with_graphs(mesh)
    held.extend(recorded)
    print(f"SCENARIO-OK-{rank}", flush=True)
    return 0


def scenario_profile(rank, world):
    """profiling.trace on every rank into one directory: each rank writes
    its own trace.rank<r>.json, and its summary holds the capture-flag
    psum (svgd.agree) inside each call's prep."""
    import tempfile

    from stein_tpu_torch.utils import profiling

    mesh = particle_mesh()
    s, batch = _small_sampler(mesh)
    box = [tempfile.mkdtemp() if rank == 0 else None]
    dist.broadcast_object_list(box, 0)
    with profiling.trace(box[0]):
        s.run(batch, graphs.CHUNK)
        s.run(batch, graphs.CHUNK)
    spans = profiling.summary()["spans"]
    assert spans["svgd.run"]["count"] == 2, spans
    assert spans["svgd.agree"]["parents"] == {"svgd.prep": 2,
                                              "svgd.capture": 1}, spans
    assert spans["svgd.agree"]["calls"] == 2, spans
    dist.barrier()
    if rank == 0:
        names = sorted(os.listdir(box[0]))
        assert names == [f"trace.rank{r}.json" for r in range(world)], names
        for name in names:
            with open(os.path.join(box[0], name)) as f:
                assert "svgd.agree" in f.read()
            os.remove(os.path.join(box[0], name))
        os.rmdir(box[0])
    dist.destroy_process_group()
    print(f"SCENARIO-OK-{rank}", flush=True)
    return 0


SCENARIOS = {"moved": scenario_moved, "fail": scenario_fail,
             "release": scenario_release,
             "release_at_exit": scenario_release_at_exit,
             "profile": scenario_profile}


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
