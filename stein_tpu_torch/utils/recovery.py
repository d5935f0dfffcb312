"""Crash recovery: a periodically checkpointed training loop.

PyTorch counterpart of ``stein_tpu/utils/recovery.py``: the full sampler
state checkpoints atomically every ``ckpt_every`` steps, and the loop
resumes from the last checkpoint on restart. One process writes: rank 0 of
the sampler's mesh, or without one process 0 of an initialised
``torch.distributed`` group. Its decision to resume is sent to every
process that shares the checkpoint (the mesh's, or the group's), so that
they all take the same branch. A mesh over a subgroup (say one replica of
several) decides on its own, as the JAX package's one mesh over every
process never has to."""

import math
import os

import torch
import torch.distributed as dist

from ..parallel import collectives as coll
from .checkpoint import _process_index
from .hostio import host_scalar


def _atomic_save(sampler, path):
    tmp = path + ".tmp"
    sampler.save(tmp)             # lands at exactly tmp (checkpoint.py)
    mesh = getattr(sampler, "mesh", None)
    if (mesh.rank if mesh is not None else _process_index()) == 0:
        os.replace(tmp, path)     # the process that wrote renames


def _broadcast_exists(exists, mesh=None):
    """The writer's answer on every process that shares the checkpoint:
    rank 0's of ``mesh`` on its ranks (a collective over the mesh alone),
    else process 0's on every process of an initialised group."""
    if mesh is not None:
        flag = torch.tensor(int(exists) if mesh.rank == 0 else 0,
                            dtype=torch.int32, device=mesh.device)
        return bool(host_scalar(coll.psum(flag, mesh)))
    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return exists
    flag = [exists]
    dist.broadcast_object_list(flag, src=0)
    return bool(flag[0])


def train_with_recovery(sampler, n_iters, make_batches, ckpt_path,
                        ckpt_every=1000, on_checkpoint=None,
                        check_finite=True):
    """Drive ``sampler`` for ``n_iters`` total steps with periodic atomic
    checkpoints, resuming from ``ckpt_path`` if it exists; counterpart of
    ``stein_tpu/utils/recovery.py:26``.

    Parameters
    ----------
    make_batches : callable (start_step, k) -> batches with a leading [k]
        axis on the sampler's device: the k minibatches for steps
        [start_step, start_step + k). Deterministic in start_step for a
        bit-identical resume.
    on_checkpoint : optional callable (step, aux) invoked after each saved
        chunk (metrics or evaluation hook).
    check_finite : refuse to overwrite the last good checkpoint with a
        non-finite state (FloatingPointError); the probe is the particle
        sum after the chunk and the chunk's last phi norm.

    Returns the number of steps executed in this invocation.
    """
    exists = _broadcast_exists(os.path.exists(ckpt_path),
                               getattr(sampler, "mesh", None))
    if exists:
        sampler.restore(ckpt_path)
    executed = 0
    while (done := int(sampler.state.step)) < n_iters:
        k = min(ckpt_every, n_iters - done)
        aux = sampler.train_on_batches(make_batches(done, k))
        if check_finite:
            total = torch.sum(sampler.state.particles)
            if getattr(sampler, "mesh", None) is not None:
                total = coll.psum(total, sampler.mesh)   # every rank alike
            probe = host_scalar(total)
            if not (math.isfinite(probe)
                    and math.isfinite(host_scalar(aux["phi_norm"][-1]))):
                # Name a checkpoint only where one was written (a resumed
                # run, or a chunk completed before this one).
                ckpt_note = (
                    f"last good checkpoint at {ckpt_path} (step {done})"
                    if exists or executed > 0 else
                    f"no checkpoint was written yet ({ckpt_path} does "
                    "not exist — divergence in the first chunk of a "
                    "fresh run; fix the model/hyperparameters before "
                    "restarting)"
                )
                raise FloatingPointError(
                    f"SVGD diverged (non-finite state) in steps "
                    f"[{done}, {done + k}); {ckpt_note}"
                )
        _atomic_save(sampler, ckpt_path)
        executed += k
        if on_checkpoint is not None:
            on_checkpoint(int(sampler.state.step), aux)
    return executed
