"""Checkpoint / resume of the full sampler state.

PyTorch counterpart of ``stein_tpu/utils/checkpoint.py``, in the same file
format: a flat ``.npz`` with the leaves ``leaf_0..leaf_k`` (the state's
leaves in the JAX package's flattening order: named-tuple fields in order,
dict keys sorted) and a ``__meta__`` record ``[version, signature]``. The
signature is the per-leaf key paths joined by ``|``, spelled as
``jax.tree_util.keystr`` spells them (``.particles|.opt_state.mu|...``):
restore rejects a checkpoint whose signature disagrees with the template,
since same-shaped leaves that swapped places would otherwise restore
silently wrong.

A checkpoint written by either package restores into the port. The JAX
package writes a bfloat16 leaf through ml_dtypes, which npz stores as raw
2-byte records (``|V2``): the port reads those back as bf16 bits. The port
writes bfloat16 as float32 (numpy has no bfloat16), which the JAX package
restores exactly; the JAX package cannot restore its own bf16 file
(``arr.astype(like.dtype)`` at ``stein_tpu/utils/checkpoint.py:110`` finds
no cast from ``|V2``), a fault of the reference left as it is.

On a particle mesh every leaf of one or more dimensions is a block of rows
(the sampler's state); ``save_checkpoint(..., mesh=)`` all-gathers those
and rank 0 writes the full state.
"""

import os

import numpy as np
import torch

from ..parallel import collectives as coll
from .hostio import host_array

CHECKPOINT_FORMAT_VERSION = 2


def _flatten_with_path(tree, prefix=""):
    """[(key path, leaf)] in the JAX package's pytree order."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [item for name, sub in zip(tree._fields, tree)
                for item in _flatten_with_path(sub, f"{prefix}.{name}")]
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten_with_path(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [item for i, sub in enumerate(tree)
                for item in _flatten_with_path(sub, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _unflatten(tree, leaves):
    """``tree`` with its leaves replaced, in _flatten_with_path's order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*[build(s) for s in t])
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(s) for s in t)
        return next(it)
    return build(tree)


def _state_signature(state):
    """Structural signature: the ordered per-leaf key paths (e.g.
    '.opt_state.mu'); a rename or reorder of fields changes it."""
    return "|".join(path for path, _ in _flatten_with_path(state))


def _process_index():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def save_checkpoint(path, state, mesh=None):
    """Serialise a state (named tuples, dicts, lists of tensors) to
    ``path``, npz format version 2 (the file lands at exactly ``path``
    whatever its extension); counterpart of
    ``stein_tpu/utils/checkpoint.py:32``.

    With a ``mesh``, every leaf of one or more dimensions is this rank's
    block of rows (on a ``Mesh2D``, of rows and columns) and is
    all-gathered (a collective: every rank calls this), rank 0 of the mesh
    writes, and no rank returns before the file
    is in place. Without one, process 0 of an initialised
    ``torch.distributed`` group (or the only process) writes. The write
    goes through a side-named temp file (np.savez's implicit '.npz' suffix
    can never clobber an unrelated file) and an atomic rename."""
    leaves = [leaf for _, leaf in _flatten_with_path(state)]
    arrays = {
        f"leaf_{i}": host_array(
            leaf, mesh if mesh is not None and leaf.dim() >= 1 else None)
        for i, leaf in enumerate(leaves)
    }
    arrays["__meta__"] = np.array(
        [str(CHECKPOINT_FORMAT_VERSION), _state_signature(state)]
    )
    if (mesh.rank if mesh is not None else _process_index()) == 0:
        tmp = str(path) + f".saving{os.getpid()}"
        np.savez(tmp, **arrays)             # np.savez writes tmp + '.npz'
        written = tmp if os.path.exists(tmp) else tmp + ".npz"
        os.replace(written, path)
    if mesh is not None:
        # A collective read on the host: no rank passes it before rank 0
        # has renamed the file into place.
        float(coll.psum(torch.zeros((), device=mesh.device), mesh))


def restore_checkpoint(path, like_state):
    """Restore a state saved by save_checkpoint (either package's);
    counterpart of ``stein_tpu/utils/checkpoint.py:61``.

    ``like_state`` supplies the structure, the shapes, the dtypes and the
    devices: each restored leaf is cast to its template leaf's dtype and
    placed on its device. Raises ValueError when the file has no
    ``__meta__`` record, another format version, another structural
    signature, another leaf count or a leaf of another shape."""
    with np.load(path) as data:
        files = data.files
        if "__meta__" not in files:
            raise ValueError(
                f"checkpoint {path} has no __meta__ record — not a "
                f"stein_tpu v{CHECKPOINT_FORMAT_VERSION} checkpoint (or "
                "truncated); positional restore without the structural "
                "signature would be silently wrong"
            )
        version, signature = data["__meta__"]
        if int(version) != CHECKPOINT_FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format version {version} != supported "
                f"{CHECKPOINT_FORMAT_VERSION}"
            )
        want = _state_signature(like_state)
        if signature != want:
            raise ValueError(
                "checkpoint structure does not match the template state:\n"
                f"  checkpoint: {signature}\n"
                f"  template:   {want}\n"
                "(a refactor reordered or renamed state leaves; restoring "
                "by position would be silently wrong)"
            )
        like_leaves = [leaf for _, leaf in _flatten_with_path(like_state)]
        n_leaf = len([f for f in files if f.startswith("leaf_")])
        if n_leaf != len(like_leaves):
            raise ValueError(
                f"checkpoint has {n_leaf} leaves, template has "
                f"{len(like_leaves)}"
            )
        restored = []
        for i, like in enumerate(like_leaves):
            arr = data[f"leaf_{i}"]
            if arr.shape != tuple(like.shape):
                raise ValueError(
                    f"leaf {i}: checkpoint shape {arr.shape} != template "
                    f"shape {tuple(like.shape)}"
                )
            restored.append(_leaf_tensor(i, arr, like).to(
                device=like.device, dtype=like.dtype))
    return _unflatten(like_state, restored)


def _leaf_tensor(i, arr, like):
    """Leaf ``i`` of a checkpoint as a CPU tensor. A raw 2-byte record
    (``|V2``, the JAX package's bfloat16 through ml_dtypes) is read as
    bf16 bits when its template is bfloat16; any other raw record raises."""
    if arr.dtype.kind != "V":
        return torch.from_numpy(np.array(arr))
    if arr.dtype.itemsize != 2 or like.dtype != torch.bfloat16:
        raise ValueError(
            f"leaf {i}: raw {arr.dtype.str} records restore only into a "
            f"bfloat16 template leaf as bf16 bits (template {like.dtype})")
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
        torch.bfloat16)
