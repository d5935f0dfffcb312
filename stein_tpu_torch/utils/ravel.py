"""Pytree <-> flat particle-matrix conversion.

PyTorch counterpart of ``stein_tpu/utils/ravel.py``: particles live as one
[n, p] tensor; each row unravels into the model's parameter structure (nested
dicts, lists and tuples of tensors) for the log-posterior. Dict keys flatten
in sorted order at every level, the layout of ``jax.flatten_util.ravel_pytree``
(and of the reference's converters.py:40), so a [n, p] matrix means the same
columns in both packages.
"""

import math

import torch

from .. import _device


def _flatten(tree):
    """Leaves in ravel_pytree order, and a function rebuilding the tree
    from a list of leaves in that order."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]

        def build(leaves):
            out, i = {}, 0
            for k, (ls, b) in zip(keys, parts):
                out[k] = b(leaves[i:i + len(ls)])
                i += len(ls)
            return out
        return [l for ls, _ in parts for l in ls], build
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(t) for t in tree]

        def build(leaves):
            out, i = [], 0
            for ls, b in parts:
                out.append(b(leaves[i:i + len(ls)]))
                i += len(ls)
            return type(tree)(out)
        return [l for ls, _ in parts for l in ls], build
    return [torch.as_tensor(tree)], lambda leaves: leaves[0]


def template_unraveler(template, dtype=None):
    """Given a parameter-structure template, return (n_params, unravel_fn).

    ``unravel_fn`` maps a flat [p] vector back to the template's structure
    as views into the vector, in the vector's dtype (so it composes with
    ``torch.func.vmap``). ``dtype`` is accepted for parity with the JAX
    function, whose cast of the template's leaves makes the flat vector's
    dtype uniform; here the leaves always take the vector's dtype, so it
    changes nothing."""
    del dtype
    leaves, build = _flatten(template)
    shapes = [tuple(l.shape) for l in leaves]
    sizes = [int(l.numel()) for l in leaves]

    def unravel_fn(flat):
        out, i = [], 0
        for shape, size in zip(shapes, sizes):
            out.append(flat[..., i:i + size].reshape(flat.shape[:-1] + shape))
            i += size
        return build(out)

    return sum(sizes), unravel_fn


def ravel_particles(theta_tree):
    """Structure of [n, *shape] leaves -> [n, p] matrix (rows = particles)."""
    leaves, _ = _flatten(theta_tree)
    n = leaves[0].shape[0]
    return torch.cat([l.reshape(n, -1) for l in leaves], dim=1)


def unravel_particles(theta_array, unravel_fn):
    """[n, p] matrix -> structure of [n, *shape] leaves."""
    return unravel_fn(theta_array)


def init_particles(generator, n_particles, n_params, dtype=torch.float32,
                   scale=0.01, device=None):
    """0.01 * N(0, I) init (reference: abstract_stein_sampler.py:66-74).
    ``generator`` is a ``torch.Generator`` on ``device`` (or None for the
    global one); it draws other numbers than ``jax.random`` from the same
    seed, so parity tests pass ``theta=`` explicitly. ``device`` defaults to
    the generator's, else to the current card (raising without one)."""
    if device is None and generator is not None:
        device = generator.device
    device = _device.resolve_device(device, "init_particles")
    return scale * torch.randn(n_particles, n_params, generator=generator,
                               dtype=dtype, device=device)


def convert_dictionary_to_array(dictionary):
    """Reference-compatible converter (converters.py:4-55;
    ``stein_tpu/utils/ravel.py:48``): a dict of {name: [n_particles,
    *shape]} arrays -> ([n_particles, n_params] tensor, access_indices
    {name: (start, end)}), keys in sorted order (converters.py:40)."""
    keys = sorted(dictionary.keys())
    n_particles = next(iter(dictionary.values())).shape[0]
    parts, access_indices, index = [], {}, 0
    for k in keys:
        v = torch.as_tensor(dictionary[k])
        dim = math.prod(v.shape[1:]) if v.dim() > 1 else 1
        parts.append(v.reshape(n_particles, dim))
        access_indices[k] = (index, index + dim)
        index += dim
    return torch.cat(parts, dim=1), access_indices


def convert_array_to_dictionary(array, access_indices, shapes):
    """Inverse of convert_dictionary_to_array (converters.py:58-89;
    ``stein_tpu/utils/ravel.py:65``). ``shapes`` maps each name to its
    per-particle shape."""
    n_particles = array.shape[0]
    return {
        k: array[:, s:e].reshape((n_particles,) + tuple(shapes[k]))
        for k, (s, e) in access_indices.items()
    }
