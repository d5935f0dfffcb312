"""Sampler state carried across from the JAX package.

SVGD has no weights besides its particles; this is the port's counterpart of
a weight loader. ``state_from_numpy`` takes the JAX package's ``SVGDState``
as numpy arrays (particles, the optimizer's state, the step count) and
builds the port's ``SVGDState`` on a device, for
``SVGDSampler.load_state``.
"""

import numpy as np
import torch

from .. import _device
from ..ops.optimizers import AdagradState, AdamState


def _fields(opt_state):
    if hasattr(opt_state, "_asdict"):
        return dict(opt_state._asdict())
    return dict(opt_state)


def state_from_numpy(particles, opt_state, step, device=None, mesh=None):
    """The port's SVGDState from numpy arrays.

    ``particles`` is [n, p]; ``opt_state`` a mapping (or named tuple) with
    Adam's ``mu``, ``nu``, ``count``, ``learning_rate`` or Adagrad's
    ``hist``, ``count``, ``learning_rate``; ``step`` the completed steps.
    Floating arrays keep their dtype (f32 for the JAX package's f32
    sampler); counts become int32. ``device`` defaults to the current card
    (raising without one). With a ``mesh`` the state is this rank's block
    (parallel.sharded.shard_state): the rows of every [n, ...] leaf that
    the rank holds, the scalars whole; on a ``Mesh2D`` its [n/dp, p/mp]
    block of every [n, p] leaf (shard_state_2d); a JAX mesh sampler's full
    state carries across so."""
    from ..api import SVGDState

    device = _device.resolve_device(device, "state_from_numpy")

    def tensor(x, dtype=None):
        arr = np.asarray(x)
        t = torch.from_numpy(arr.copy())
        return t.to(device=device, dtype=dtype or t.dtype)

    fields = _fields(opt_state)
    if set(fields) == {"mu", "nu", "count", "learning_rate"}:
        opt = AdamState(tensor(fields["mu"]), tensor(fields["nu"]),
                        tensor(fields["count"], torch.int32),
                        tensor(fields["learning_rate"]))
    elif set(fields) == {"hist", "count", "learning_rate"}:
        opt = AdagradState(tensor(fields["hist"]),
                           tensor(fields["count"], torch.int32),
                           tensor(fields["learning_rate"]))
    else:
        raise ValueError(
            "state_from_numpy: expected Adam (mu, nu, count, learning_rate) "
            f"or Adagrad (hist, count, learning_rate) state, got "
            f"{sorted(fields)}"
        )
    state = SVGDState(tensor(particles), opt, tensor(step, torch.int32))
    if mesh is None:
        return state
    from ..parallel.mesh import Mesh2D
    if isinstance(mesh, Mesh2D):
        from ..parallel.sharded2d import shard_state_2d
        return shard_state_2d(state, mesh)
    from ..parallel.sharded import shard_state
    return shard_state(state, mesh)
