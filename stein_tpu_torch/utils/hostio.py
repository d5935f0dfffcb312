"""Host reads of device tensors, on one device or a particle mesh.

PyTorch counterpart of ``stein_tpu/utils/hostio.py``. The JAX helpers
assemble a multi-controller array with a collective; here a particle-sharded
tensor is an ordinary local block, and the caller names the mesh to gather
it over."""

from ..parallel import collectives as coll


def host_array(x, mesh=None):
    """numpy value of ``x``. With a ``mesh`` (a ``ParticleMesh``), ``x`` is
    this rank's block of rows and the full array is all-gathered: every
    rank must call this together."""
    if mesh is not None:
        x = coll.all_gather(x, mesh)
    return x.detach().cpu().numpy()


def host_scalar(x):
    """Python float of a 0-d tensor (or any number)."""
    return float(x)
