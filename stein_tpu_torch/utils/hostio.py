"""Host reads of device tensors, on one device or a particle mesh.

PyTorch counterpart of ``stein_tpu/utils/hostio.py``. The JAX helpers
assemble a multi-controller array with a collective; here a particle-sharded
tensor is an ordinary local block, and the caller names the mesh to gather
it over."""

import torch

from ..parallel import collectives as coll


def host_array(x, mesh=None):
    """numpy value of ``x``. With a ``mesh`` (a ``ParticleMesh``), ``x`` is
    this rank's block of rows and the full array is all-gathered (on a
    ``Mesh2D``, its [n_loc, p_loc] block over both axes): every rank must
    call this together. numpy has no bfloat16 (the JAX package returns
    ml_dtypes' bfloat16): a bfloat16 tensor comes back as float32, which
    holds every bfloat16 value exactly."""
    if mesh is not None:
        x = coll.all_gather(x, mesh)
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        x = x.to(torch.float32)
    return x.numpy()


def host_scalar(x):
    """Python float of a 0-d tensor (or any number)."""
    return float(x)
