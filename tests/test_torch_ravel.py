"""The port's flat particle layout (stein_tpu_torch/utils/ravel.py) against
the JAX package's (sorted dict keys at every level, row-major leaves)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stein_tpu.utils import ravel as jrav
from stein_tpu_torch.utils import ravel as trav


def _tree(rng, n=None):
    lead = () if n is None else (n,)
    return {"w": rng.normal(size=lead + (3, 2)).astype(np.float32),
            "b": rng.normal(size=lead + (2,)).astype(np.float32),
            "z": {"y": rng.normal(size=lead + (1,)).astype(np.float32),
                  "x": rng.normal(size=lead + (4,)).astype(np.float32)}}


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def test_ravel_particles_matches_jax():
    tree = _tree(np.random.default_rng(0), n=5)
    got = trav.ravel_particles(_map(torch.from_numpy, tree))
    want = jrav.ravel_particles(_map(jnp.asarray, tree))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unravel_round_trip_and_size():
    rng = np.random.default_rng(1)
    template = _map(torch.from_numpy, _tree(rng))
    p, unravel = trav.template_unraveler(template)
    jp, _ = jrav.template_unraveler(_map(jnp.asarray, _tree(rng)))
    assert p == jp == 13
    theta = torch.arange(4 * p, dtype=torch.float32).reshape(4, p)
    tree = trav.unravel_particles(theta, unravel)
    assert tuple(tree["w"].shape) == (4, 3, 2)
    assert tuple(tree["z"]["x"].shape) == (4, 4)
    np.testing.assert_array_equal(trav.ravel_particles(tree).numpy(),
                                  theta.numpy())


@pytest.mark.parametrize("n,p", [(7, 3), (100, 13)])
def test_init_particles_scale_and_generator(n, p):
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    a = trav.init_particles(g1, n, p, device="cpu")
    b = trav.init_particles(g2, n, p, device="cpu")
    assert tuple(a.shape) == (n, p) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert float(a.abs().max()) < 0.1


def test_init_particles_default_device(monkeypatch):
    """No device given: the generator's device, else the current card,
    raising without one (no fallback to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = torch.Generator().manual_seed(5)
    assert trav.init_particles(g, 3, 2).device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="init_particles.*no CUDA device"):
        trav.init_particles(None, 3, 2)
