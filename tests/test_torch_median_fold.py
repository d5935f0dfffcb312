"""The CUDA median kernel's search schedule (two quad-ary rounds a sweep,
``ops.fused_median.warm_search_folded``) against the JAX package's
``ops.median._warm_search`` on the same f32 block: bitwise, cold and warm,
on blocks with ties and on exact lattice D, with 1-8 brackets and odd and
even ``warm_passes``.

The JAX search runs op by op (``jax.disable_jit``): compiled for the CPU,
XLA fuses the round body and contracts lo + b * w into one FMA (one
rounding where the expression has two, an ulp apart when b = 3), while the
kernel, the port's plain search and op-by-op JAX round each operation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stein_tpu.ops import median as jmed
from stein_tpu_torch.ops import fused_median as tfm
from stein_tpu_torch.ops import median as tmed


def _block(kind, m=64, n=200, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "lattice":
        # Integer particles with columns summing to 0: D exact in any order.
        half = rng.integers(-3, 4, size=(n // 2, 7))
        theta = np.concatenate([half, -half]).astype(np.float64)
    else:
        theta = rng.normal(size=(n, 5))
    rows = theta[:: max(n // m, 1)][:m]
    D = ((rows[:, None, :] - theta[None, :, :]) ** 2).sum(-1)
    if kind == "ties":
        D = np.round(D * 2.0) / 2.0   # few distinct values, many ties
    return D.astype(np.float32)


def _both(D, med_prev, passes, brackets):
    got = tfm.warm_search_folded(torch.from_numpy(D),
                                 torch.tensor(med_prev, dtype=torch.float32),
                                 passes, brackets)
    with jax.disable_jit():
        want = jmed._warm_search(jnp.asarray(D), jnp.float32(med_prev),
                                 passes, brackets)
    return got.numpy(), np.asarray(want)


# med_prev as a multiple of the block's median: 0 is the cold search, ~1
# verifies the tight bracket, 0.8 the mid, 0.5 the wide, 3 none.
@pytest.mark.parametrize("kind", ["normal", "ties", "lattice"])
@pytest.mark.parametrize("hint", [0.0, 1.0001, 0.8, 0.5, 3.0])
@pytest.mark.parametrize("passes", [1, 2, 5, 8, 30])
def test_folded_search_bitwise(kind, hint, passes):
    D = _block(kind, seed=passes)
    med = float(np.median(D))
    got, want = _both(D, np.float32(hint * med), passes,
                      tmed.DEFAULT_BRACKETS)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_brackets", range(1, 9))
@pytest.mark.parametrize("passes", [7, 8])
def test_folded_search_bracket_counts(n_brackets, passes):
    """1 to 8 candidate brackets (the kernel's limit), tightest first."""
    brackets = tuple((1.0 - 0.1 * (i + 1), 1.0 + 0.15 * (i + 1))
                     for i in range(n_brackets))
    D = _block("normal", seed=n_brackets)
    med = float(np.median(D))
    for hint in (0.0, 1.01, 0.7):
        got, want = _both(D, np.float32(hint * med), passes, brackets)
        np.testing.assert_array_equal(got, want)


def test_folded_search_at_the_main_path_shape():
    """The [256, 1000] block of the main path, cold (30 passes) and warm
    (8), against the JAX search and the port's plain search."""
    rng = np.random.default_rng(3)
    theta = (rng.normal(size=(1000, 16)) * 0.01).astype(np.float32)
    D = tmed.row_subsample_block(torch.from_numpy(theta), 256).numpy()
    cold, want = _both(D, np.float32(0.0), 30, tmed.DEFAULT_BRACKETS)
    np.testing.assert_array_equal(cold, want)
    warm, want = _both(D, np.float32(cold * 1.01), 8, tmed.DEFAULT_BRACKETS)
    np.testing.assert_array_equal(warm, want)
    plain = tmed._warm_search(torch.from_numpy(D),
                              torch.tensor(cold * 1.01), 8)
    np.testing.assert_array_equal(warm, plain.numpy())
