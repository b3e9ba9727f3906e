"""The port's plain tap sum (busca_tpu_torch/ops/lma.py) against the JAX
package's Pallas kernel (interpret mode on the CPU) and its direct
formulation, on the same seeded inputs.

Tolerance 1e-5 (the JAX suite's own kernel-vs-reference bound,
tests/test_deform.py); the plain version repeats the reference's 36 terms in
the same order, so it is expected to agree far closer.
"""

import jax.experimental.pallas as pl
import numpy as np
import pytest
import torch

from busca_tpu.ops import lma_pallas
from busca_tpu_torch.ops.lma import local_tap_sum, local_tap_sum_plain

TOL = 1e-5
SHAPES = {
    # the ragged shape of tests/test_deform.py (H4 = 20: not a multiple of 8)
    "ragged": (3, 20, 24, 64, 4, (1, 2, 4)),
    # four levels, H4 = 13 (odd, not a multiple of 8), narrow heads
    "four_levels": (4, 13, 17, 32, 8, (1, 2, 4, 8)),
}


def _inputs(levels, h4, w4, c, heads, seed):
    rng = np.random.RandomState(seed)
    vals = rng.randn(levels, h4, w4, c).astype(np.float32)
    wts = rng.rand(h4, w4, heads, levels * 9).astype(np.float32)
    return vals, wts


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(
        lma_pallas.pl, "pallas_call",
        lambda *a, **k: orig(*a, **{**k, "interpret": True}),
    )


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_matches_pallas_kernel(interpret, shape):
    levels, h4, w4, c, heads, dils = SHAPES[shape]
    vals, wts = _inputs(levels, h4, w4, c, heads, seed=3)
    want = np.asarray(lma_pallas.local_tap_sum(vals, wts, dils, heads))
    got = local_tap_sum(torch.from_numpy(vals), torch.from_numpy(wts), dils,
                        heads)
    assert got.dtype == torch.float32 and got.shape == (h4, w4, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_matches_reference(shape):
    levels, h4, w4, c, heads, dils = SHAPES[shape]
    vals, wts = _inputs(levels, h4, w4, c, heads, seed=4)
    want = np.asarray(lma_pallas.local_tap_sum_reference(vals, wts, dils))
    got = local_tap_sum_plain(torch.from_numpy(vals), torch.from_numpy(wts),
                              dils)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_taps_outside_the_map_read_zeros():
    """One unit value at a corner reaches exactly the outputs its taps
    cover, weighted by the right tap and head."""
    levels, h4, w4, c, heads, dils = 2, 6, 7, 8, 2, (1, 3)
    vals = np.zeros((levels, h4, w4, c), np.float32)
    vals[1, 0, 0, 5] = 1.0  # level 1 (dil 3), head 1 (channels 4..7)
    wts = np.arange(h4 * w4 * heads * levels * 9, dtype=np.float32).reshape(
        h4, w4, heads, levels * 9)
    got = local_tap_sum_plain(torch.from_numpy(vals), torch.from_numpy(wts),
                              dils).numpy()
    want = np.zeros_like(got)
    for t, (dy, dx) in enumerate([(dy, dx) for dy in (-1, 0, 1)
                                  for dx in (-1, 0, 1)]):
        y, x = -dy * 3, -dx * 3  # the output whose tap t lands on (0, 0)
        if 0 <= y < h4 and 0 <= x < w4:
            want[y, x, 5] = wts[y, x, 1, 9 + t]
    np.testing.assert_array_equal(got, want)


def test_heads_must_match_the_weights():
    vals, wts = _inputs(2, 4, 4, 8, 2, seed=0)
    with pytest.raises(ValueError, match="heads"):
        local_tap_sum(torch.from_numpy(vals), torch.from_numpy(wts), (1, 2),
                      4)
