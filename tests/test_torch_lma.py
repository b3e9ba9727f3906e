"""The port's plain tap sum (busca_tpu_torch/ops/lma.py) against the JAX
package's Pallas kernel (interpret mode on the CPU) and its direct
formulation, on the same seeded inputs; and the tap sum over level maps at
their own resolutions against ``jax.image.resize`` of each level followed by
the same two JAX functions.

Tolerance 1e-5 (the JAX suite's own kernel-vs-reference bound,
tests/test_deform.py); the plain version repeats the reference's 36 terms in
the same order, so it is expected to agree far closer.
"""

import jax
import jax.experimental.pallas as pl
import numpy as np
import pytest
import torch

from busca_tpu.ops import lma_pallas
from busca_tpu_torch.ops.lma import (
    local_tap_sum,
    local_tap_sum_levels,
    local_tap_sum_plain,
    upsample_bilinear_plain,
)

TOL = 1e-5
SHAPES = {
    # the ragged shape of tests/test_deform.py (H4 = 20: not a multiple of 8)
    "ragged": (3, 20, 24, 64, 4, (1, 2, 4)),
    # four levels, H4 = 13 (odd, not a multiple of 8), narrow heads
    "four_levels": (4, 13, 17, 32, 8, (1, 2, 4, 8)),
}
# query grid, then the levels' (h, w) at their own resolutions
PYRAMIDS = {
    "power_of_two": ((16, 24), [(16, 24), (8, 12), (4, 6), (2, 3)]),
    # SAME-padded sizes: no level is a whole-number fraction of the grid
    "ragged": ((13, 17), [(13, 17), (7, 9), (4, 5), (2, 3)]),
}
PYRAMID_C, PYRAMID_HEADS = 32, 4


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


def _pyramid_inputs(name, seed):
    (h4, w4), hws = PYRAMIDS[name]
    rng = np.random.RandomState(seed)
    levels = [rng.randn(h, w, PYRAMID_C).astype(np.float32) for h, w in hws]
    logits = rng.randn(h4, w4, PYRAMID_HEADS, len(hws) * 9)
    wts = np.array(jax.nn.softmax(logits, axis=-1), np.float32)
    dils = tuple(max(h4 // h, 1) for h, _ in hws)
    return levels, wts, dils


def _jax_upsampled(levels, h4, w4):
    return np.stack([np.asarray(jax.image.resize(
        v, (h4, w4, v.shape[2]), "bilinear")) for v in levels])


@pytest.mark.parametrize("name", sorted(PYRAMIDS))
def test_levels_match_jax_reference(name):
    levels, wts, dils = _pyramid_inputs(name, seed=7)
    h4, w4 = wts.shape[:2]
    want = np.asarray(lma_pallas.local_tap_sum_reference(
        _jax_upsampled(levels, h4, w4), wts, dils))
    got = local_tap_sum_levels([torch.from_numpy(v) for v in levels],
                               torch.from_numpy(wts), dils, PYRAMID_HEADS)
    assert got.dtype == torch.float32 and got.shape == (h4, w4, PYRAMID_C)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("name", sorted(PYRAMIDS))
def test_levels_match_pallas_kernel(interpret, name):
    levels, wts, dils = _pyramid_inputs(name, seed=8)
    h4, w4 = wts.shape[:2]
    want = np.asarray(lma_pallas.local_tap_sum(
        _jax_upsampled(levels, h4, w4), wts, dils, PYRAMID_HEADS))
    got = local_tap_sum_levels([torch.from_numpy(v) for v in levels],
                               torch.from_numpy(wts), dils, PYRAMID_HEADS)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("name", sorted(PYRAMIDS))
def test_upsampling_matches_jax_resize(name):
    (h4, w4), hws = PYRAMIDS[name]
    rng = np.random.RandomState(9)
    for h, w in hws:
        v = rng.randn(h, w, 8).astype(np.float32)
        want = np.asarray(jax.image.resize(v, (h4, w4, 8), "bilinear"))
        got = upsample_bilinear_plain(torch.from_numpy(v), (h4, w4))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_level_at_the_query_size_goes_through_unchanged():
    """A level already of the query size is not resampled: the level-map
    sum over full-size levels equals the stacked sum bit for bit."""
    levels, wts, dils = _pyramid_inputs("ragged", seed=10)
    v0 = torch.from_numpy(levels[0])
    assert upsample_bilinear_plain(v0, v0.shape[:2]) is v0
    full = [torch.from_numpy(v) for v in _jax_upsampled(levels, 13, 17)]
    full[0] = v0
    got = local_tap_sum_levels(full, torch.from_numpy(wts), dils,
                               PYRAMID_HEADS)
    want = local_tap_sum(torch.stack(full), torch.from_numpy(wts), dils,
                         PYRAMID_HEADS)
    assert torch.equal(got, want)

