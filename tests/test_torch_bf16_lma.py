"""The port's plain tap sum (busca_tpu_torch/ops/lma.py) in bfloat16,
busca_tpu's production mode (values and weights in bf16, a float32
accumulator, the output in bf16), against the JAX package on the CPU, on
seeded inputs (bf16 values; weights softmaxed in bf16, as the decoder's).

- Stacked levels: equal to busca_tpu's Pallas kernel (interpret mode) and
  to its direct formulation, bit for bit.
- Level maps at their own resolutions, against ``jax.image.resize`` of each
  bf16 level (its weights cast to bf16; x, then y, rounded to bf16 after
  each) followed by the direct formulation, at the MOT17 decoder's pyramid
  (whole-number ratios 2, 4, 8; C=32) and a ragged one.  Each upsampled
  value is held to one bf16 ulp of jax's: the float32 lerps of two
  libraries may sit a float32 ulp apart, which the rounding to bf16 can
  turn into one bf16 ulp.  The exact share is printed and pinned (measured:
  every value equal at both pyramids), and the sums are held to two bf16
  ulps of their scale (measured: equal).
"""

import jax
import numpy as np
import pytest
import torch

from busca_tpu.ops import lma_pallas
from busca_tpu_torch.ops.lma import (
    local_tap_sum,
    local_tap_sum_levels,
    local_tap_sum_levels_plain,
    upsample_bilinear_plain,
)
from test_torch_lma import (  # noqa: F401 (the fixture)
    PYRAMID_C,
    PYRAMID_HEADS,
    PYRAMIDS,
    SHAPES,
    interpret,
)
from torch_oracles import bf16_scale_ulps

# the MOT17 decoder's pyramid (whole-number ratios 2, 4, 8) at C=32, and the
# ragged one
BF16_PYRAMIDS = {
    "mot17": ((160, 272), [(160, 272), (80, 136), (40, 68), (20, 34)]),
    "ragged": PYRAMIDS["ragged"],
}
BF16_EXACT_SHARE = 0.99  # of upsampled values equal to jax's (measured 1.0)


def _bf16(a):
    """numpy float32 -> (jax bf16 array, the same values as a torch bf16
    tensor)."""
    j = jax.numpy.asarray(a).astype(jax.numpy.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jax.numpy.float32))).to(
        torch.bfloat16)


def _bf16_weights(rng, h4, w4, heads, taps):
    """bf16 logits softmaxed in bf16, as the decoder's weights."""
    logits = jax.numpy.asarray(rng.randn(h4, w4, heads, taps),
                               jax.numpy.float32).astype(jax.numpy.bfloat16)
    return _bf16(np.asarray(jax.nn.softmax(logits, -1).astype(
        jax.numpy.float32)))


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_bf16_matches_pallas_kernel(interpret, shape):
    levels, h4, w4, c, heads, dils = SHAPES[shape]
    rng = np.random.RandomState(13)
    jv, tv = _bf16(rng.randn(levels, h4, w4, c).astype(np.float32))
    jw, tw = _bf16_weights(rng, h4, w4, heads, levels * 9)
    want = lma_pallas.local_tap_sum(jv, jw, dils, heads)
    assert want.dtype == jax.numpy.bfloat16
    got = local_tap_sum(tv, tw, dils, heads)
    assert got.dtype == torch.bfloat16 and got.shape == (h4, w4, c)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jax.numpy.float32)))
    ref = lma_pallas.local_tap_sum_reference(jv, jw, dils)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jax.numpy.float32)))


def _bf16_ulp(x):
    """The bf16 ulp of each value of ``x`` (float32 array)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.float32(2.0 ** -126))))
    return (2.0 ** (e - 7)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(BF16_PYRAMIDS))
def test_levels_bf16_match_jax_resize_chain(name):
    """busca_tpu's chain in bf16: ``jax.image.resize`` of each bf16 level,
    stacked, then the tap sum; against the port's level-map sum."""
    (h4, w4), hws = BF16_PYRAMIDS[name]
    rng = np.random.RandomState(14)
    levels = [_bf16(rng.randn(h, w, PYRAMID_C).astype(np.float32))
              for h, w in hws]
    jw, tw = _bf16_weights(rng, h4, w4, PYRAMID_HEADS, len(hws) * 9)
    dils = tuple(max(h4 // h, 1) for h, _ in hws)
    for (h, w), (jv, tv) in zip(hws, levels):
        want = np.asarray(jax.image.resize(
            jv, (h4, w4, PYRAMID_C), "bilinear").astype(jax.numpy.float32))
        got = upsample_bilinear_plain(tv, (h4, w4))
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        diff = np.abs(got - want)
        exact = float((diff == 0).mean())
        print(f"{name} level {h}x{w} -> {h4}x{w4}: exact share {exact:.4f}")
        assert (diff <= _bf16_ulp(want)).all()
        assert exact >= BF16_EXACT_SHARE
    want = lma_pallas.local_tap_sum_reference(
        jax.numpy.stack([jax.image.resize(jv, (h4, w4, PYRAMID_C),
                                          "bilinear") for jv, _ in levels]),
        jw, dils)
    want = np.asarray(want.astype(jax.numpy.float32))
    got = local_tap_sum_levels([tv for _, tv in levels], tw, dils,
                               PYRAMID_HEADS)
    assert got.dtype == torch.bfloat16
    ulps, exact = bf16_scale_ulps(got.float().numpy(), want)
    print(f"{name} tap sum: {ulps:.2f} ulps of scale, exact {exact:.4f}")
    assert ulps <= 2.0
    assert torch.equal(got, local_tap_sum_levels_plain(
        [tv for _, tv in levels], tw, dils))
