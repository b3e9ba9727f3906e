"""The port's deformable-convolution ops (busca_tpu_torch/ops/deform.py)
against busca_tpu.ops.deform on the CPU, on seeded numpy inputs: the
bilinear sampler at fractional positions, across integer positions and
outside the map; DCNv2 with offsets in +-4 (taps wholly outside the map
too), with and without the mask and the bias, at strides 1 and 2; the
windowed form at windows 2 and 3 with offsets past the window (its clamp);
the fixed-support form against the zero-offset DCN.

busca_tpu's ops are NHWC with HWIO weights; the port's are NCHW with OIHW
weights (torchvision's layout), so the inputs are transposed on the way in
and the outputs on the way out.  Tolerance 1e-5 (relative and absolute):
the samples are the same arithmetic, the contractions sum in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from busca_tpu.ops import deform as jd
from busca_tpu_torch.ops import deform as td
from test_torch_strongsort import one_torch_thread  # noqa: F401

TOL = 1e-5


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=tol, atol=tol)


def dcn_inputs(seed, b=2, h=9, w=11, cin=5, cout=4, stride=1, scale=4.0):
    """x, offsets in +-scale with fractional parts (ends of the range
    reach taps wholly outside the map), weight, mask, bias."""
    rng = np.random.RandomState(seed)
    ho, wo = (h + 2 - 3) // stride + 1, (w + 2 - 3) // stride + 1
    x = rng.randn(b, h, w, cin).astype(np.float32)
    off = rng.uniform(-scale, scale, (b, ho, wo, 18)).astype(np.float32)
    off[:, 0, 0, :] = -scale - 0.25  # every tap of a corner pixel outside
    off[:, 1, 2, 4:6] = [0.5, -1.0]  # exactly integer and half positions
    weight = rng.randn(3, 3, cin, cout).astype(np.float32)
    mask = rng.uniform(0, 1, (b, ho, wo, 9)).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    return x, off, weight, mask, bias


def test_bilinear_sample_matches_jax(one_torch_thread):  # noqa: F811
    rng = np.random.RandomState(0)
    img = rng.randn(7, 9, 3).astype(np.float32)
    x = rng.uniform(-3, 12, (5, 6)).astype(np.float32)
    y = rng.uniform(-3, 10, (5, 6)).astype(np.float32)
    x[0] = [-1.0, 0.0, 3.0, 8.0, 8.5, 9.0]  # integers and the edges
    y[0] = [-1.0, 0.0, 2.0, 6.0, 6.5, 7.0]
    want = jd.bilinear_sample(jnp.asarray(img), jnp.asarray(x),
                              jnp.asarray(y))
    got = td.bilinear_sample(torch.from_numpy(img), torch.from_numpy(x),
                             torch.from_numpy(y))
    assert got.shape == want.shape == (5, 6, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("with_mask,with_bias", [(True, True),
                                                 (False, False),
                                                 (True, False)])
def test_deform_conv2d_matches_jax(one_torch_thread, stride,  # noqa: F811
                                   with_mask, with_bias):
    x, off, weight, mask, bias = dcn_inputs(stride, stride=stride)
    m = mask if with_mask else None
    bb = bias if with_bias else None
    want = jd.deform_conv2d(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(weight),
        None if m is None else jnp.asarray(m),
        None if bb is None else jnp.asarray(bb), stride=stride, padding=1)
    got = td.deform_conv2d(
        nchw(x), nchw(off), oihw(weight),
        None if m is None else nchw(m),
        None if bb is None else torch.from_numpy(bb), stride=stride,
        padding=1)
    assert got.shape == (x.shape[0], weight.shape[3]) + want.shape[1:3]
    close(got, want)


def test_deform_conv2d_far_outside_is_bias_only(one_torch_thread):  # noqa
    """Every tap far outside the map: zero samples, the bias alone."""
    x, off, weight, mask, bias = dcn_inputs(5)
    off[:] = 50.25
    got = td.deform_conv2d(nchw(x), nchw(off), oihw(weight), nchw(mask),
                           torch.from_numpy(bias))
    want = jd.deform_conv2d(jnp.asarray(x), jnp.asarray(off),
                            jnp.asarray(weight), jnp.asarray(mask),
                            jnp.asarray(bias))
    close(got, want)
    np.testing.assert_array_equal(
        got.numpy(), np.broadcast_to(bias[None, :, None, None], got.shape))


@pytest.mark.parametrize("window", [2, 3])
def test_windowed_matches_jax(one_torch_thread, window):  # noqa: F811
    """Offsets in +-4 pass the window at 2 and at 3: the clamp is
    exercised, and the windowed form equals the exact DCN at the clipped
    offsets."""
    x, off, weight, mask, bias = dcn_inputs(10 + window, b=1, h=7, w=8,
                                            cin=3, cout=4)
    want = jd.deform_conv2d_windowed(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(weight),
        jnp.asarray(mask), jnp.asarray(bias), window=window)
    got = td.deform_conv2d_windowed(
        nchw(x), nchw(off), oihw(weight), nchw(mask),
        torch.from_numpy(bias), window=window)
    assert (np.abs(off) > window).any()
    close(got, want)
    clipped = td.deform_conv2d(nchw(x), nchw(np.clip(off, -window, window)),
                               oihw(weight), nchw(mask),
                               torch.from_numpy(bias))
    close(got, clipped.numpy().transpose(0, 2, 3, 1), 1e-4)


@pytest.mark.parametrize("stride", [1, 2])
def test_local_matches_jax_and_zero_offset_dcn(one_torch_thread,  # noqa
                                               stride):
    x, _, weight, mask, bias = dcn_inputs(20 + stride, stride=stride)
    want = jd.local_modulated_conv2d(
        jnp.asarray(x), jnp.asarray(weight), jnp.asarray(mask),
        jnp.asarray(bias), stride=stride, padding=1)
    got = td.local_modulated_conv2d(nchw(x), oihw(weight), nchw(mask),
                                    torch.from_numpy(bias), stride=stride)
    close(got, want)
    zero = np.zeros(mask.shape[:3] + (18,), np.float32)
    dcn = td.deform_conv2d(nchw(x), nchw(zero), oihw(weight), nchw(mask),
                           torch.from_numpy(bias), stride=stride)
    close(got, dcn.numpy().transpose(0, 2, 3, 1))
