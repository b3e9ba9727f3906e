"""The port's plain crop op (busca_tpu_torch.ops.crop) against busca_tpu's
crop_resize_normalize (gather and matmul forms) and the interpret-mode
Pallas kernel, on the CPU.

Tolerances: at 96x128 every float32 prefix sum of the JAX integral image is
an exact integer (< 2**24), so the two packages compute the same pad means;
there the quantized output must equal the gather form exactly (atol 0, the
bar tests/test_crop.py holds the two JAX forms to) and unquantized agree to
1e-3.  The matmul form reassociates the blend and lands one LSB off the
gather form on rare elements, so against it <= 1 LSB on <= 0.1%.
Against the Pallas kernel the bar is tests/test_crop_pallas.py's atol 2.0.
At 256x384 the JAX float32 sums are no longer exact, so quantized output may
differ by one uint8 LSB where a pad mean is used.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from busca_tpu.ops.crop import crop_resize_normalize as jax_crop
from busca_tpu.ops.crop_pallas import crop_resize_pallas
from busca_tpu_torch.ops import crop as tcrop
from test_torch_crop_cuda import WITNESS_BOXES

OUT_HW = (48, 16)


def _boxes(h, w, rng, n_random=6):
    fixed = [
        [10.3, 5.7, 60.9, 80.2],            # interior
        [-20.0, -10.0, 30.0, 40.0],         # partly outside, top-left
        [w - 30.5, h - 37.2, w + 30.0, h + 20.0],  # partly outside, bottom-right
        [50.0, 50.0, 50.0, 50.0],           # degenerate -> zero crop
        [w + 500.0, h + 500.0, w + 600.0, h + 700.0],  # wholly outside
        [-80.0, 10.0, -5.0, 60.0],          # wholly outside, left
        [0.0, 0.0, float(w), float(h)],     # full frame
        [12.2, 30.9, 12.6, 31.1],           # sub-pixel: 1x1 after floor/ceil
    ]
    rand = []
    for _ in range(n_random):
        x1, y1 = rng.uniform(-30, w - 10), rng.uniform(-30, h - 10)
        rand.append([x1, y1, x1 + rng.uniform(3, 90), y1 + rng.uniform(3, 120)])
    return np.asarray(fixed + rand, np.float32)


def _port(frame, boxes, **kw):
    return tcrop.crop_resize_normalize(
        torch.from_numpy(frame), torch.from_numpy(boxes), OUT_HW, **kw
    ).numpy()


FLAGS = list(itertools.product((False, True), repeat=4))


@pytest.mark.parametrize("normalize,bgr_input,rgb_output,quantize", FLAGS)
def test_plain_crop_matches_jax_gather_and_matmul(normalize, bgr_input,
                                                  rgb_output, quantize):
    rng = np.random.RandomState(3)
    frame = rng.randint(0, 256, (96, 128, 3)).astype(np.uint8)
    boxes = _boxes(96, 128, rng)
    kw = dict(normalize=normalize, bgr_input=bgr_input,
              rgb_output=rgb_output, quantize_uint8=quantize)
    got = _port(frame, boxes, **kw)
    assert got.shape == (len(boxes),) + OUT_HW + (3,)
    # one uint8 LSB in the output's units
    lsb = 1.0 / (255.0 * 0.224) if normalize else 1.0
    # quantized: exact against the gather form (up to the float32 rounding
    # of the normalization, which XLA fuses differently); unquantized: 1e-3
    atol = (1e-6 if normalize else 0.0) if quantize else 1e-3
    want = np.asarray(jax_crop(frame, boxes, OUT_HW, method="gather", **kw))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    # the matmul form reassociates the blend: on these boxes it is itself one
    # LSB off the gather form on one element, so it is held to <= 1 LSB on at
    # most 0.1% of the elements
    want = np.asarray(jax_crop(frame, boxes, OUT_HW, method="matmul", **kw))
    diff = np.abs(got - want)
    assert diff.max() <= lsb + 1e-6
    assert (diff > atol).mean() <= 1e-3


def test_invalid_boxes_give_zero_crops_before_normalization():
    rng = np.random.RandomState(4)
    frame = rng.randint(0, 256, (96, 128, 3)).astype(np.uint8)
    boxes = _boxes(96, 128, rng)
    raw = _port(frame, boxes, normalize=False, rgb_output=False)
    for i in (3, 4, 5):  # degenerate and wholly outside
        assert not raw[i].any()
    norm = _port(frame, boxes, normalize=True, rgb_output=False)
    mean = np.array([0.406, 0.456, 0.485], np.float32)
    std = np.array([0.225, 0.224, 0.299], np.float32)
    np.testing.assert_allclose(norm[3], np.broadcast_to(-mean / std,
                                                        norm[3].shape),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("quantize", [True, False])
def test_plain_crop_matches_pallas_interpret(quantize):
    rng = np.random.RandomState(5)
    frame = rng.randint(0, 256, (120, 160, 3)).astype(np.uint8)
    boxes = _boxes(120, 160, rng, n_random=2)
    out_hw = (64, 32)
    got = tcrop.crop_resize_normalize(
        torch.from_numpy(frame), torch.from_numpy(boxes), out_hw,
        normalize=False, rgb_output=False, quantize_uint8=quantize,
    ).numpy()
    want = np.asarray(crop_resize_pallas(
        jnp.asarray(frame), jnp.asarray(boxes), out_hw,
        quantize_uint8=quantize, interpret=True,
    ))
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0)


def test_plain_crop_within_one_lsb_at_256x384():
    rng = np.random.RandomState(6)
    frame = rng.randint(0, 256, (256, 384, 3)).astype(np.uint8)
    boxes = _boxes(256, 384, rng, n_random=24)
    got = _port(frame, boxes, normalize=False, rgb_output=False)
    for method in ("gather", "matmul"):
        want = np.asarray(jax_crop(frame, boxes, OUT_HW, normalize=False,
                                   rgb_output=False, method=method))
        np.testing.assert_allclose(got, want, rtol=0, atol=1.0,
                                   err_msg=method)


def test_pad_mean_is_exact_at_1080p():
    """The port's pad mean equals the float64 mean of the clipped region
    (int64 region sums), where busca_tpu's float32 integral image drifts."""
    rng = np.random.RandomState(8)
    h, w = 1080, 1920
    frame = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    boxes = np.array([[1500.3, 700.2, 2100.0, 1300.0],
                      [-300.0, -200.0, 900.0, 800.0],
                      [1000.0, 1000.0, 1950.5, 1090.0]], np.float32)
    _, pad = tcrop.box_params(torch.from_numpy(frame),
                              torch.from_numpy(boxes), quantize_uint8=False)
    for b, got in zip(boxes, pad.numpy()):
        x1, y1 = max(int(np.floor(b[0])), 0), max(int(np.floor(b[1])), 0)
        x2, y2 = min(int(np.ceil(b[2])), w), min(int(np.ceil(b[3])), h)
        region = frame[y1:y2, x1:x2].astype(np.int64)
        exact = np.float32(region.sum()) / (np.float32(region[..., 0].size)
                                            * np.float32(3.0))
        assert got == exact


@pytest.mark.parametrize("quantize", [True, False])
def test_pad_value_unused_when_the_cutout_is_inside(monkeypatch, quantize):
    """The premise of K1's skipped pad sums: for a box whose floor/ceil
    cutout lies inside the frame, the pad value meets only taps of weight
    exactly 0, so a pad of 0 or 255 gives the unpatched output.  300 seeded
    boxes with fractional coordinates and sizes 1-300, the full-frame
    (letterbox) box and 1-pixel boxes.  The last box (x1 = -0.5) leaves the
    frame and must change, which shows the test can fail."""
    rng = np.random.RandomState(10)
    h, w = 320, 400
    frame = torch.from_numpy(rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    n = 300
    bw, bh = rng.uniform(1, 300, n), rng.uniform(1, 300, n)
    x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
    boxes = np.concatenate([
        np.stack([x1, y1, x1 + bw, y1 + bh], 1),
        [[0.0, 0.0, w, h], [12.2, 30.9, 12.6, 31.1], [w - 0.7, h - 0.2, w, h],
         [0.0, 0.0, 1.0, 1.0], [-0.5, 10.2, 40.3, 60.7]],
    ]).astype(np.float32)
    boxes = torch.from_numpy(boxes)
    ip, _ = tcrop.box_params(frame, boxes, quantize)
    x1i, y1i, wc, hc = ip[:, 0], ip[:, 1], ip[:, 2], ip[:, 3]
    inside = (x1i >= 0) & (y1i >= 0) & (x1i + wc <= w) & (y1i + hc <= h)
    assert bool(inside[:-1].all()) and not bool(inside[-1])
    assert bool(ip[:, 8].all())  # every box is valid

    want = tcrop.crop_resize_plain(frame, boxes, OUT_HW, quantize)
    box_params = tcrop.box_params
    got = {}
    for pad in (0.0, 255.0):
        def patched(frame, boxes, quantize_uint8, pad=pad):
            ip, pad_val = box_params(frame, boxes, quantize_uint8)
            return ip, torch.full_like(pad_val, pad)

        monkeypatch.setattr(tcrop, "box_params", patched)
        got[pad] = tcrop.crop_resize_plain(frame, boxes, OUT_HW, quantize)
    for pad, out in got.items():
        assert torch.equal(out[:-1], want[:-1]), pad
    assert not torch.equal(got[0.0][-1], got[255.0][-1])


def test_integral_image_is_exact_int64():
    frame = np.full((300, 400, 3), 255, np.uint8)
    ii = tcrop.integral_image(torch.from_numpy(frame))
    assert ii.dtype == torch.int64 and ii.shape == (301, 401)
    assert int(ii[-1, -1]) == 300 * 400 * 3 * 255
    assert int(ii[0].abs().sum()) == 0 and int(ii[:, 0].abs().sum()) == 0


def test_cpu_tensor_never_touches_the_kernel():
    from busca_tpu_torch.ops.crop_cuda import crop_resize_cuda

    before = crop_resize_cuda.launches
    _port(np.zeros((32, 32, 3), np.uint8),
          np.array([[1.0, 1.0, 20.0, 20.0]], np.float32))
    assert crop_resize_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA frame"):
        crop_resize_cuda(torch.zeros((8, 8, 3), dtype=torch.uint8),
                         torch.zeros((1, 4)), OUT_HW)


@pytest.mark.parametrize("hw,max_drift", [((256, 384), 1.0),
                                          ((1080, 1920), 16.0)])
def test_jax_float32_pad_mean_drift(hw, max_drift):
    """Measures the known difference from busca_tpu: its float32 integral
    image rounds once prefix sums pass 2**24, so its pad means drift from
    the exact (int64) ones the port uses.  20,000 random boxes, seeded; the
    drift stays below ``max_drift`` levels and is nonzero at both sizes."""
    from busca_tpu.ops.crop import integral_image as jax_ii

    h, w = hw
    rng = np.random.RandomState(9)
    frame = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    ii32 = np.asarray(jax_ii(frame))
    ii64 = tcrop.integral_image(torch.from_numpy(frame)).numpy()
    n = 20000
    x1 = rng.randint(0, w, n)
    y1 = rng.randint(0, h, n)
    x2 = np.minimum(x1 + rng.randint(1, w // 2, n), w)
    y2 = np.minimum(y1 + rng.randint(1, h // 2, n), h)
    cnt = ((y2 - y1) * (x2 - x1)).astype(np.float32) * np.float32(3.0)

    def mean(ii):
        total = ii[y2, x2] - ii[y1, x2] - ii[y2, x1] + ii[y1, x1]
        return total.astype(np.float32) / cnt

    drift = np.abs(mean(ii32) - mean(ii64))
    flips = int((np.trunc(mean(ii32)) != np.trunc(mean(ii64))).sum())
    print(f"{h}x{w}: max pad-mean drift {drift.max():.3f} levels, "
          f"trunc flips {flips}/{n}")
    assert 0 < drift.max() < max_drift


def test_card_frame_contract_is_uint8():
    """The op takes uint8 frames on the card (what K1 reads) and uint8 or
    float on the CPU; the dispatcher's check raises before any launch."""
    frame = np.random.RandomState(9).randint(0, 256, (24, 32, 3))
    boxes = np.array([[2.0, 3.0, 20.0, 18.0]], np.float32)
    tcrop.check_card_frame(torch.from_numpy(frame.astype(np.uint8)))
    for bad in (torch.from_numpy(frame.astype(np.float32)),
                torch.zeros((24, 32, 4), dtype=torch.uint8),
                torch.zeros((24, 32), dtype=torch.uint8)):
        with pytest.raises(ValueError, match="uint8"):
            tcrop.check_card_frame(bad)
    as_float = _port(frame.astype(np.float32), boxes)
    as_uint8 = _port(frame.astype(np.uint8), boxes)
    np.testing.assert_array_equal(as_float, as_uint8)


def _wrap32(v: int) -> int:
    return (v + 2 ** 31) % 2 ** 32 - 2 ** 31


def test_witness_boxes_follow_floor_int64_int32():
    """At any float32 box the geometry is floor -> int64 -> int32, the rule
    K1 shares (``csrc/crop_resize.cu``, ``box_geometry``): the clip, the
    extents and the validity are formed in 64 bits, x1, y1, wc, hc are
    then wrapped.  The two witness boxes are valid, their x taps all fall
    outside the clip, and each crops to its pad mean; busca_tpu's crop
    gives zeros there (its float -> int32 conversion saturates, so the
    width wraps to -1 and the box reads as invalid), which is what K1 gave
    before it took this rule (tests/test_torch_crop_cuda.py holds K1 to
    the plain version at these boxes on the card)."""
    h, w = 896, 1600
    frame = np.random.RandomState(21).randint(0, 256, (h, w, 3)).astype(
        np.uint8)
    ip, pad = tcrop.box_params(torch.from_numpy(frame),
                               torch.from_numpy(WITNESS_BOXES), True)
    for row, b in zip(ip.tolist(), WITNESS_BOXES.astype(np.float64)):
        x1, y1 = int(np.floor(b[0])), int(np.floor(b[1]))
        x2, y2 = int(np.ceil(b[2])), int(np.ceil(b[3]))
        want = [_wrap32(x1), _wrap32(y1), _wrap32(x2 - x1), _wrap32(y2 - y1),
                min(max(x1, 0), w), min(max(x2, 0), w),
                min(max(y1, 0), h), min(max(y2, 0), h), 1]
        assert row == want
    got = _port(frame, WITNESS_BOXES, normalize=False, rgb_output=False)
    for k in range(len(WITNESS_BOXES)):
        cx1, cx2, cy1, cy2 = ip[k, 4:8].tolist()
        region = frame[cy1:cy2, cx1:cx2].astype(np.int64)
        mean = np.trunc(np.float32(region.sum())
                        / np.float32(region.size))
        assert float(pad[k]) == mean
        np.testing.assert_array_equal(got[k], np.full_like(got[k], mean))
    jax_out = np.asarray(jax_crop(frame, WITNESS_BOXES, OUT_HW,
                                  normalize=False, rgb_output=False))
    assert not jax_out.any()

