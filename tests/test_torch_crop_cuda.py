"""Kernel K1 (busca_tpu_torch/csrc/crop_resize.cu) against its plain torch
version, on the card.  A CUDA kernel has no CPU or interpret mode, so these
tests skip without a CUDA device; ``python3 chip_smoke.py`` runs the same
comparison at full size.

Tolerance: exact.  K1 is compiled with -fmad=false and repeats the plain
version's float32 operations in the same order, so every element agrees bit
for bit (the acceptance bar would allow one uint8 LSB quantized and 1e-3
unquantized).
"""

import itertools

import numpy as np
import pytest
import torch

from busca_tpu_torch.ops.crop import crop_resize_normalize_plain

pytestmark = pytest.mark.cuda

# Boxes of lost tracks whose Kalman width ran away, as BYTE handed them to
# the crop op on a served 896x1600 canvas: x beyond +-2**31
WITNESS_BOXES = np.array([[-27220402176, 740.96, 27220404224, 926.42],
                          [-1640454400, 855.24, 1640454912, 880.46]],
                         np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("K1 is a CUDA kernel: needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(device, h=1080, w=1920, n=64, seed=1):
    rng = np.random.RandomState(seed)
    frame = torch.from_numpy(
        rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).to(device)
    boxes = []
    for i in range(n):
        bw, bh = rng.uniform(4, 300), rng.uniform(4, 600)
        x1 = rng.uniform(-bw, w)
        y1 = rng.uniform(-bh, h)
        boxes.append([x1, y1, x1 + bw, y1 + bh])
    boxes[0] = [-500.0, -400.0, -100.0, -10.0]  # wholly outside
    boxes[1] = [300.0, 300.0, 300.0, 700.0]     # degenerate
    return frame, torch.tensor(boxes, dtype=torch.float32, device=device)


@pytest.mark.parametrize("normalize,rgb_output,quantize,bgr_input",
                         list(itertools.product((False, True), repeat=4)))
def test_k1_matches_plain(cuda, normalize, rgb_output, quantize, bgr_input):
    from busca_tpu_torch.ops.crop_cuda import crop_resize_cuda

    frame, boxes = _inputs(cuda)
    kw = dict(normalize=normalize, bgr_input=bgr_input,
              rgb_output=rgb_output, quantize_uint8=quantize)
    before = crop_resize_cuda.launches
    got = crop_resize_cuda(frame, boxes, (384, 128), **kw)
    want = crop_resize_normalize_plain(frame, boxes, (384, 128), **kw)
    torch.cuda.synchronize()
    assert crop_resize_cuda.launches == before + 1
    assert torch.equal(got, want)


MAIN_KW = dict(normalize=False, bgr_input=True, rgb_output=False)


def _held(frame, boxes, out_hw, **kw):
    """K1 against the plain version, exactly, with one launch counted."""
    from busca_tpu_torch.ops.crop_cuda import crop_resize_cuda

    before = crop_resize_cuda.launches
    got = crop_resize_cuda(frame, boxes, out_hw, **kw)
    want = crop_resize_normalize_plain(frame, boxes, out_hw, **kw)
    torch.cuda.synchronize()
    assert crop_resize_cuda.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("quantize", [True, False])
def test_k1_pad_path_4k_exact(cuda, quantize):
    """The pad sums at 2160x3840 with values 200-255: boxes across each edge
    and corner, and one covering the frame, whose region total passes
    2**32."""
    h, w = 2160, 3840
    rng = np.random.RandomState(12)
    frame = torch.from_numpy(
        rng.randint(200, 256, (h, w, 3), dtype=np.uint8)).to(cuda)
    assert int(frame.to(torch.int64).sum()) > 2 ** 32
    boxes = torch.tensor([
        [-120.5, 800.3, 180.2, 1300.7],         # left edge
        [1500.2, -90.6, 1800.9, 400.1],         # top edge
        [3700.4, 1200.2, 3950.8, 1700.5],       # right edge
        [2500.1, 1900.3, 2700.6, 2300.9],       # bottom edge
        [-50.5, -60.5, 250.5, 500.5],           # top-left corner
        [3600.0, 1800.0, 3900.0, 2200.0],       # bottom-right corner
        [-100.0, -50.0, w + 100.0, h + 50.0],   # covers the frame
        [1000.5, 1000.5, 1200.5, 1500.5],       # inside
    ], dtype=torch.float32, device=cuda)
    _held(frame, boxes, (384, 128), quantize_uint8=quantize, **MAIN_KW)


@pytest.mark.parametrize("out_hw", [(384, 128), (612, 1088), (37, 30)])
def test_k1_boxes_inside_the_frame_exact(cuda, out_hw):
    """Boxes whose cutout lies inside the frame (no pad sum): the letterbox
    box, 1-pixel boxes and seeded fractional boxes; a ragged output width
    (30) takes the scalar stores."""
    h, w = 1080, 1920
    rng = np.random.RandomState(13)
    frame = torch.from_numpy(
        rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).to(cuda)
    bw, bh = rng.uniform(1, 300, 24), rng.uniform(1, 600, 24)
    x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
    boxes = np.concatenate([
        np.stack([x1, y1, x1 + bw, y1 + bh], 1),
        [[0.0, 0.0, w, h], [500.5, 200.2, 500.9, 200.7],
         [0.0, 0.0, 1.0, 1.0], [w - 0.5, h - 0.5, w, h]],
    ]).astype(np.float32)
    boxes = torch.from_numpy(boxes).to(cuda)
    for quantize in (True, False):
        _held(frame, boxes, out_hw, quantize_uint8=quantize, **MAIN_KW)


def test_k1_far_boxes_exact(cuda):
    """Boxes at +-1e5: covering the frame, across one edge, wholly
    outside."""
    frame, _ = _inputs(cuda, n=2)
    boxes = torch.tensor([
        [-1e5, -1e5, 1e5, 1e5],
        [-1e5, 100.5, 50.5, 300.5],
        [300.5, -1e5, 400.5, 1e5],
        [1e5, 1e5, 1e5 + 80.0, 1e5 + 200.0],
    ], dtype=torch.float32, device=cuda)
    for quantize in (True, False):
        _held(frame, boxes, (384, 128), quantize_uint8=quantize, **MAIN_KW)


def test_k1_witness_boxes_exact(cuda):
    """Boxes beyond +-2**31, where K1's 32-bit float -> int conversion once
    parted from the plain version's floor -> int64 -> int32: the two lost
    tracks' Kalman boxes that cropped 55-72 levels off on a served
    896x1600 canvas (both crop to their pad mean), one whose left edge
    wraps to a positive int32, boxes across and past the frame at +-5e9
    and +-1e12, and one starting past 2**31 (empty)."""
    rng = np.random.RandomState(14)
    frame = torch.from_numpy(
        rng.randint(0, 256, (896, 1600, 3), dtype=np.uint8)).to(cuda)
    boxes = torch.tensor(WITNESS_BOXES.tolist() + [
        [-3e9, 100.0, 400.5, 300.5],
        [-5e9, -5e9, 5e9, 5e9],
        [-1e12, 500.5, 1e12, 700.5],
        [2.2e9, 100.0, 2.3e9, 300.0],
        [100.5, -1e12, 300.5, 1e12],
    ], dtype=torch.float32, device=cuda)
    for quantize in (True, False):
        _held(frame, boxes, (384, 128), quantize_uint8=quantize, **MAIN_KW)


def test_k1_no_boxes_launches_nothing(cuda):
    from busca_tpu_torch.ops.crop_cuda import crop_resize_cuda

    frame, boxes = _inputs(cuda, n=4)
    before = crop_resize_cuda.launches
    out = crop_resize_cuda(frame, boxes[:0], (384, 128))
    torch.cuda.synchronize()
    assert out.shape == (0, 384, 128, 3) and out.is_cuda
    assert crop_resize_cuda.launches == before


def test_k1_counts_one_launch_per_call(cuda):
    """One count per op call (the op's two kernels count once), and one per
    kernel-alone launch."""
    from busca_tpu_torch.ops import crop_cuda
    from busca_tpu_torch.ops.crop_cuda import crop_resize_cuda

    frame, boxes = _inputs(cuda, n=8)
    before = crop_resize_cuda.launches
    for _ in range(3):
        crop_resize_cuda(frame, boxes, (64, 32), **MAIN_KW)
    assert crop_resize_cuda.launches == before + 3
    out, scratch = crop_cuda.buffers(8, (64, 32), cuda)
    crop_cuda.launch(frame, boxes, scratch, out, quantize_uint8=True,
                     **MAIN_KW)
    torch.cuda.synchronize()
    assert crop_resize_cuda.launches == before + 4
    assert torch.equal(out, crop_resize_normalize_plain(
        frame, boxes, (64, 32), quantize_uint8=True, **MAIN_KW))


def test_k1_validates_inputs(cuda):
    from busca_tpu_torch.ops.crop_cuda import crop_resize_cuda

    frame, boxes = _inputs(cuda, h=64, w=64, n=4)
    with pytest.raises(ValueError, match="uint8"):
        crop_resize_cuda(frame.float(), boxes, (32, 16))
    with pytest.raises(ValueError, match=r"\[N, 4\]"):
        crop_resize_cuda(frame, boxes[:, :3], (32, 16))
    empty = crop_resize_cuda(frame, boxes[:0], (32, 16))
    assert empty.shape == (0, 32, 16, 3)
