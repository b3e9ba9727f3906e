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


def test_k1_validates_inputs(cuda):
    from busca_tpu_torch.ops.crop_cuda import crop_resize_cuda

    frame, boxes = _inputs(cuda, h=64, w=64, n=4)
    with pytest.raises(ValueError, match="uint8"):
        crop_resize_cuda(frame.float(), boxes, (32, 16))
    with pytest.raises(ValueError, match=r"\[N, 4\]"):
        crop_resize_cuda(frame, boxes[:, :3], (32, 16))
    empty = crop_resize_cuda(frame, boxes[:0], (32, 16))
    assert empty.shape == (0, 32, 16, 3)
