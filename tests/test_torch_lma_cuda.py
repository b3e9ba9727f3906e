"""Kernel K2 (busca_tpu_torch/csrc/local_tap_sum.cu) against its plain torch
version, on the card.  A CUDA kernel has no CPU or interpret mode, so these
tests skip without a CUDA device; ``python3 chip_smoke.py`` runs the same
comparison at the MOT17 shape and times it.

Tolerance: exact.  K2 is compiled with -fmad=false and adds the 36 terms in
the plain version's order, so every element agrees bit for bit (the
acceptance bar would allow 1e-5).
"""

import numpy as np
import pytest
import torch

from busca_tpu_torch.ops.lma import local_tap_sum, local_tap_sum_plain

pytestmark = pytest.mark.cuda

SHAPES = {
    "mot17": (4, 160, 272, 256, 8, (1, 2, 4, 8)),
    "ragged": (3, 20, 24, 64, 4, (1, 2, 4)),
    "tiny_decoder": (4, 8, 12, 32, 4, (1, 2, 4, 8)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("K2 is a CUDA kernel: needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(device, levels, h4, w4, c, heads, seed=0):
    g = torch.Generator().manual_seed(seed)
    vals = torch.randn((levels, h4, w4, c), generator=g)
    logits = torch.randn((h4, w4, heads, levels * 9), generator=g)
    return vals.to(device), logits.softmax(-1).to(device)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_k2_matches_plain(cuda, shape):
    from busca_tpu_torch.ops.lma_cuda import local_tap_sum_cuda

    levels, h4, w4, c, heads, dils = SHAPES[shape]
    vals, wts = _inputs(cuda, levels, h4, w4, c, heads)
    before = local_tap_sum_cuda.launches
    got = local_tap_sum(vals, wts, dils, heads)
    want = local_tap_sum_plain(vals, wts, dils)
    torch.cuda.synchronize()
    assert local_tap_sum_cuda.launches == before + 1
    assert got.shape == (h4, w4, c) and got.is_cuda
    assert torch.equal(got, want)


def test_k2_validates_inputs(cuda):
    from busca_tpu_torch.ops.lma_cuda import local_tap_sum_cuda

    vals, wts = _inputs(cuda, 2, 8, 8, 16, 2)
    with pytest.raises(ValueError, match="float32"):
        local_tap_sum_cuda(vals.double(), wts, (1, 2), 2)
    with pytest.raises(ValueError, match="weights must be"):
        local_tap_sum_cuda(vals, wts[..., :9], (1, 2), 2)
    with pytest.raises(ValueError, match="dilation"):
        local_tap_sum_cuda(vals, wts, (1,), 2)
    with pytest.raises(ValueError, match="multiple of 4"):
        local_tap_sum_cuda(vals[..., :6], wts, (1, 2), 2)
    with pytest.raises(ValueError, match="CUDA"):
        local_tap_sum_cuda(vals.cpu(), wts, (1, 2), 2)
    # a non-contiguous view is copied, not refused
    got = local_tap_sum_cuda(vals.transpose(1, 2).contiguous().transpose(1, 2),
                             wts, (1, 2), 2)
    np.testing.assert_array_equal(
        got.cpu().numpy(), local_tap_sum_plain(vals, wts, (1, 2)).cpu().numpy())
