"""Kernel K2 (busca_tpu_torch/csrc/local_tap_sum.cu) against its plain torch
versions, on the card: through ``local_tap_sum`` (levels stacked at the
query size) and through ``local_tap_sum_levels`` (levels at their own
resolutions, interpolated in the kernel).  A CUDA kernel has no CPU or
interpret mode, so these tests skip without a CUDA device;
``python3 chip_smoke.py`` runs the same comparisons at the MOT17 shapes and
times them.

Tolerance: exact.  K2 is compiled with -fmad=false, interpolates with the
plain version's separable lerps (x, then y) and adds the 36 terms in its
order, so every element agrees bit for bit (the acceptance bar would allow
1e-5).  The same holds for its bfloat16 instantiation (bf16 values and
weights, lerps rounded to bf16 after each axis, a float32 accumulator, a
bf16 output), held against the plain version on the same bf16 inputs.
"""

import numpy as np
import pytest
import torch

from busca_tpu_torch.ops.lma import (
    local_tap_sum,
    local_tap_sum_levels,
    local_tap_sum_levels_plain,
    local_tap_sum_plain,
)

pytestmark = pytest.mark.cuda

SHAPES = {
    "mot17": (4, 160, 272, 256, 8, (1, 2, 4, 8)),
    "ragged": (3, 20, 24, 64, 4, (1, 2, 4)),
    "tiny_decoder": (4, 8, 12, 32, 4, (1, 2, 4, 8)),
}
# level sizes (the first is the query grid), C, heads
PYRAMIDS = {
    "mot17": ([(160, 272), (80, 136), (40, 68), (20, 34)], 256, 8),
    "tiny_decoder": ([(8, 12), (4, 6), (2, 3), (1, 1)], 32, 4),
    "ragged": ([(13, 17), (7, 9), (4, 5), (2, 3)], 32, 4),
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


def _pyramid(device, hws, c, heads, seed=1):
    g = torch.Generator().manual_seed(seed)
    h4, w4 = hws[0]
    levels = [torch.randn((h, w, c), generator=g).to(device) for h, w in hws]
    logits = torch.randn((h4, w4, heads, len(hws) * 9), generator=g)
    dils = tuple(max(h4 // h, 1) for h, _ in hws)
    return levels, logits.softmax(-1).to(device), dils


@pytest.mark.parametrize("name", sorted(PYRAMIDS))
def test_k2_levels_match_plain(cuda, name):
    from busca_tpu_torch.ops.lma_cuda import local_tap_sum_cuda

    hws, c, heads = PYRAMIDS[name]
    levels, wts, dils = _pyramid(cuda, hws, c, heads)
    before = local_tap_sum_cuda.launches
    got = local_tap_sum_levels(levels, wts, dils, heads)
    want = local_tap_sum_levels_plain(levels, wts, dils)
    torch.cuda.synchronize()
    assert local_tap_sum_cuda.launches == before + 1
    assert got.shape == (*hws[0], c) and got.is_cuda
    assert torch.equal(got, want)


@pytest.mark.parametrize("api", ["stacked", "levels"])
def test_k2_nonfinite_edges_match_plain(cuda, api):
    """An inf or NaN in a level's first row and column makes the output
    non-finite exactly where the plain version's is, and the finite values
    agree bit for bit: a tap outside the grid reads a value that an in-grid
    tap of the same pixel adds too, not the edge value next to it.  On the
    stacked path, with the edges of the levels of dilation 2, 4 and 8 set,
    the pixels of row 1 at odd columns have taps above and left of the grid
    beside those edges, while no tap inside the grid reads them."""
    if api == "stacked":
        levels, h4, w4, c, heads, dils = SHAPES["mot17"]
        vals, wts = _inputs(cuda, levels, h4, w4, c, heads)
        vals[1:, 0] = float("inf")
        vals[1:, :, 0] = float("nan")
        got = local_tap_sum(vals, wts, dils, heads)
        want = local_tap_sum_plain(vals, wts, dils)
    else:
        hws, c, heads = PYRAMIDS["mot17"]
        levels, wts, dils = _pyramid(cuda, hws, c, heads)
        for v in levels:
            v[0] = float("inf")
            v[:, 0] = float("nan")
        got = local_tap_sum_levels(levels, wts, dils, heads)
        want = local_tap_sum_levels_plain(levels, wts, dils)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(want).any())
    if api == "stacked":
        assert bool(torch.isfinite(want[1, 1::2]).all())
    finite = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), finite)
    assert torch.equal(got[finite], want[finite])


def test_k2_levels_validate_inputs(cuda):
    from busca_tpu_torch.ops.lma_cuda import local_tap_sum_levels_cuda

    levels, wts, dils = _pyramid(cuda, PYRAMIDS["ragged"][0], 32, 4)
    with pytest.raises(ValueError, match="h_l <= 13"):
        local_tap_sum_levels_cuda([levels[0], levels[0].repeat(2, 1, 1)]
                                  + levels[2:], wts, dils, 4)
    with pytest.raises(ValueError, match="levels must be"):
        local_tap_sum_levels_cuda([levels[0][..., :16]] + levels[1:], wts,
                                  dils, 4)
    with pytest.raises(ValueError, match="CUDA"):
        local_tap_sum_levels_cuda([levels[0].cpu()] + levels[1:], wts, dils,
                                  4)
    # a non-contiguous level is copied, not refused
    lvl1 = levels[1].transpose(0, 1).contiguous().transpose(0, 1)
    got = local_tap_sum_levels_cuda([levels[0], lvl1] + levels[2:], wts,
                                    dils, 4)
    assert torch.equal(got, local_tap_sum_levels_plain(levels, wts, dils))


def test_k2_validates_inputs(cuda):
    from busca_tpu_torch.ops.lma_cuda import local_tap_sum_cuda

    vals, wts = _inputs(cuda, 2, 8, 8, 16, 2)
    with pytest.raises(ValueError, match="float32"):
        local_tap_sum_cuda(vals.double(), wts, (1, 2), 2)
    with pytest.raises(ValueError, match="weights must be"):
        local_tap_sum_cuda(vals, wts[..., :9], (1, 2), 2)
    with pytest.raises(ValueError, match="dilation"):
        local_tap_sum_cuda(vals, wts, (1,), 2)
    with pytest.raises(ValueError, match="multiple of 8"):
        local_tap_sum_cuda(vals[..., :6], wts, (1, 2), 2)
    with pytest.raises(ValueError, match="multiple of 8"):
        local_tap_sum_cuda(vals[..., :8], wts, (1, 2), 2)
    with pytest.raises(ValueError, match="CUDA"):
        local_tap_sum_cuda(vals.cpu(), wts, (1, 2), 2)
    # a non-contiguous view is copied, not refused
    got = local_tap_sum_cuda(vals.transpose(1, 2).contiguous().transpose(1, 2),
                             wts, (1, 2), 2)
    np.testing.assert_array_equal(
        got.cpu().numpy(), local_tap_sum_plain(vals, wts, (1, 2)).cpu().numpy())


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_k2_bf16_matches_plain(cuda, shape):
    from busca_tpu_torch.ops.lma_cuda import local_tap_sum_cuda

    levels, h4, w4, c, heads, dils = SHAPES[shape]
    vals, wts = _inputs(cuda, levels, h4, w4, c, heads, seed=2)
    vals, wts = vals.bfloat16(), wts.bfloat16()
    before = local_tap_sum_cuda.launches
    got = local_tap_sum(vals, wts, dils, heads)
    want = local_tap_sum_plain(vals, wts, dils)
    torch.cuda.synchronize()
    assert local_tap_sum_cuda.launches == before + 1
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == (h4, w4, c) and got.is_cuda
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", sorted(PYRAMIDS))
def test_k2_bf16_levels_match_plain(cuda, name):
    from busca_tpu_torch.ops.lma_cuda import local_tap_sum_cuda

    hws, c, heads = PYRAMIDS[name]
    levels, wts, dils = _pyramid(cuda, hws, c, heads, seed=3)
    levels = [v.bfloat16() for v in levels]
    wts = wts.bfloat16()
    before = local_tap_sum_cuda.launches
    got = local_tap_sum_levels(levels, wts, dils, heads)
    want = local_tap_sum_levels_plain(levels, wts, dils)
    torch.cuda.synchronize()
    assert local_tap_sum_cuda.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (*hws[0], c)
    assert torch.equal(got, want)


def test_k2_refuses_a_dtype_mix(cuda):
    levels, wts, dils = _pyramid(cuda, PYRAMIDS["ragged"][0], 32, 4)
    with pytest.raises(ValueError, match="all-float32 or all-bfloat16"):
        local_tap_sum_levels(levels, wts.bfloat16(), dils, 4)
    with pytest.raises(ValueError, match="all-float32 or all-bfloat16"):
        local_tap_sum_levels([v.half() for v in levels], wts.half(), dils, 4)
