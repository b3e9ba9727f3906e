"""Wrapper of kernel K2 (``csrc/local_tap_sum.cu``): the decoder's tap sum
on the card.

K2 replaces the Pallas TPU kernel ``busca_tpu/ops/lma_pallas.py::_kernel``
together with the bilinear upsampling of the level maps in front of it.  It
computes :func:`busca_tpu_torch.ops.lma.local_tap_sum_levels` (level maps at
their own resolutions) and :func:`busca_tpu_torch.ops.lma.local_tap_sum`
(levels stacked at the query size) for CUDA tensors: both launch the same
kernel, instantiated for float32 and for bfloat16 inputs (one C entry point
each).  The source is built and loaded by
:mod:`busca_tpu_torch.ops.cuda_build` at first use, so importing this
module needs neither CUDA nor a compiler.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from busca_tpu_torch.ops.cuda_build import CudaLibrary
from busca_tpu_torch.ops.lma import check_dtypes

MAX_LEVELS = 8  # kMaxLevels in the source


# the C entry point of each element type
ENTRY = {torch.float32: "local_tap_sum_launch",
         torch.bfloat16: "local_tap_sum_bf16_launch"}


def _declare(lib):
    for name in ENTRY.values():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]


LIBRARY = CudaLibrary("local_tap_sum.cu", _declare)


def launch(levels: Sequence[torch.Tensor], weights: torch.Tensor,
           dils: Sequence[int], heads: int, out: torch.Tensor):
    """Launch K2 into ``out`` ``[H4, W4, C]`` of the inputs' dtype (inputs
    validated by :func:`local_tap_sum_levels_cuda`)."""
    n = len(levels)
    ptrs = (ctypes.c_void_p * n)(*(v.data_ptr() for v in levels))
    hw = (ctypes.c_int * (2 * n))(*(int(s) for v in levels
                                    for s in v.shape[:2]))
    dil_arr = (ctypes.c_int * n)(*(int(d) for d in dils))
    h4, w4, c = out.shape
    entry = getattr(LIBRARY.load(), ENTRY[weights.dtype])
    err = entry(
        ctypes.addressof(ptrs), ctypes.addressof(hw),
        ctypes.addressof(dil_arr), n, weights.data_ptr(), h4, w4, c, heads,
        out.data_ptr(), torch.cuda.current_stream(weights.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"local_tap_sum kernel launch failed: CUDA error "
                           f"{err}")
    local_tap_sum_cuda.launches += 1


def local_tap_sum_levels_cuda(levels: Sequence[torch.Tensor],
                              weights: torch.Tensor, dils: Sequence[int],
                              heads: int) -> torch.Tensor:
    """:func:`~busca_tpu_torch.ops.lma.local_tap_sum_levels` on the card
    through K2.  ``levels``: L CUDA maps ``[h_l, w_l, C]`` with ``h_l <=
    H4`` and ``w_l <= W4``, and ``C / heads`` a multiple of 8; ``weights``:
    ``[H4, W4, heads, L * 9]``; all float32 or all bfloat16 (a mix raises).
    Returns ``[H4, W4, C]`` in that dtype."""
    levels = list(levels)
    check_dtypes(levels, weights)
    if not (weights.is_cuda and all(
            v.is_cuda and v.device == weights.device for v in levels)):
        raise ValueError("K2 needs the levels and the weights on one CUDA "
                         "device")
    if not 1 <= len(levels) <= MAX_LEVELS or len(dils) != len(levels):
        raise ValueError(f"need one dilation per level and 1..{MAX_LEVELS} "
                         f"levels, got {len(dils)} for {len(levels)}")
    if weights.dim() != 4:
        raise ValueError(f"weights must be [H4, W4, heads, L*9], got "
                         f"{tuple(weights.shape)}")
    h4, w4 = weights.shape[:2]
    c = levels[0].shape[-1]
    if tuple(weights.shape) != (h4, w4, heads, len(levels) * 9):
        raise ValueError(f"weights must be [{h4}, {w4}, {heads}, "
                         f"{len(levels) * 9}], got {tuple(weights.shape)}")
    for v in levels:
        if v.dim() != 3 or v.shape[2] != c or not (
                1 <= v.shape[0] <= h4 and 1 <= v.shape[1] <= w4):
            raise ValueError(f"levels must be [h_l, w_l, {c}] with h_l <= "
                             f"{h4} and w_l <= {w4}, got {tuple(v.shape)}")
    if min(dils) < 1 or max(dils) > max(h4, w4):
        raise ValueError(f"dilations must lie in 1..{max(h4, w4)}, got "
                         f"{tuple(dils)}")
    if c % heads or (c // heads) % 8:
        raise ValueError(f"C={c} must split into {heads} heads of a multiple "
                         "of 8 channels (a block's slice of 16-byte "
                         "groups lies in one head)")
    levels = [v.contiguous() for v in levels]
    weights = weights.contiguous()
    if any(v.data_ptr() % 16 for v in levels) or \
            weights.data_ptr() % weights.element_size():
        raise ValueError("K2 reads the levels in 16-byte groups: 16-byte "
                         "alignment")
    out = torch.empty((h4, w4, c), dtype=weights.dtype,
                      device=weights.device)
    if out.numel():
        launch(levels, weights, dils, heads, out)
    return out


def local_tap_sum_cuda(values: torch.Tensor, weights: torch.Tensor,
                       dils: Sequence[int], heads: int) -> torch.Tensor:
    """:func:`~busca_tpu_torch.ops.lma.local_tap_sum` on the card through
    K2: every level is already at the query size.  ``values``: CUDA
    ``[L, H4, W4, C]``; ``weights``: ``[H4, W4, heads, L * 9]``; both
    float32 or both bfloat16.  Returns ``[H4, W4, C]`` in that dtype."""
    if values.dim() != 4:
        raise ValueError(f"values must be [L, H4, W4, C], got "
                         f"{tuple(values.shape)}")
    if tuple(values.shape[1:3]) != tuple(weights.shape[:2]):
        raise ValueError(f"weights must be [{values.shape[1]}, "
                         f"{values.shape[2]}, {heads}, {values.shape[0] * 9}]"
                         f", got {tuple(weights.shape)}")
    return local_tap_sum_levels_cuda(values.contiguous().unbind(0), weights,
                                     dils, heads)


local_tap_sum_cuda.launches = 0
