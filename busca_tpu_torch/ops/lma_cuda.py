"""Wrapper of kernel K2 (``csrc/local_tap_sum.cu``): the decoder's tap sum
on the card.

K2 replaces the Pallas TPU kernel ``busca_tpu/ops/lma_pallas.py::_kernel``
and computes :func:`busca_tpu_torch.ops.lma.local_tap_sum` for CUDA
tensors.  The source is built and loaded by
:mod:`busca_tpu_torch.ops.cuda_build` at first use, so importing this
module needs neither CUDA nor a compiler.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from busca_tpu_torch.ops.cuda_build import CudaLibrary

MAX_LEVELS = 8  # kMaxLevels in the source


def _declare(lib):
    fn = lib.local_tap_sum_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]


LIBRARY = CudaLibrary("local_tap_sum.cu", _declare)


def launch(values: torch.Tensor, weights: torch.Tensor,
           dils: Sequence[int], heads: int, out: torch.Tensor):
    """Launch K2 into ``out`` ``[H4, W4, C]`` float32 (validated by
    :func:`local_tap_sum_cuda`)."""
    levels, h4, w4, c = values.shape
    dil_arr = (ctypes.c_int * levels)(*(int(d) for d in dils))
    err = LIBRARY.load().local_tap_sum_launch(
        values.data_ptr(), weights.data_ptr(), ctypes.addressof(dil_arr),
        levels, h4, w4, c, heads, out.data_ptr(),
        torch.cuda.current_stream(values.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"local_tap_sum kernel launch failed: CUDA error "
                           f"{err}")
    local_tap_sum_cuda.launches += 1


def local_tap_sum_cuda(values: torch.Tensor, weights: torch.Tensor,
                       dils: Sequence[int], heads: int) -> torch.Tensor:
    """:func:`~busca_tpu_torch.ops.lma.local_tap_sum` on the card through
    K2.  ``values``: CUDA ``[L, H4, W4, C]`` float32; ``weights``:
    ``[H4, W4, heads, L * 9]`` float32.  Returns ``[H4, W4, C]`` float32."""
    if not (values.is_cuda and weights.is_cuda
            and values.device == weights.device):
        raise ValueError("local_tap_sum_cuda needs values and weights on one "
                         "CUDA device")
    if values.dtype != torch.float32 or weights.dtype != torch.float32:
        raise ValueError(f"K2 takes float32, got {values.dtype} and "
                         f"{weights.dtype}")
    if values.dim() != 4:
        raise ValueError(f"values must be [L, H4, W4, C], got "
                         f"{tuple(values.shape)}")
    levels, h4, w4, c = values.shape
    if tuple(weights.shape) != (h4, w4, heads, levels * 9):
        raise ValueError(f"weights must be [{h4}, {w4}, {heads}, "
                         f"{levels * 9}], got {tuple(weights.shape)}")
    if len(dils) != levels or not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"need one dilation per level and 1..{MAX_LEVELS} "
                         f"levels, got {len(dils)} for {levels}")
    if min(dils) < 1 or max(dils) > max(h4, w4):
        raise ValueError(f"dilations must lie in 1..{max(h4, w4)}, got "
                         f"{tuple(dils)}")
    if c % heads or (c // heads) % 4:
        raise ValueError(f"C={c} must split into {heads} heads of a multiple "
                         "of 4 channels (one float4 never straddles heads)")
    values, weights = values.contiguous(), weights.contiguous()
    if values.data_ptr() % 16 or weights.data_ptr() % 4:
        raise ValueError("K2 reads values as float4: 16-byte alignment")
    out = torch.empty((h4, w4, c), dtype=torch.float32, device=values.device)
    if out.numel():
        launch(values, weights, dils, heads, out)
    return out


local_tap_sum_cuda.launches = 0
