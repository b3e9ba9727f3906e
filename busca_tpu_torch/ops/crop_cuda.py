"""Wrapper of kernel K1 (``csrc/crop_resize.cu``): the crop-resize op on the
card.

K1 replaces the Pallas TPU kernel ``busca_tpu/ops/crop_pallas.py::
_crop_kernel`` and computes :func:`busca_tpu_torch.ops.crop.
crop_resize_normalize` for a CUDA frame.  One call of the op is the kernel's
own two launches and nothing else: the kernel derives each box's integer
geometry from the float32 boxes, sums the clipped region exactly (integer
sums) only for the boxes whose cutout leaves the frame, and does the
sampling, blending, rounding, normalization and channel flip.  The wrapper
checks its inputs and allocates the output and a small scratch buffer.

The source is built and loaded by :mod:`busca_tpu_torch.ops.cuda_build`
at first use, so importing this module needs neither CUDA nor a compiler.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from busca_tpu_torch.ops.cuda_build import CudaLibrary


def _declare(lib):
    fn = lib.crop_resize_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_float] * 6
        + [ctypes.c_void_p]
    )
    lib.crop_resize_scratch_per_box.restype = ctypes.c_int
    lib.crop_resize_scratch_per_box.argtypes = []


LIBRARY = CudaLibrary("crop_resize.cu", _declare)


def buffers(n: int, out_hw: Tuple[int, int], device):
    """The output ``[n, OH, OW, 3]`` float32 and the scratch the kernel
    needs for ``n`` boxes (int64 words: the pad sums' partials)."""
    per_box = LIBRARY.load().crop_resize_scratch_per_box()
    out = torch.empty((n, int(out_hw[0]), int(out_hw[1]), 3),
                      dtype=torch.float32, device=device)
    scratch = torch.empty((n, per_box), dtype=torch.int64, device=device)
    return out, scratch


def launch(frame: torch.Tensor, boxes: torch.Tensor, scratch: torch.Tensor,
           out: torch.Tensor, *, quantize_uint8: bool, normalize: bool,
           bgr_input: bool, rgb_output: bool, library: CudaLibrary = None):
    """Launch K1 on ``frame`` ``[H, W, 3]`` uint8 and ``boxes`` ``[N, 4]``
    float32 into ``out`` ``[N, OH, OW, 3]`` float32, with ``scratch`` from
    :func:`buffers` (all contiguous on one card, as
    :func:`crop_resize_cuda` checks and makes them).  ``library``: a build
    of the source other than :data:`LIBRARY` (a variant with ``-D``
    defines, for measurement)."""
    from busca_tpu_torch.ops.crop import normalization_constants

    mean, std = normalization_constants(bgr_input)
    n, oh, ow = out.shape[0], out.shape[1], out.shape[2]
    err = (library or LIBRARY).load().crop_resize_launch(
        frame.data_ptr(), frame.shape[0], frame.shape[1],
        boxes.data_ptr(), n, scratch.data_ptr(),
        out.data_ptr(), oh, ow,
        int(quantize_uint8), int(normalize), int(rgb_output == bgr_input),
        *(float(v) for v in mean), *(float(v) for v in std),
        torch.cuda.current_stream(frame.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"crop_resize kernel launch failed: CUDA error "
                           f"{err}")
    crop_resize_cuda.launches += 1


def crop_resize_cuda(
    frame: torch.Tensor,
    boxes: torch.Tensor,
    out_hw: Tuple[int, int],
    normalize: bool = True,
    bgr_input: bool = True,
    rgb_output: bool = True,
    quantize_uint8: bool = True,
) -> torch.Tensor:
    """:func:`~busca_tpu_torch.ops.crop.crop_resize_normalize` on the card
    through K1.  ``frame``: CUDA ``[H, W, 3]`` uint8; ``boxes``: ``[N, 4]``
    ltrb.  Returns ``[N, OH, OW, 3]`` float32 on the frame's device."""
    from busca_tpu_torch.ops.crop import check_card_frame

    if not frame.is_cuda:
        raise ValueError("crop_resize_cuda needs a CUDA frame")
    check_card_frame(frame)
    boxes = torch.as_tensor(boxes, dtype=torch.float32, device=frame.device)
    if boxes.dim() != 2 or boxes.shape[1] != 4:
        raise ValueError(f"boxes must be [N, 4], got {tuple(boxes.shape)}")
    if boxes.shape[0] > 65535:  # the grid's y dimension is one box each
        raise ValueError(f"at most 65535 boxes per call, got "
                         f"{boxes.shape[0]}")
    frame, boxes = frame.contiguous(), boxes.contiguous()
    out, scratch = buffers(boxes.shape[0], out_hw, frame.device)
    if boxes.shape[0]:
        launch(frame, boxes, scratch, out, quantize_uint8=quantize_uint8,
               normalize=normalize, bgr_input=bgr_input,
               rgb_output=rgb_output)
    return out


crop_resize_cuda.launches = 0
