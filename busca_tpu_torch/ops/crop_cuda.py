"""Wrapper of kernel K1 (``csrc/crop_resize.cu``): the crop-resize op on the
card.

K1 replaces the Pallas TPU kernel ``busca_tpu/ops/crop_pallas.py::
_crop_kernel`` and computes :func:`busca_tpu_torch.ops.crop.
crop_resize_normalize` for a CUDA frame.  The per-box integers and the pad
value come from the same torch code the plain version runs
(:func:`~busca_tpu_torch.ops.crop.box_params`, exact int64 integral image);
the kernel does the sampling, blending, rounding, normalization and channel
flip.

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
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_float] * 6
        + [ctypes.c_void_p]
    )


LIBRARY = CudaLibrary("crop_resize.cu", _declare)


def launch(frame: torch.Tensor, iparams: torch.Tensor, pad: torch.Tensor,
           out: torch.Tensor, *, quantize_uint8: bool, normalize: bool,
           bgr_input: bool, rgb_output: bool):
    """Launch K1 on precomputed box parameters into ``out``
    ``[N, OH, OW, 3]`` float32 (validated by :func:`crop_resize_cuda`)."""
    from busca_tpu_torch.ops.crop import normalization_constants

    mean, std = normalization_constants(bgr_input)
    n, oh, ow = out.shape[0], out.shape[1], out.shape[2]
    err = LIBRARY.load().crop_resize_launch(
        frame.data_ptr(), frame.shape[0], frame.shape[1],
        iparams.data_ptr(), pad.data_ptr(), n,
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
    from busca_tpu_torch.ops.crop import box_params

    if not frame.is_cuda:
        raise ValueError("crop_resize_cuda needs a CUDA frame")
    if frame.dtype != torch.uint8 or frame.dim() != 3 or frame.shape[2] != 3:
        raise ValueError(f"frame must be [H, W, 3] uint8, got "
                         f"{tuple(frame.shape)} {frame.dtype}")
    boxes = torch.as_tensor(boxes, dtype=torch.float32, device=frame.device)
    if boxes.dim() != 2 or boxes.shape[1] != 4:
        raise ValueError(f"boxes must be [N, 4], got {tuple(boxes.shape)}")
    if boxes.shape[0] > 65535:  # the grid's y dimension is one box each
        raise ValueError(f"at most 65535 boxes per call, got "
                         f"{boxes.shape[0]}")
    frame = frame.contiguous()
    oh, ow = int(out_hw[0]), int(out_hw[1])
    iparams, pad = box_params(frame, boxes, quantize_uint8)
    iparams, pad = iparams.contiguous(), pad.contiguous()
    out = torch.empty((boxes.shape[0], oh, ow, 3), dtype=torch.float32,
                      device=frame.device)
    if boxes.shape[0]:
        launch(frame, iparams, pad, out, quantize_uint8=quantize_uint8,
               normalize=normalize, bgr_input=bgr_input,
               rgb_output=rgb_output)
    return out


crop_resize_cuda.launches = 0
