"""Fused crop-resize-normalize: the BUSCA image pipeline as one device op.

Port of ``busca_tpu.ops.crop`` (NHWC layout, the same signatures).  For each
ltrb box of one frame:

- the cutout is ``floor(x1), floor(y1), ceil(x2), ceil(y2)``, clipped to the
  frame; the area outside the frame is padded with the scalar mean of the
  clipped region (all pixels and channels), truncated under
  ``quantize_uint8`` (np.pad's cast into uint8); the plain version takes it
  in O(1) from an integral image;
- it is resized to ``out_hw`` with cv2.INTER_LINEAR's half-pixel convention
  and edge clamp; ``quantize_uint8`` rounds and clips to 0..255;
- boxes that are degenerate or wholly outside the frame give zero crops;
- optional GHOST normalization ``(x/255 - mean)/std`` (0.299 blue std) and
  the BGR -> RGB flip.

:func:`crop_resize_normalize` calls one registered operator,
``torch.ops.busca_tpu_torch.crop_resize`` (:func:`crop_resize_op`): on a
CUDA tensor it launches the hand-written kernel (``ops/crop_cuda.py``,
``csrc/crop_resize.cu``); on a CPU tensor it runs the plain version below,
which repeats the kernel's arithmetic op for op.  The kernel derives the
box geometry itself and sums a box's clipped region only when its cutout
leaves the frame: for a cutout inside the frame the pad value meets only
taps of weight exactly 0, so it cannot change the output
(``tests/test_torch_crop.py`` pins this on the plain version).

Region sums are exact: the plain version's integral image is an int64
prefix sum, the kernel's sums are integer, and only the mean is formed in
float32 (``total / (cnt * 3)``).  ``busca_tpu`` sums in float32, which is
exact only while every prefix sum stays below 2**24 (frames up to about
21,900 pixels of uint8), so the two differ on larger frames wherever the pad
mean is used.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

DEFAULT_OUT_HW = (384, 128)


def integral_image(frame: torch.Tensor) -> torch.Tensor:
    """Channel-summed 2-D inclusive prefix sum with a zero border.

    Args:
      frame: ``[H, W, 3]``.
    Returns:
      ``[H+1, W+1]``, ``ii[y, x] = sum(frame[:y, :x, :])``: int64 for
      integer frames (exact), float64 otherwise.
    """
    acc = torch.int64 if not frame.dtype.is_floating_point else torch.float64
    s = frame.to(acc).sum(-1).cumsum(0).cumsum(1)
    return torch.nn.functional.pad(s, (1, 0, 1, 0))


def box_params(frame: torch.Tensor, boxes: torch.Tensor,
               quantize_uint8: bool):
    """Per-box integer geometry and pad value (``_crop_one`` lines 69-87).

    Returns ``(iparams [N, 9] int32, pad_val [N] float32)`` with iparams
    columns ``x1, y1, wc, hc, cx1, cx2, cy1, cy2, valid``.  Kernel K1
    derives the same integers on the card (``csrc/crop_resize.cu``,
    ``box_geometry``).
    """
    h, w = frame.shape[0], frame.shape[1]
    boxes = boxes.to(torch.float32)
    x1 = torch.floor(boxes[:, 0]).to(torch.int64)
    y1 = torch.floor(boxes[:, 1]).to(torch.int64)
    x2 = torch.ceil(boxes[:, 2]).to(torch.int64)
    y2 = torch.ceil(boxes[:, 3]).to(torch.int64)
    hc, wc = y2 - y1, x2 - x1
    cy1, cy2 = y1.clamp(0, h), y2.clamp(0, h)
    cx1, cx2 = x1.clamp(0, w), x2.clamp(0, w)

    ii = integral_image(frame)
    cnt = (cy2 - cy1).clamp(min=0) * (cx2 - cx1).clamp(min=0)
    total = ii[cy2, cx2] - ii[cy1, cx2] - ii[cy2, cx1] + ii[cy1, cx1]
    mean = torch.where(
        cnt > 0,
        total.to(torch.float32) / (cnt.to(torch.float32) * 3.0),
        torch.zeros((), dtype=torch.float32, device=frame.device),
    )
    pad_val = torch.trunc(mean) if quantize_uint8 else mean
    valid = (hc > 0) & (wc > 0) & (cnt > 0)
    iparams = torch.stack(
        [x1, y1, wc, hc, cx1, cx2, cy1, cy2, valid.to(torch.int64)], dim=1
    ).to(torch.int32)
    return iparams, pad_val


def _axis_taps(lo, n_src, out_n: int):
    """INTER_LINEAR source taps along one axis for every box.

    ``lo`` / ``n_src``: ``[N]`` int cutout origin and length.  Returns
    ``(i0 [N, out_n] int64, frac [N, out_n] float32)`` in absolute frame
    coordinates, with the same float32 op order as ``_crop_one``.
    """
    nf = n_src.to(torch.float32)
    # n / out_n as XLA evaluates a division by a constant: times the float32
    # reciprocal (busca_tpu's crops round this way, and so does K1)
    scale = nf * float(np.float32(1.0) / np.float32(out_n))
    pos = torch.arange(out_n, dtype=torch.float32, device=lo.device) + 0.5
    src = pos[None, :] * scale[:, None] - 0.5
    hi = torch.clamp(nf - 1.0, min=0.0)
    src = torch.minimum(torch.clamp(src, min=0.0), hi[:, None])
    a = lo.to(torch.float32)[:, None] + src
    i0f = torch.floor(a)
    return i0f.to(torch.int64), a - i0f


def crop_resize_plain(
    frame: torch.Tensor,
    boxes: torch.Tensor,
    out_hw: Tuple[int, int] = DEFAULT_OUT_HW,
    quantize_uint8: bool = True,
) -> torch.Tensor:
    """Raw resized crops ``[N, out_h, out_w, 3]`` float32 in the frame's
    channel order — the plain version of kernel K1 (``_crop_one`` batched
    over boxes)."""
    h, w = frame.shape[0], frame.shape[1]
    out_h, out_w = out_hw
    iparams, pad_val = box_params(frame, boxes, quantize_uint8)
    ip = iparams.to(torch.int64)
    x1, y1, wc, hc = ip[:, 0], ip[:, 1], ip[:, 2], ip[:, 3]
    cx1, cx2, cy1, cy2, valid = (ip[:, 4], ip[:, 5], ip[:, 6], ip[:, 7],
                                 ip[:, 8])

    y0, fy = _axis_taps(y1, hc, out_h)  # [N, out_h]
    x0, fx = _axis_taps(x1, wc, out_w)  # [N, out_w]
    fy = fy[:, :, None, None]
    fx = fx[:, None, :, None]
    pad = pad_val[:, None, None, None]

    def sample(yy, xx):
        """frame value at integer (yy [N, oh], xx [N, ow]); pad outside."""
        inside = (
            ((yy >= cy1[:, None]) & (yy < cy2[:, None]))[:, :, None]
            & ((xx >= cx1[:, None]) & (xx < cx2[:, None]))[:, None, :]
        )
        ys = yy.clamp(0, h - 1)[:, :, None]
        xs = xx.clamp(0, w - 1)[:, None, :]
        vals = frame[ys, xs].to(torch.float32)  # [N, oh, ow, 3]
        return torch.where(inside[..., None], vals, pad)

    v00 = sample(y0, x0)
    v01 = sample(y0, x0 + 1)
    v10 = sample(y0 + 1, x0)
    v11 = sample(y0 + 1, x0 + 1)
    out = (
        v00 * (1 - fy) * (1 - fx)
        + v01 * (1 - fy) * fx
        + v10 * fy * (1 - fx)
        + v11 * fy * fx
    )
    if quantize_uint8:
        out = torch.clamp(torch.round(out), 0.0, 255.0)
    return torch.where(valid[:, None, None, None] > 0, out,
                       torch.zeros((), dtype=torch.float32,
                                   device=frame.device))


def normalization_constants(bgr_input: bool):
    """Per-input-channel ``(mean, std)`` float32 tuples of the GHOST
    normalization for a frame in BGR (or RGB) order."""
    from busca_tpu_torch.models.busca import (
        INPUT_PIXEL_MEAN_BGR,
        INPUT_PIXEL_STD_BGR,
    )

    mean, std = INPUT_PIXEL_MEAN_BGR, INPUT_PIXEL_STD_BGR
    if not bgr_input:
        mean, std = mean[::-1], std[::-1]
    return mean, std


def crop_resize_normalize_plain(
    frame: torch.Tensor,
    boxes: torch.Tensor,
    out_hw: Tuple[int, int] = DEFAULT_OUT_HW,
    normalize: bool = True,
    bgr_input: bool = True,
    rgb_output: bool = True,
    quantize_uint8: bool = True,
) -> torch.Tensor:
    """The plain version of :func:`crop_resize_normalize` on any device —
    what the CPU path runs and what K1 is held against on the card."""
    crops = crop_resize_plain(frame, boxes.to(frame.device), out_hw,
                              quantize_uint8)
    if normalize:
        mean, std = normalization_constants(bgr_input)
        mean = torch.tensor(mean.tolist(), dtype=torch.float32,
                            device=frame.device)
        std = torch.tensor(std.tolist(), dtype=torch.float32,
                           device=frame.device)
        # a device tensor, not a Python scalar: torch on CUDA divides by a
        # scalar as a multiplication by its reciprocal; K1 divides exactly
        full = torch.full((), 255.0, device=frame.device)
        crops = (crops / full - mean) / std
    if rgb_output == bgr_input:
        # output channel order differs from input order -> flip
        crops = crops.flip(-1)
    return crops


def check_card_frame(frame: torch.Tensor) -> None:
    """The op's contract for a frame on the card: ``[H, W, 3]`` uint8, what
    K1 reads.  Raises ``ValueError`` otherwise (a float frame is accepted on
    the CPU only, by the plain version)."""
    if frame.dtype != torch.uint8 or frame.dim() != 3 or frame.shape[2] != 3:
        raise ValueError(f"a frame on the card must be [H, W, 3] uint8, got "
                         f"{tuple(frame.shape)} {frame.dtype}")


def crop_resize_normalize(
    frame: torch.Tensor,
    boxes: torch.Tensor,
    out_hw: Tuple[int, int] = DEFAULT_OUT_HW,
    normalize: bool = True,
    bgr_input: bool = True,
    rgb_output: bool = True,
    quantize_uint8: bool = True,
) -> torch.Tensor:
    """Extract (normalized) ReID crops for a batch of boxes from one frame.

    Args:
      frame: ``[H, W, 3]`` frame, BGR unless ``bgr_input`` is False: uint8
        on the card (:func:`check_card_frame` raises otherwise); uint8 or
        float on the CPU.
      boxes: ``[N, 4]`` ltrb boxes in frame coordinates, each coordinate
        within +-2**30 (there the kernel's float -> int conversion agrees
        with the plain version's; tracker boxes lie within a few frame
        widths).
      out_hw: output crop size (H, W).
      normalize: apply the GHOST ``(x/255 - mean)/std`` normalization.
      rgb_output: flip channels to RGB (what the ReID net expects).
      quantize_uint8: reproduce the reference's uint8 memory round-trip.

    Returns:
      ``[N, out_h, out_w, 3]`` float32 crops on the frame's device.  A CUDA
      frame goes through kernel K1, a CPU frame through the plain version.
    """
    if frame.is_cuda:
        check_card_frame(frame)
    boxes = torch.as_tensor(boxes, dtype=torch.float32, device=frame.device)
    return torch.ops.busca_tpu_torch.crop_resize(
        frame, boxes, int(out_hw[0]), int(out_hw[1]), normalize, bgr_input,
        rgb_output, quantize_uint8)


# The op as one registered PyTorch operator, so that ``torch.export`` traces
# it as a node (``serve/export.py``) and an exported program launches the
# same kernel as the live path.  Registering runs no CUDA code and builds
# nothing: K1 is built at its first launch.
@torch.library.custom_op("busca_tpu_torch::crop_resize", mutates_args=(),
                         device_types="cpu")
def crop_resize_op(frame: torch.Tensor, boxes: torch.Tensor, out_h: int,
                   out_w: int, normalize: bool, bgr_input: bool,
                   rgb_output: bool, quantize_uint8: bool) -> torch.Tensor:
    """:func:`crop_resize_normalize` as a registered op: the plain version
    on the CPU, K1 on the card (``boxes``: float32 ``[N, 4]`` on the
    frame's device)."""
    return crop_resize_normalize_plain(
        frame, boxes, (out_h, out_w), normalize=normalize,
        bgr_input=bgr_input, rgb_output=rgb_output,
        quantize_uint8=quantize_uint8)


@crop_resize_op.register_kernel("cuda")
def _crop_resize_k1(frame, boxes, out_h, out_w, normalize, bgr_input,
                    rgb_output, quantize_uint8):
    from busca_tpu_torch.ops.crop_cuda import crop_resize_cuda

    return crop_resize_cuda(frame, boxes, (out_h, out_w),
                            normalize=normalize, bgr_input=bgr_input,
                            rgb_output=rgb_output,
                            quantize_uint8=quantize_uint8)


@crop_resize_op.register_fake
def _crop_resize_fake(frame, boxes, out_h, out_w, normalize, bgr_input,
                      rgb_output, quantize_uint8):
    return frame.new_empty((boxes.shape[0], out_h, out_w, 3),
                           dtype=torch.float32)
