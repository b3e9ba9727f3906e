"""Plain crops and the detector's letterbox: frozen copies of
``busca_tpu_torch/ops/crop.py`` (``integral_image`` through
``crop_resize_plain``, the plain version of kernel K1) and of
``busca_tpu_torch/eval/detector.py``'s ``letterbox`` and
``normalize_canvas`` at commit c2c24f5.  Torch operations only, on any
device; no kernel of the program.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

DEFAULT_OUT_HW = (384, 128)
IMAGENET_MEAN_RGB = (0.485, 0.456, 0.406)
IMAGENET_STD_RGB = (0.229, 0.224, 0.225)
INV_255 = float(np.float32(1.0) / np.float32(255.0))
PAD_VALUE = 114


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


def letterbox(frame: torch.Tensor, test_size: Tuple[int, int], fill: int,
              boxes: dict, out: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, float]:
    """uint8 BGR frame ``[H, W, 3]`` -> the uint8 BGR canvas ``[test_h,
    test_w, 3]`` (the frame resized by ``r = min(test_h / H, test_w / W)``
    through the crop op, INTER_LINEAR and rounded, at the top left; ``fill``
    elsewhere) and ``r``.  ``boxes`` caches the full-frame box per frame
    size and device; it is made with device ops, so no call copies from the
    host.  ``out``, a uint8 ``[test_h, test_w, 3]`` view filled with
    ``fill`` (one slice of a canvas batch), receives the resized frame
    instead of a new canvas."""
    fh, fw = int(frame.shape[0]), int(frame.shape[1])
    th, tw = test_size
    r = min(th / fh, tw / fw)
    rh, rw = int(fh * r), int(fw * r)
    key = (fh, fw, str(frame.device))
    if key not in boxes:
        box = torch.zeros((1, 4), dtype=torch.float32, device=frame.device)
        box[0, 2] = float(fw)
        box[0, 3] = float(fh)
        boxes[key] = box
    resized = crop_resize_plain(frame, boxes[key], (rh, rw),
                                quantize_uint8=True)[0]
    canvas = out if out is not None else torch.full(
        (th, tw, 3), fill, dtype=torch.uint8, device=frame.device)
    # the quantized crop holds integers in 0..255: the cast is exact
    canvas[:rh, :rw] = resized.to(torch.uint8)
    return canvas, r


def normalize_canvas(canvas: torch.Tensor, mean: torch.Tensor,
                     std: torch.Tensor, to_rgb: bool = True) -> torch.Tensor:
    """uint8 BGR canvas ``[..., 3]`` -> float32 ``(x / 255 - mean) / std``,
    in RGB order (``to_rgb``) or BGR, dividing by 255 as XLA does (times the
    float32 reciprocal).  The canvas holds integers, so this equals the
    reference's normalization of its float canvas."""
    x = canvas.to(torch.float32)
    if to_rgb:
        x = x.flip(-1)
    return (x * INV_255 - mean) / std


