"""DCNv2 modulated deformable convolution and its two gather-free variants
(port of ``busca_tpu.ops.deform``).

CenterTrack's DLA decoder replaces every projection and node convolution
with DCNv2 (the published CUDA extension).  busca_tpu computes it outside
any Pallas kernel, as bilinear gathers and a contraction, so the port is
plain torch on the CPU and on the card alike: an explicit floor, a clamp
and four corner gathers (``index_select`` over the pixels of a
channels-last map, one contiguous row of channels per corner), then one
matrix product over (tap, channel).  ``F.grid_sample`` is not used: its
normalised coordinates round differently near integer positions, which is
where ``floor`` flips.

Layouts are torch's (``torchvision.ops.deform_conv2d``'s): ``x [B, C, H,
W]``, ``offset [B, 2*kh*kw, Ho, Wo]`` interleaved (dy, dx) per tap (the DCN
layout), ``mask [B, kh*kw, Ho, Wo]`` (DCNv2's modulation, already
sigmoided), ``weight [O, C, kh, kw]``; zero padding outside the map.

The dtypes follow busca_tpu's promotions: the sampling positions are
float32, a bf16 map's corner values promote to float32 in the bilinear
weights, and the product with the float32 weight is float32.

``multi_scale_deformable_attention`` (TransCenter's MSDA mode, the
deformable-DETR op) uses the same sampler over each level's per-head maps
and accumulates the weighted samples level by level in float32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def _out_size(n: int, k: int, stride: int, padding: int) -> int:
    return (n + 2 * padding - k) // stride + 1


def _sample_rows(flat: torch.Tensor, h: int, w: int, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of ``B`` channels-last maps ``flat [B, H*W, C]`` at
    float positions ``x, y [B, N]`` -> ``[B, N, C]``, zero outside."""
    b, hw, c = flat.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    rows = flat.reshape(b * hw, c)
    base = (torch.arange(b, device=flat.device) * hw)[:, None]

    def tap(yy, xx):
        inside = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w))[..., None]
        idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1) + base
        v = rows.index_select(0, idx.reshape(-1)).reshape(*idx.shape, c)
        return torch.where(inside, v, torch.zeros((), dtype=v.dtype,
                                                  device=v.device))

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    return (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
            + v10 * fy * (1 - fx) + v11 * fy * fx)


def bilinear_sample(img: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Sample a channels-last map ``img [H, W, C]`` at float pixel
    positions ``x, y`` (one shape ``[...]``) with zero padding -> ``[...,
    C]`` (``busca_tpu.ops.deform.bilinear_sample``)."""
    h, w, c = img.shape
    shape = x.shape
    out = _sample_rows(img.reshape(1, h * w, c), h, w, x.reshape(1, -1),
                       y.reshape(1, -1))
    return out.reshape(*shape, c)


def multi_scale_deformable_attention(
        value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
        sampling_locations: torch.Tensor,
        attention_weights: torch.Tensor) -> torch.Tensor:
    """MSDA forward (the MultiScaleDeformableAttention CUDA op of
    deformable-DETR; busca_tpu's ``multi_scale_deformable_attention``).

    Args:
      value: ``[B, Len_v, H, D]``, the levels concatenated along ``Len_v``
        in ``spatial_shapes`` order.
      spatial_shapes: the levels' ``(h, w)``.
      sampling_locations: ``[B, Len_q, H, L, P, 2]`` (x, y), in [0, 1] on
        each level; ``grid_sample``'s ``align_corners=False`` rule (``src =
        loc * size - 0.5``) and zero padding outside.
      attention_weights: ``[B, Len_q, H, L, P]`` (softmaxed over L*P).
    Returns:
      ``[B, Len_q, H * D]`` float32: each level's samples (a bf16 value's
      corners widened by the float32 bilinear factors) weighted and summed
      into a float32 accumulator one level at a time, so that the peak is
      one level's samples.
    """
    b, _, n_heads, d = value.shape
    lq = sampling_locations.shape[1]
    p = sampling_locations.shape[4]
    acc = torch.zeros((b, n_heads, lq, d), dtype=torch.float32,
                      device=value.device)
    weights = attention_weights.permute(0, 2, 1, 3, 4).to(torch.float32)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        # one channels-last map per (batch, head): [B*H, h*w, D]
        maps = value[:, start:start + h * w].permute(0, 2, 1, 3).reshape(
            b * n_heads, h * w, d)
        start += h * w
        loc = sampling_locations[:, :, :, lvl].permute(0, 2, 1, 3, 4)
        x = (loc[..., 0] * w - 0.5).reshape(b * n_heads, lq * p)
        y = (loc[..., 1] * h - 0.5).reshape(b * n_heads, lq * p)
        sampled = _sample_rows(maps, h, w, x, y).reshape(b, n_heads, lq, p, d)
        acc = acc + torch.einsum("bhqpd,bhqp->bhqd", sampled,
                                 weights[:, :, :, lvl])
    return acc.permute(0, 2, 1, 3).reshape(b, lq, n_heads * d)


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor,
                  weight: torch.Tensor, mask: torch.Tensor = None,
                  bias: torch.Tensor = None, stride: int = 1,
                  padding: int = 1) -> torch.Tensor:
    """DCNv2: every output pixel's ``kh*kw`` taps sampled bilinearly at the
    tap grid plus its offset, scaled by the mask, contracted with
    ``weight`` -> ``[B, O, Ho, Wo]`` (float32 for float32 weights)."""
    b, c, h, w = x.shape
    o, _, kh, kw = weight.shape
    ho = _out_size(h, kh, stride, padding)
    wo = _out_size(w, kw, stride, padding)
    k = kh * kw
    dev = x.device
    # the tap grid per output pixel: [Ho, Wo, kh, kw]
    base_y = torch.arange(ho, device=dev) * stride - padding
    base_x = torch.arange(wo, device=dev) * stride - padding
    taps = torch.arange(kh, device=dev), torch.arange(kw, device=dev)
    gy = (base_y[:, None, None, None] + taps[0][None, None, :, None]).expand(
        ho, wo, kh, kw).to(torch.float32)
    gx = (base_x[None, :, None, None] + taps[1][None, None, None, :]).expand(
        ho, wo, kh, kw).to(torch.float32)
    off = offset.reshape(b, k, 2, ho, wo).permute(0, 3, 4, 1, 2)
    sy = gy + off[..., 0].reshape(b, ho, wo, kh, kw)
    sx = gx + off[..., 1].reshape(b, ho, wo, kh, kw)
    flat = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
    v = _sample_rows(flat, h, w, sx.reshape(b, -1), sy.reshape(b, -1))
    v = v.reshape(b, ho * wo, k, c)  # taps in (ky, kx) order
    if mask is not None:
        v = v * mask.reshape(b, k, ho * wo).permute(0, 2, 1)[..., None]
    wmat = weight.permute(2, 3, 1, 0).reshape(k * c, o)  # rows (ky, kx, c)
    out = torch.matmul(v.reshape(b, ho * wo, k * c), wmat.to(v.dtype))
    out = out.permute(0, 2, 1).reshape(b, o, ho, wo)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


def _tap_product(tap: torch.Tensor, w_tap: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """``einsum("bchw,oc->bohw", tap, w_tap, preferred_element_type=
    dtype)``: the product of the promoted operands, rounded to ``dtype``."""
    dt = torch.promote_types(tap.dtype, w_tap.dtype)
    return torch.einsum("bchw,oc->bohw", tap.to(dt), w_tap.to(dt)).to(dtype)


def local_modulated_conv2d(x: torch.Tensor, weight: torch.Tensor,
                           mask: torch.Tensor = None,
                           bias: torch.Tensor = None, stride: int = 1,
                           padding: int = 1) -> torch.Tensor:
    """DCNv2 with the offsets pinned to the tap grid
    (``deform_conv2d(x, offset=0, ...)``), the per-tap modulation kept:
    ``kh*kw`` shifted products accumulated in ``x``'s dtype, as busca_tpu's
    ``local_modulated_conv2d``."""
    b, c, h, w = x.shape
    o, _, kh, kw = weight.shape
    ho = _out_size(h, kh, stride, padding)
    wo = _out_size(w, kw, stride, padding)
    xp = F.pad(x, (padding, padding, padding, padding))
    out = torch.zeros((b, o, ho, wo), dtype=x.dtype, device=x.device)
    for ki in range(kh):
        for kj in range(kw):
            tap = xp[:, :, ki:ki + (ho - 1) * stride + 1:stride,
                     kj:kj + (wo - 1) * stride + 1:stride]
            if mask is not None:
                tap = tap * mask[:, ki * kw + kj, None]
            out = out + _tap_product(tap, weight[:, :, ki, kj], x.dtype)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


def deform_conv2d_windowed(x: torch.Tensor, offset: torch.Tensor,
                           weight: torch.Tensor, mask: torch.Tensor = None,
                           bias: torch.Tensor = None, stride: int = 1,
                           padding: int = 1, window: int = 3) -> torch.Tensor:
    """DCNv2 as dense shifted sums, ``deform_conv2d(x, clip(offset,
    +-window), ...)`` exactly in real arithmetic: the bilinear sample at
    ``q + o`` is ``sum_d hat(o_y - d_y) * hat(o_x - d_x) * x[q + d]`` over
    the integer shifts ``d in [-window, window + 1]`` (``hat(t) = max(0, 1
    - |t|)``), summed along x then y per tap, in busca_tpu's order and
    dtypes (``deform_conv2d_windowed``).  Stride 1 only."""
    if stride != 1:
        raise NotImplementedError("windowed DCN supports stride 1")
    b, c, h, w = x.shape
    o, _, kh, kw = weight.shape
    ho = h + 2 * padding - kh + 1
    wo = w + 2 * padding - kw + 1
    p = padding + window + 1
    xp = F.pad(x, (p, p, p, p))
    off = offset.clamp(-float(window), float(window))
    shifts = range(-window, window + 2)
    out = torch.zeros((b, o, ho, wo), dtype=x.dtype, device=x.device)
    for ki in range(kh):
        for kj in range(kw):
            t = ki * kw + kj
            oy = off[:, 2 * t, None]
            ox = off[:, 2 * t + 1, None]
            wxs = [(1.0 - (ox - d).abs()).clamp_min(0.0).to(x.dtype)
                   for d in shifts]
            acc = torch.zeros((b, c, ho, wo), dtype=x.dtype, device=x.device)
            for dy in shifts:
                wy = (1.0 - (oy - dy).abs()).clamp_min(0.0)
                row = torch.zeros_like(acc)
                y0 = p + ki - padding + dy
                for wx, dx in zip(wxs, shifts):
                    x0 = p + kj - padding + dx
                    row = row + wx * xp[:, :, y0:y0 + ho, x0:x0 + wo]
                acc = acc + wy.to(x.dtype) * row
            if mask is not None:
                acc = acc * mask[:, t, None]
            out = out + _tap_product(acc, weight[:, :, ki, kj], x.dtype)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out
