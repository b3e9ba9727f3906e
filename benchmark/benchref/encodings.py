"""Frozen copy of ``busca_tpu_torch/models/encodings.py`` at commit c2c24f5, part of the
benchmark's plain reference (it imports nothing of the program; edits
to the program do not reach it).

3-D spatiotemporal positional encodings, evaluated closed-form (port of
``busca_tpu.models.encodings``).

The reference precomputes a ``pe[211, 211, 61, 512]`` fp16 table and looks
tokens up in a Python loop (busca/encodings.py:28-94); the table is a fixed
sinusoid evaluated on a grid, so it is computed per token instead.  Bucketing
is bit-compatible with the reference: MEGA-style log-space geometry against
the reference box (the last memory box), ``trunc(clamp(v * 15, ±105)) +
105``, temporal ids clamped to ±30, SEP/NON tokens on the reference box, BAD
on the float32-min sentinel, and the fp16 round-trip of the table.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MAX_TEMP_DIST = 30
MAX_DISTANCE_DIST = 105
MAX_SIZE_DIST = 105
SPATIAL_RANGE_FACTOR = 15.0
TEMPORAL_RANGE_FACTOR = 2.0

FLOAT32_MIN = float(np.finfo(np.float32).min)

SUPPORTED_FLAVOURS = (
    "MEM-SEP-CAN",
    "MEM-SEP-CAN-BAD",
    "MEM-CAN-SEP",
    "MEM-CAN-SEP-BAD",
    # CLS- flavours: CLS takes the reference box and temporal id 0 (the
    # evident intent of the reference's crashing CLS path)
    "CLS-MEM-SEP-CAN",
    "CLS-MEM-SEP-CAN-BAD",
    "CLS-MEM-CAN-SEP",
    "CLS-MEM-CAN-SEP-BAD",
)


def missing_candidate_bbox(flavour: str = "ltrb") -> np.ndarray:
    """Sentinel bbox marking a missing candidate slot (busca/tracking.py:
    7-20): float32-min values that land in the most distant buckets."""
    if flavour == "ltrb":
        return np.array(
            [FLOAT32_MIN, FLOAT32_MIN, FLOAT32_MIN / 100.0, FLOAT32_MIN / 100.0]
        )
    if flavour == "ltwh":
        return np.array(
            [FLOAT32_MIN, FLOAT32_MIN, -FLOAT32_MIN / 100.0,
             -FLOAT32_MIN / 100.0]
        )
    raise ValueError(f"Unknown flavour: {flavour}")


def _group_channels(d_model: int) -> int:
    """Per-axis channel count of PositionalEncoding3D: ceil(d/6)*2, even."""
    ch = int(math.ceil(d_model / 6) * 2)
    if ch % 2:
        ch += 1
    return ch


def _axis_embedding(pos: torch.Tensor, ch: int) -> torch.Tensor:
    """Interleaved [sin(p f0), cos(p f0), sin(p f1), ...] for one axis."""
    k = torch.arange(0, ch, 2, dtype=torch.float32, device=pos.device)
    inv_freq = 1.0 / (10000.0 ** (k / ch))
    ang = pos[..., None].to(torch.float32) * inv_freq  # [..., ch/2]
    emb = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)
    return emb.reshape(*ang.shape[:-1], ch)


def sinusoid_3d(xy_idx: torch.Tensor, size_idx: torch.Tensor,
                t_idx: torch.Tensor, d_model: int,
                quantize_fp16: bool = True) -> torch.Tensor:
    """The 3-D positional sinusoid at integer bucket indices: channel layout
    [x-group | y-group | z-group (truncated)], each interleaved sin/cos.
    Returns ``[..., d_model]`` float32."""
    ch = _group_channels(d_model)
    out = torch.cat(
        [_axis_embedding(xy_idx, ch), _axis_embedding(size_idx, ch),
         _axis_embedding(t_idx, ch)],
        dim=-1,
    )[..., :d_model]
    if quantize_fp16:
        out = out.to(torch.float16).to(torch.float32)
    return out


def extract_distance_values(bbox: torch.Tensor, ref_bbox: torch.Tensor):
    """MEGA-style log-space relative geometry (busca/encodings.py:238-271),
    ``+1`` width/height convention, ``1e-3`` log offsets.  Returns
    ``(xy_distance, size_distance)`` each ``[...]``."""
    rxmin, rymin, rxmax, rymax = ref_bbox.unbind(-1)
    w_ref = rxmax - rxmin + 1.0
    h_ref = rymax - rymin + 1.0
    cx_ref = 0.5 * (rxmin + rxmax)
    cy_ref = 0.5 * (rymin + rymax)

    xmin, ymin, xmax, ymax = bbox.unbind(-1)
    w = xmax - xmin + 1.0
    h = ymax - ymin + 1.0
    cx = 0.5 * (xmin + xmax)
    cy = 0.5 * (ymin + ymax)

    dx = ((cx - cx_ref) / w) ** 2
    dy = ((cy - cy_ref) / h) ** 2
    xy = torch.log(torch.sqrt(dx + dy) + 1e-3)
    size = torch.log(w / w_ref + 1e-3) + torch.log(h / h_ref + 1e-3)
    return xy, size


def _bucketize(value: torch.Tensor, max_dist: int) -> torch.Tensor:
    """``trunc(clamp(v * 15, ±max)) + max`` (torch ``.to(long)``
    truncates)."""
    v = torch.clamp(value * SPATIAL_RANGE_FACTOR, -max_dist, max_dist)
    return torch.trunc(v).to(torch.int32) + max_dist


def spatial_indices(bboxes: torch.Tensor, ref_bbox: torch.Tensor):
    """Spatial bucket indices ``(xy_idx, size_idx)`` int32 ``[B, L]`` of
    ``bboxes [B, L, 4]`` against ``ref_bbox [B, 1, 4]``."""
    xy, size = extract_distance_values(bboxes, ref_bbox)
    return (_bucketize(xy, MAX_DISTANCE_DIST),
            _bucketize(size, MAX_SIZE_DIST))


def temporal_indices(mem_len: int, num_candidates: int,
                     elems_per_can: int = 2):
    """Static temporal bucket indices (busca/encodings.py:150-180): memory
    ``(-L+1..0) * 2``, candidates tile ``(1, 2) * 2`` per (SEP, CAN) pair,
    clamped to ±30 then shifted by +30.  Returns numpy int32
    ``(mem [mem_len], can [num_candidates * elems_per_can])``."""
    mem = np.arange(-mem_len + 1, 1, dtype=np.float64)
    can = np.tile(np.arange(1, 1 + elems_per_can, dtype=np.float64),
                  num_candidates)
    mem = np.clip(mem * TEMPORAL_RANGE_FACTOR, -MAX_TEMP_DIST, MAX_TEMP_DIST)
    can = np.clip(can * TEMPORAL_RANGE_FACTOR, -MAX_TEMP_DIST, MAX_TEMP_DIST)
    mem = np.trunc(mem).astype(np.int32) + MAX_TEMP_DIST
    can = np.trunc(can).astype(np.int32) + MAX_TEMP_DIST
    return mem, can


def insert_fake_bboxes(can_bboxes: torch.Tensor, ref_bbox: torch.Tensor,
                       flavour: str,
                       encode_sep_as_ref: bool = True) -> torch.Tensor:
    """Assign bboxes to SEP/NON/BAD tokens (busca/encodings.py:97-148).
    Returns ``[B, 2*(C + extras), 4]`` token-aligned boxes."""
    if flavour not in SUPPORTED_FLAVOURS:
        raise NotImplementedError(f"input flavour {flavour!r} not supported")
    b, c, _ = can_bboxes.shape
    # the reference uses the ltwh-flavoured sentinel verbatim as an ltrb box
    # for the BAD token (busca/encodings.py:21); the weights saw these buckets
    fake = torch.tensor(
        missing_candidate_bbox("ltwh"), dtype=can_bboxes.dtype,
        device=can_bboxes.device,
    ).expand(b, 1, 4)
    ref = ref_bbox.expand(b, 1, 4)

    groups = []
    for i in range(c):
        can_i = can_bboxes[:, i:i + 1, :]
        pad = ref if encode_sep_as_ref else can_i
        if "MEM-SEP-CAN" in flavour:
            groups.extend([pad, can_i])
        else:  # MEM-CAN-SEP
            groups.extend([can_i, pad])
    groups.extend([ref, ref])  # NON group
    if "BAD" in flavour:
        groups.extend([fake, fake])  # BAD group
    return torch.cat(groups, dim=1)


def positional_encodings(mem_bboxes: torch.Tensor, can_bboxes: torch.Tensor,
                         d_model: int, flavour: str,
                         encode_sep_as_ref: bool = True,
                         quantize_fp16: bool = True):
    """Per-token positional encodings (the reference
    ``PositionalEncoding.forward`` minus dropout).  Returns
    ``(mem_pe [B, L_mem, d], can_pe [B, 2*(C+extras), d])`` float32."""
    ref_bbox = mem_bboxes[:, -1:, :]
    can_token_bboxes = insert_fake_bboxes(can_bboxes, ref_bbox, flavour,
                                          encode_sep_as_ref)
    num_candidates = can_bboxes.shape[1] + (2 if "BAD" in flavour else 1)
    mem_t, can_t = temporal_indices(mem_bboxes.shape[1], num_candidates)
    b = mem_bboxes.shape[0]
    dev = mem_bboxes.device
    mem_t = torch.from_numpy(mem_t).to(dev).expand(b, -1)
    can_t = torch.from_numpy(can_t).to(dev).expand(b, -1)

    mem_xy, mem_size = spatial_indices(mem_bboxes, ref_bbox)
    can_xy, can_size = spatial_indices(can_token_bboxes, ref_bbox)

    mem_pe = sinusoid_3d(mem_xy, mem_size, mem_t, d_model, quantize_fp16)
    can_pe = sinusoid_3d(can_xy, can_size, can_t, d_model, quantize_fp16)
    if flavour.startswith("CLS-"):
        mem_pe = torch.cat([mem_pe[:, -1:, :], mem_pe], dim=1)
    return mem_pe, can_pe
