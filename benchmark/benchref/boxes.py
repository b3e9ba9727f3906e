"""Frozen copy of ``busca_tpu_torch/core/boxes.py`` at commit c2c24f5, part of the
benchmark's plain reference (it imports nothing of the program; edits
to the program do not reach it).

Bounding-box algebra and cost matrices as torch tensor ops on any device
(port of ``busca_tpu.core.boxes``; the trackers' float64 host versions are
:mod:`busca_tpu_torch.core.hostmath`).

Shape-polymorphic over ``[..., 4]`` boxes.  Behavioral contract of the
reference tracker stack:

- box formats: ``tlwh`` (top-left x/y, width, height), ``tlbr`` (min x,
  min y, max x, max y), ``xyah`` (center x/y, aspect = w/h, height), as the
  reference STrack uses them (adapters/ByteTrack/yolox/tracker/
  byte_tracker.py:140-189);
- :func:`iou_matrix` is ``cython_bbox.bbox_overlaps`` (the +1 "pixel area"
  convention, matching.py:53-70); :func:`iou_matrix_std` is
  ``torchvision.ops.box_iou`` (the detector postprocess's NMS);
- :func:`center_distance` is ``busca/tracking.py:23-60``;
- :func:`fuse_score` is ``matching.py:173-186``.
"""

from __future__ import annotations

import torch


def tlwh_to_tlbr(tlwh: torch.Tensor) -> torch.Tensor:
    xy = tlwh[..., :2]
    return torch.cat([xy, xy + tlwh[..., 2:]], dim=-1)


def tlbr_to_tlwh(tlbr: torch.Tensor) -> torch.Tensor:
    xy = tlbr[..., :2]
    return torch.cat([xy, tlbr[..., 2:] - xy], dim=-1)


def tlwh_to_xyah(tlwh: torch.Tensor) -> torch.Tensor:
    """(top-left, w, h) -> (center x, center y, w/h, h)."""
    xy = tlwh[..., :2] + tlwh[..., 2:] / 2.0
    a = tlwh[..., 2:3] / tlwh[..., 3:4]
    return torch.cat([xy, a, tlwh[..., 3:4]], dim=-1)


def xyah_to_tlwh(xyah: torch.Tensor) -> torch.Tensor:
    h = xyah[..., 3:4]
    w = xyah[..., 2:3] * h
    xy = xyah[..., :2] - torch.cat([w, h], dim=-1) / 2.0
    return torch.cat([xy, w, h], dim=-1)


def centers(tlbr: torch.Tensor) -> torch.Tensor:
    """Box centers from tlbr boxes."""
    return (tlbr[..., :2] + tlbr[..., 2:]) / 2.0


def _iou(atlbr: torch.Tensor, btlbr: torch.Tensor, plus: float
         ) -> torch.Tensor:
    a = atlbr[:, None, :]
    b = btlbr[None, :, :]
    iw = torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0],
                                                             b[..., 0])
    ih = torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1],
                                                             b[..., 1])
    if plus:
        iw, ih = iw + plus, ih + plus
    inter = iw.clamp(min=0.0) * ih.clamp(min=0.0)
    area_a = (a[..., 2] - a[..., 0] + plus) * (a[..., 3] - a[..., 1] + plus)
    area_b = (b[..., 2] - b[..., 0] + plus) * (b[..., 3] - b[..., 1] + plus)
    union = area_a + area_b - inter
    # padded lanes (zero boxes) stay finite
    return torch.where(union > 0.0, inter / union, torch.zeros_like(union))


def iou_matrix(atlbr: torch.Tensor, btlbr: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU ``[N, M]`` of tlbr boxes ``[N, 4]`` and ``[M, 4]``
    with the +1 pixel-area convention of ``cython_bbox.bbox_overlaps``
    (the tracker's matching layer)."""
    return _iou(atlbr, btlbr, 1.0)


def iou_matrix_std(atlbr: torch.Tensor, btlbr: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU with the standard (no +1) area convention
    (``torchvision.ops.box_iou``; the detector postprocess's NMS)."""
    return _iou(atlbr, btlbr, 0.0)


def iou_distance(atlbr: torch.Tensor, btlbr: torch.Tensor) -> torch.Tensor:
    """1 - IoU cost matrix (reference matching.py:73-91)."""
    return 1.0 - iou_matrix(atlbr, btlbr)


def center_distance(atlbr: torch.Tensor, btlbr: torch.Tensor,
                    weight_size: bool = False) -> torch.Tensor:
    """Euclidean center-to-center distance matrix, optionally weighted by
    ``max(sa/sb, sb/sa)`` with ``s = sqrt(w * h)``."""
    diff = centers(atlbr)[:, None, :] - centers(btlbr)[None, :, :]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1))
    if weight_size:
        a_sz = torch.sqrt((atlbr[:, 2] - atlbr[:, 0])
                          * (atlbr[:, 3] - atlbr[:, 1]))
        b_sz = torch.sqrt((btlbr[:, 2] - btlbr[:, 0])
                          * (btlbr[:, 3] - btlbr[:, 1]))
        ratio = a_sz[:, None] / b_sz[None, :]
        dist = dist * torch.maximum(ratio, 1.0 / ratio)
    return dist


def fuse_score(cost_matrix: torch.Tensor, det_scores: torch.Tensor
               ) -> torch.Tensor:
    """``1 - (1 - cost) * score``: detection confidences fused into an IoU
    cost matrix ``[N, M]`` (``det_scores`` ``[M]``)."""
    return 1.0 - (1.0 - cost_matrix) * det_scores[None, :]
