"""Frozen copy of ``busca_tpu_torch/ops/nms.py`` at commit c2c24f5, part of the
benchmark's plain reference (it imports nothing of the program; edits
to the program do not reach it).

Static-size greedy NMS and the YOLOX detector postprocess in plain torch
(port of ``busca_tpu.ops.nms``).

Replaces ``torchvision.ops.batched_nms`` in the reference detector
postprocess (adapters/ByteTrack/yolox/utils/boxes.py).  The outputs have a
fixed size, like the JAX ops': indices into the input (or detection rows)
and a ``valid`` mask.

The greedy keep set is the unique fixed point of
``keep_j = valid_j and not any_{i<j} (keep_i and iou_ij > thr)`` (unique by
induction over score order); iterating ``k <- F(k)`` from ``k = valid``
reaches it in at most (longest suppression chain) steps.  :func:`nms`
iterates until the set stops changing, reading a flag on the host each
step.  :func:`nms_fixed_steps` runs a fixed number of steps and returns,
beside the result, a device flag that says whether it is the fixed point,
so that a caller can enqueue the whole postprocess without waiting on the
device and read the flag once the results are back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from benchref.boxes import iou_matrix_std

# fixed-point steps of the enqueue-only postprocess: enough for the
# suppression chains of a MOT frame (a frame that needs more is finished by
# the caller with :func:`nms`)
NMS_STEPS = 8


def _suppression(boxes_tlbr, scores, iou_threshold):
    """Score order (a stable sort, as ``jnp.argsort``: equal scores keep
    their index order), the valid mask in that order, and the
    ``suppress[i, j]`` matrix (i before j, overlapping, i valid)."""
    n = boxes_tlbr.shape[0]
    order = torch.sort(-scores, stable=True).indices
    sorted_boxes = boxes_tlbr[order]
    sorted_scores = scores[order]
    sorted_valid = torch.isfinite(sorted_scores) & (sorted_scores > -torch.inf)
    iou = iou_matrix_std(sorted_boxes, sorted_boxes)
    rank = torch.arange(n, device=boxes_tlbr.device)
    suppress = ((rank[:, None] < rank[None, :]) & (iou > iou_threshold)
                & sorted_valid[:, None])
    return order, sorted_valid, suppress


def _step(keep, sorted_valid, suppress):
    return sorted_valid & ~(suppress & keep[:, None]).any(dim=0)


def _select(order, keep, max_outputs):
    """Kept rows (already in score order) to the front, then the first
    ``max_outputs``; ``valid`` computed on the device."""
    n = order.shape[0]
    dev = order.device
    priority = torch.where(keep, 0, 1)
    perm = torch.sort(priority, stable=True).indices
    kept_sorted = order[perm].to(torch.int32)
    if max_outputs <= n:
        out_idx = kept_sorted[:max_outputs]
    else:
        out_idx = torch.cat([kept_sorted, torch.zeros(
            max_outputs - n, dtype=torch.int32, device=dev)])
    num_kept = keep.sum().clamp(max=max_outputs)
    valid = torch.arange(max_outputs, device=dev) < num_kept
    out_idx = torch.where(valid, out_idx, torch.full_like(out_idx, -1))
    return out_idx, valid


def nms(
    boxes_tlbr: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_outputs: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy IoU NMS with static output size, iterated to its fixed point
    (one host read per step).

    Args:
      boxes_tlbr: ``[N, 4]``; scores: ``[N]`` (use -inf to mask invalid rows).
    Returns:
      (indices ``[max_outputs]`` int32 into the input, -1 past the kept
      rows; valid ``[max_outputs]`` bool).
    """
    order, sorted_valid, suppress = _suppression(boxes_tlbr, scores,
                                                 iou_threshold)
    keep = sorted_valid
    while True:
        keep_new = _step(keep, sorted_valid, suppress)
        if torch.equal(keep_new, keep):
            break
        keep = keep_new
    return _select(order, keep, max_outputs)


def nms_fixed_steps(
    boxes_tlbr: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_outputs: int = 128,
    steps: int = NMS_STEPS,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`nms` with exactly ``steps`` fixed-point steps and no host
    read.  Returns ``(indices, valid, converged)``: ``converged`` is a
    0-dim bool device tensor, True when the result is the fixed point (then
    it equals :func:`nms`'s)."""
    order, sorted_valid, suppress = _suppression(boxes_tlbr, scores,
                                                 iou_threshold)
    keep = sorted_valid
    for _ in range(steps):
        keep = _step(keep, sorted_valid, suppress)
    converged = (_step(keep, sorted_valid, suppress) == keep).all()
    idx, valid = _select(order, keep, max_outputs)
    return idx, valid, converged


def yolox_postprocess(
    prediction: torch.Tensor,
    num_classes: int,
    conf_threshold: float = 0.7,
    nms_threshold: float = 0.45,
    max_outputs: int = 128,
    pre_nms_topk: int = 1024,
    nms_steps: Optional[int] = None,
):
    """YOLOX detector postprocess: confidence filter + class-aware NMS.

    The ``pre_nms_topk`` highest-scored rows are selected first, with ties
    lowest index first as ``lax.top_k`` (a stable descending sort; the order
    of ``torch.topk``'s ties is unspecified).

    Args:
      prediction: ``[N, 5 + num_classes]`` rows of
        (cx, cy, w, h, obj_conf, class scores...).
      nms_steps: None iterates the NMS to its fixed point (host reads);
        an int runs :func:`nms_fixed_steps` and adds its ``converged`` flag
        to the outputs.
    Returns:
      (detections ``[max_outputs, 7]`` = (x1, y1, x2, y2, obj_conf,
      class_conf, class), valid ``[max_outputs]``), padded with zeros;
      then ``converged`` when ``nms_steps`` is given.
    """
    cxcywh = prediction[:, :4]
    half = cxcywh[:, 2:4] / 2.0
    tlbr = torch.cat([cxcywh[:, :2] - half, cxcywh[:, :2] + half], 1)
    obj = prediction[:, 4]
    cls_scores = prediction[:, 5:5 + num_classes]
    cls_conf, cls_id = cls_scores.max(dim=1)  # first index on a tie

    keep = obj * cls_conf >= conf_threshold
    scores = torch.where(keep, obj * cls_conf,
                         torch.full_like(obj, -torch.inf))
    if pre_nms_topk and prediction.shape[0] > pre_nms_topk:
        srt = torch.sort(scores, descending=True, stable=True)
        scores = srt.values[:pre_nms_topk]
        top_idx = srt.indices[:pre_nms_topk]
        tlbr, obj = tlbr[top_idx], obj[top_idx]
        cls_conf, cls_id = cls_conf[top_idx], cls_id[top_idx]

    # class-aware NMS: offset boxes per class by max_coordinate + 1, as
    # torchvision's batched_nms, over the selected rows' finite values
    max_coord = torch.where(torch.isfinite(tlbr), tlbr,
                            torch.zeros_like(tlbr)).max()
    offset = cls_id.to(torch.float32)[:, None] * (max_coord + 1.0)
    if nms_steps is None:
        idx, valid = nms(tlbr + offset, scores, nms_threshold, max_outputs)
    else:
        idx, valid, converged = nms_fixed_steps(
            tlbr + offset, scores, nms_threshold, max_outputs, nms_steps)

    safe = idx.clamp(0, tlbr.shape[0] - 1).long()
    out = torch.cat([tlbr[safe], obj[safe, None], cls_conf[safe, None],
                     cls_id[safe, None].to(torch.float32)], 1)
    out = torch.where(valid[:, None], out, torch.zeros_like(out))
    if nms_steps is None:
        return out, valid
    return out, valid, converged
