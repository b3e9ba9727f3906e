"""Static-size greedy NMS in plain torch (port of ``busca_tpu.ops.nms.nms``).

Replaces ``torchvision.ops.batched_nms`` in the reference detector
postprocess.  The output has a fixed size, like the JAX op's: indices into
the input and a ``valid`` mask.
"""

from __future__ import annotations

from typing import Tuple

import torch


def iou_matrix_std(atlbr: torch.Tensor, btlbr: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU with the standard (no +1) area convention
    (``torchvision.ops.box_iou``; ``busca_tpu.core.boxes.iou_matrix_std``)."""
    a = atlbr[:, None, :]
    b = btlbr[None, :, :]
    iw = torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0],
                                                             b[..., 0])
    ih = torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1],
                                                             b[..., 1])
    inter = iw.clamp(min=0.0) * ih.clamp(min=0.0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a + area_b - inter
    return torch.where(union > 0.0, inter / union, torch.zeros_like(union))


def nms(
    boxes_tlbr: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_outputs: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy IoU NMS with static output size.

    Args:
      boxes_tlbr: ``[N, 4]``; scores: ``[N]`` (use -inf to mask invalid rows).
    Returns:
      (indices ``[max_outputs]`` int32 into the input, -1 past the kept
      rows; valid ``[max_outputs]`` bool).
    """
    n = boxes_tlbr.shape[0]
    dev = boxes_tlbr.device
    # a stable sort, as jnp.argsort: equal scores keep their index order
    order = torch.sort(-scores, stable=True).indices
    sorted_boxes = boxes_tlbr[order]
    sorted_scores = scores[order]
    sorted_valid = torch.isfinite(sorted_scores) & (sorted_scores > -torch.inf)

    iou = iou_matrix_std(sorted_boxes, sorted_boxes)
    # The greedy keep set is the unique fixed point of
    #   keep_j = valid_j and not any_{i<j} (keep_i and iou_ij > thr);
    # iterating k <- F(k) from k = valid reaches it in at most
    # (longest suppression chain) steps.
    rank = torch.arange(n, device=dev)
    suppress = ((rank[:, None] < rank[None, :]) & (iou > iou_threshold)
                & sorted_valid[:, None])
    keep = sorted_valid
    while True:
        suppressed = (suppress & keep[:, None]).any(dim=0)
        keep_new = sorted_valid & ~suppressed
        if torch.equal(keep_new, keep):
            break
        keep = keep_new

    # kept rows (already in score order) to the front, then the first
    # max_outputs
    priority = torch.where(keep, 0, 1)
    perm = torch.sort(priority, stable=True).indices
    kept_sorted = order[perm].to(torch.int32)
    num_kept = int(keep.sum())
    if max_outputs <= n:
        out_idx = kept_sorted[:max_outputs]
    else:
        out_idx = torch.cat([kept_sorted, torch.zeros(
            max_outputs - n, dtype=torch.int32, device=dev)])
    valid = torch.arange(max_outputs, device=dev) < min(num_kept, max_outputs)
    out_idx = torch.where(valid, out_idx, torch.full_like(out_idx, -1))
    return out_idx, valid
