"""Detection AP evaluation (the reference's COCOeval role, from scratch;
port of ``busca_tpu.eval.detection``, host numpy).

The reference computes detection AP through the compiled ``COCOeval_opt``
extension (mot_evaluator.py:659-711).  This module implements the COCO-style
101-point interpolated AP natively (numpy; evaluation is offline):

- per-image greedy matching of score-sorted detections to ground truth at an
  IoU threshold (each gt matched at most once — the COCO protocol);
- precision-recall curve over the full dataset, monotone-decreasing
  interpolation, 101 recall points;
- AP@[.5:.95] as the mean over the 10 standard thresholds.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

IOU_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)


def _iou_tlbr(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    iw = np.maximum(
        np.minimum(a[:, None, 2], b[None, :, 2])
        - np.maximum(a[:, None, 0], b[None, :, 0]),
        0,
    )
    ih = np.maximum(
        np.minimum(a[:, None, 3], b[None, :, 3])
        - np.maximum(a[:, None, 1], b[None, :, 1]),
        0,
    )
    inter = iw * ih
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, 0)


def average_precision(
    detections: Dict[int, Tuple[np.ndarray, np.ndarray]],
    ground_truth: Dict[int, np.ndarray],
    iou_threshold: float = 0.5,
) -> float:
    """COCO-style AP at one IoU threshold.

    Args:
      detections: {image_id: (tlbr [N, 4], scores [N])}.
      ground_truth: {image_id: tlbr [M, 4]}.
    """
    # flatten detections with image ids, sort globally by score
    rows = []
    for img, (boxes, scores) in detections.items():
        for b, s in zip(boxes, scores):
            rows.append((float(s), img, b))
    rows.sort(key=lambda r: -r[0])
    total_gt = sum(len(g) for g in ground_truth.values())
    if total_gt == 0:
        return 0.0 if rows else 1.0

    matched: Dict[int, set] = {img: set() for img in ground_truth}
    tp = np.zeros(len(rows))
    fp = np.zeros(len(rows))
    for i, (_s, img, box) in enumerate(rows):
        gt = ground_truth.get(img, np.zeros((0, 4)))
        if len(gt) == 0:
            fp[i] = 1
            continue
        ious = _iou_tlbr(box[None], gt)[0]
        order = np.argsort(-ious)
        hit = -1
        for j in order:
            if ious[j] < iou_threshold:
                break
            if j not in matched[img]:
                hit = j
                break
        if hit >= 0:
            matched[img].add(hit)
            tp[i] = 1
        else:
            fp[i] = 1

    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(fp)
    recall = cum_tp / total_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-9)
    # monotone-decreasing precision envelope
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    # 101-point interpolation
    ap = 0.0
    for r in RECALL_POINTS:
        idx = np.searchsorted(recall, r, side="left")
        ap += precision[idx] if idx < len(precision) else 0.0
    return ap / len(RECALL_POINTS)


def coco_map(
    detections: Dict[int, Tuple[np.ndarray, np.ndarray]],
    ground_truth: Dict[int, np.ndarray],
) -> Dict[str, float]:
    """AP@[.5:.95], AP@.5, AP@.75 over the dataset."""
    aps = [
        average_precision(detections, ground_truth, t) for t in IOU_THRESHOLDS
    ]
    return {
        "ap": float(np.mean(aps)),
        "ap50": float(aps[0]),
        "ap75": float(aps[5]),
    }


# ---------------------------------------------------------------------------
# Full COCO summarize() table: area ranges + maxDets sweep
# ---------------------------------------------------------------------------

# COCO protocol constants (pycocotools cocoeval.Params; the reference prints
# this table through COCOeval_opt, mot_evaluator.py:659-711)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _evaluate_img(
    dt_boxes: np.ndarray,
    dt_scores: np.ndarray,
    gt_boxes: np.ndarray,
    area_rng: Tuple[float, float],
    max_det: int,
):
    """Per-image COCO matching over all 10 IoU thresholds (cocoeval.py
    evaluateImg).  Returns (dt_scores, dt_matched [T, D], dt_ignore [T, D],
    n_gt_considered)."""
    a0, a1 = area_rng
    order = np.argsort(-dt_scores, kind="stable")[:max_det]
    dt_boxes = dt_boxes[order]
    dt_scores = dt_scores[order]

    gt_area = (gt_boxes[:, 2] - gt_boxes[:, 0]) * (
        gt_boxes[:, 3] - gt_boxes[:, 1]
    )
    gt_ig = (gt_area < a0) | (gt_area > a1)
    # gts sorted ignore-last (cocoeval.py: gtind argsort on _ignore)
    gt_order = np.argsort(gt_ig, kind="stable")
    gt_boxes = gt_boxes[gt_order]
    gt_ig = gt_ig[gt_order]

    n_t = len(IOU_THRESHOLDS)
    n_d = len(dt_boxes)
    n_g = len(gt_boxes)
    dtm = np.zeros((n_t, n_d), dtype=bool)
    dt_ig = np.zeros((n_t, n_d), dtype=bool)
    ious = _iou_tlbr(dt_boxes, gt_boxes) if n_d and n_g else None
    for ti, thr in enumerate(IOU_THRESHOLDS):
        gtm = np.full(n_g, -1)
        for di in range(n_d):
            best_iou = min(thr, 1.0 - 1e-10)
            m = -1
            for gi in range(n_g):
                if gtm[gi] >= 0:
                    continue
                # matched to a real gt already and the remaining gts are all
                # ignored (sorted ignore-last) -> stop
                if m > -1 and not gt_ig[m] and gt_ig[gi]:
                    break
                if ious[di, gi] < best_iou:
                    continue
                best_iou = ious[di, gi]
                m = gi
            if m >= 0:
                gtm[m] = di
                dtm[ti, di] = True
                dt_ig[ti, di] = gt_ig[m]
        # unmatched dts outside the area range are ignored
        dt_area = (dt_boxes[:, 2] - dt_boxes[:, 0]) * (
            dt_boxes[:, 3] - dt_boxes[:, 1]
        )
        out = (dt_area < a0) | (dt_area > a1)
        dt_ig[ti] |= (~dtm[ti]) & out
    n_gt_considered = int((~gt_ig).sum())
    return dt_scores, dtm, dt_ig, n_gt_considered


def _accumulate(per_img: List[tuple]):
    """(AP per threshold [10], AR per threshold [10]) from _evaluate_img
    results of all images — or None if no considered gt (stat -1)."""
    npig = sum(r[3] for r in per_img)
    if npig == 0:
        return None
    scores = np.concatenate([r[0] for r in per_img])
    dtm = np.concatenate([r[1] for r in per_img], axis=1)
    dt_ig = np.concatenate([r[2] for r in per_img], axis=1)
    order = np.argsort(-scores, kind="stable")
    dtm = dtm[:, order]
    dt_ig = dt_ig[:, order]
    aps = np.zeros(len(IOU_THRESHOLDS))
    ars = np.zeros(len(IOU_THRESHOLDS))
    for ti in range(len(IOU_THRESHOLDS)):
        keep = ~dt_ig[ti]
        tp = np.cumsum(dtm[ti][keep].astype(np.float64))
        fp = np.cumsum((~dtm[ti][keep]).astype(np.float64))
        if len(tp) == 0:
            continue
        rc = tp / npig
        pr = tp / np.maximum(tp + fp, np.spacing(1))
        ars[ti] = rc[-1]
        for i in range(len(pr) - 2, -1, -1):
            pr[i] = max(pr[i], pr[i + 1])
        idx = np.searchsorted(rc, RECALL_POINTS, side="left")
        q = np.where(idx < len(pr), pr[np.minimum(idx, len(pr) - 1)], 0.0)
        aps[ti] = q.mean()
    return aps, ars


def coco_eval_full(
    detections: Dict[int, Tuple[np.ndarray, np.ndarray]],
    ground_truth: Dict[int, np.ndarray],
) -> Dict[str, float]:
    """The 12-number COCO summarize() table (mot_evaluator.py:659-711).

    Args:
      detections: {image_id: (tlbr [N, 4], scores [N])}.
      ground_truth: {image_id: tlbr [M, 4]}.
    Returns keys: ap, ap50, ap75, ap_small, ap_medium, ap_large,
      ar1, ar10, ar100, ar_small, ar_medium, ar_large — each -1.0 when the
      area range contains no ground truth (the pycocotools convention).
    """
    imgs = sorted(set(detections) | set(ground_truth))
    empty_b = np.zeros((0, 4))
    empty_s = np.zeros((0,))

    # only the combos summarize() actually prints (the per-image matcher is
    # a pure-Python loop, so skipping the 6 unused (area, maxDet) pairs
    # halves the wall time)
    combos = [("all", 1), ("all", 10), ("all", 100),
              ("small", 100), ("medium", 100), ("large", 100)]
    cache: Dict[Tuple[str, int], list] = {
        (area_name, max_det): [
            _evaluate_img(
                *(detections.get(i, (empty_b, empty_s))),
                ground_truth.get(i, empty_b),
                AREA_RANGES[area_name],
                max_det,
            )
            for i in imgs
        ]
        for area_name, max_det in combos
    }
    acc_cache: Dict[Tuple[str, int], object] = {}

    def acc_of(area, max_det):
        key = (area, max_det)
        if key not in acc_cache:
            acc_cache[key] = _accumulate(cache[key])
        return acc_cache[key]

    def ap_of(area, max_det, thr_idx=None):
        acc = acc_of(area, max_det)
        if acc is None:
            return -1.0
        aps, _ = acc
        return float(aps.mean() if thr_idx is None else aps[thr_idx])

    def ar_of(area, max_det):
        acc = acc_of(area, max_det)
        if acc is None:
            return -1.0
        return float(acc[1].mean())

    return {
        "ap": ap_of("all", 100),
        "ap50": ap_of("all", 100, 0),
        "ap75": ap_of("all", 100, 5),
        "ap_small": ap_of("small", 100),
        "ap_medium": ap_of("medium", 100),
        "ap_large": ap_of("large", 100),
        "ar1": ar_of("all", 1),
        "ar10": ar_of("all", 10),
        "ar100": ar_of("all", 100),
        "ar_small": ar_of("small", 100),
        "ar_medium": ar_of("medium", 100),
        "ar_large": ar_of("large", 100),
    }


def format_coco_table(stats: Dict[str, float]) -> str:
    """The COCOeval.summarize() text block (cocoeval.py _summarize)."""
    tmpl = (
        " {:<18} {} @[ IoU={:<9} | area={:>6s} | maxDets={:>3d} ] = {:0.3f}"
    )
    rows = [
        ("Average Precision", "(AP)", "0.50:0.95", "all", 100, "ap"),
        ("Average Precision", "(AP)", "0.50", "all", 100, "ap50"),
        ("Average Precision", "(AP)", "0.75", "all", 100, "ap75"),
        ("Average Precision", "(AP)", "0.50:0.95", "small", 100, "ap_small"),
        ("Average Precision", "(AP)", "0.50:0.95", "medium", 100, "ap_medium"),
        ("Average Precision", "(AP)", "0.50:0.95", "large", 100, "ap_large"),
        ("Average Recall", "(AR)", "0.50:0.95", "all", 1, "ar1"),
        ("Average Recall", "(AR)", "0.50:0.95", "all", 10, "ar10"),
        ("Average Recall", "(AR)", "0.50:0.95", "all", 100, "ar100"),
        ("Average Recall", "(AR)", "0.50:0.95", "small", 100, "ar_small"),
        ("Average Recall", "(AR)", "0.50:0.95", "medium", 100, "ar_medium"),
        ("Average Recall", "(AR)", "0.50:0.95", "large", 100, "ar_large"),
    ]
    return "\n".join(
        tmpl.format(t, m, i, a, d, stats[k]) for t, m, i, a, d, k in rows
    )
