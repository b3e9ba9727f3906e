"""StrongSORT cached-artifact evaluation path (port of
``busca_tpu.eval.strongsort_io``).

The reference runs StrongSORT off *precomputed* artifacts rather than a live
detector (adapters/StrongSORT/deep_sort_app.py):

- detections + ReID features in one ``.npy`` matrix whose first 10 columns
  are MOTChallenge detection format and the rest the feature vector
  (deep_sort_app.py:50-52, 97-127);
- camera-motion ECC warps from a JSON of per-video per-frame 3x3 matrices
  (opts.py:142-143), applied with an identity fallback when the matrix is
  degenerate (deep_sort/track.py:210-219);
- per-frame: confidence filter, deep_sort greedy NMS, ``tracker.predict()``,
  ``tracker.update(...)`` (deep_sort_app.py:170-206), frames loaded only for
  BUSCA crops.

Frames are decoded with cv2, imported where a frame is read.
:func:`run_cached_sequences_lockstep` runs several sequences frame by frame
in step, their BUSCA third rounds served by one grouped association.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np


def gather_sequence_info(
    sequence_dir: str, detection_file: Optional[str] = None
) -> dict:
    """Sequence metadata + the raw detection matrix
    (deep_sort_app.py:20-95)."""
    image_dir = os.path.join(sequence_dir, "img1")
    image_filenames = {}
    if os.path.isdir(image_dir):
        image_filenames = {
            int(os.path.splitext(f)[0]): os.path.join(image_dir, f)
            for f in os.listdir(image_dir)
        }
    detections = None
    if detection_file is not None:
        detections = np.load(detection_file)
    gt_file = os.path.join(sequence_dir, "gt", "gt.txt")
    groundtruth = (
        np.loadtxt(gt_file, delimiter=",") if os.path.exists(gt_file) else None
    )
    if image_filenames:
        min_frame_idx = min(image_filenames)
        max_frame_idx = max(image_filenames)
    else:
        min_frame_idx = int(detections[:, 0].min())
        max_frame_idx = int(detections[:, 0].max())
    feature_dim = detections.shape[1] - 10 if detections is not None else 0
    return {
        "sequence_name": os.path.basename(sequence_dir.rstrip("/")),
        "image_filenames": image_filenames,
        "detections": detections,
        "groundtruth": groundtruth,
        "min_frame_idx": min_frame_idx,
        "max_frame_idx": max_frame_idx,
        "feature_dim": feature_dim,
    }


def create_detections(
    detection_mat: np.ndarray, frame_idx: int, min_height: float = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rows of one frame -> (tlwh [N,4], confidence [N], features [N,F])
    (deep_sort_app.py:97-127: bbox = row[2:6], conf = row[6],
    feature = row[10:]; boxes below ``min_height`` dropped)."""
    mask = detection_mat[:, 0].astype(int) == frame_idx
    rows = detection_mat[mask]
    keep = rows[:, 5] >= min_height
    rows = rows[keep]
    return rows[:, 2:6].copy(), rows[:, 6].copy(), rows[:, 10:].copy()


def non_max_suppression(
    boxes_tlwh: np.ndarray, max_overlap: float, scores: np.ndarray
) -> list:
    """deep_sort's greedy NMS (application_util/preprocessing.py — the
    Malisiewicz variant: overlap is intersection over the *candidate* box
    area, not IoU).  ``max_overlap=1.0`` (the shipped StrongSORT setting)
    disables suppression."""
    if len(boxes_tlwh) == 0:
        return []
    boxes = boxes_tlwh.astype(float)
    x1, y1 = boxes[:, 0], boxes[:, 1]
    x2 = boxes[:, 0] + boxes[:, 2]
    y2 = boxes[:, 1] + boxes[:, 3]
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    idxs = np.argsort(scores)
    pick = []
    while len(idxs) > 0:
        last = len(idxs) - 1
        i = idxs[last]
        pick.append(int(i))
        xx1 = np.maximum(x1[i], x1[idxs[:last]])
        yy1 = np.maximum(y1[i], y1[idxs[:last]])
        xx2 = np.minimum(x2[i], x2[idxs[:last]])
        yy2 = np.minimum(y2[i], y2[idxs[:last]])
        w = np.maximum(0, xx2 - xx1 + 1)
        h = np.maximum(0, yy2 - yy1 + 1)
        overlap = (w * h) / area[idxs[:last]]
        idxs = np.delete(
            idxs, np.concatenate(([last], np.where(overlap > max_overlap)[0]))
        )
    return pick


def load_ecc_warps(json_path: str) -> Dict[str, Dict[str, list]]:
    """Per-video per-frame warp matrices (opts.py:142-143 layout:
    ``{video: {frame_str: 3x3 (or 2x3) matrix}}``)."""
    with open(json_path) as f:
        return json.load(f)


def ecc_matrix_for_frame(
    dict_frame_matrix: Dict[str, list], frame_idx: int
) -> Optional[np.ndarray]:
    """The warp for one frame with the degenerate-matrix guard
    (deep_sort/track.py:210-219): matrices farther than 100 from identity
    (Frobenius) are replaced by identity; missing frames return None."""
    key = str(int(frame_idx))
    if key not in dict_frame_matrix:
        return None
    matrix = np.asarray(dict_frame_matrix[key], dtype=np.float64)
    if matrix.shape[0] == 2:  # accept 2x3 ECC output
        matrix = np.vstack([matrix, [0.0, 0.0, 1.0]])
    eye = np.eye(3)
    if np.linalg.norm(eye - matrix) < 100:
        return matrix
    return eye


def run_cached_sequence(
    sequence_dir: str,
    detection_file: str,
    tracker,
    min_confidence: float = 0.6,
    nms_max_overlap: float = 1.0,
    min_detection_height: float = 0,
    ecc_warps: Optional[Dict[str, list]] = None,
    load_images: bool = True,
    output_file: Optional[str] = None,
    max_frames: Optional[int] = None,
    viz_dir: Optional[str] = None,
):
    """The full deep_sort_app frame loop against a StrongSortTracker
    (deep_sort_app.py:130-224): cached detections+features, NMS, optional
    ECC camera update, predict/update, confirmed-track output rows;
    ``viz_dir``: each read frame with its tracks written there as a JPEG
    (``eval/runner.py::write_viz_frame``).

    Returns the MOTChallenge-style result rows
    ``(frame, tlwhs, ids, scores)`` per frame (same shape the MOT writer and
    metrics consume).
    """
    import time

    from busca_tpu_torch.eval.runner import SequenceResult, write_viz_frame

    seq_info = gather_sequence_info(sequence_dir, detection_file)
    lo, hi = seq_info["min_frame_idx"], seq_info["max_frame_idx"]
    if max_frames:
        hi = min(hi, lo + max_frames - 1)
    results = []
    t0 = time.perf_counter()
    for frame_idx in range(lo, hi + 1):
        tlbr, conf, feats, frame = _frame_inputs(
            seq_info, frame_idx, min_confidence, nms_max_overlap,
            min_detection_height, load_images,
        )
        if ecc_warps is not None:
            m = ecc_matrix_for_frame(ecc_warps, frame_idx)
            if m is not None:
                tracker.camera_update(m)
        tracker.predict()
        online = tracker.update(tlbr, conf, feats, frame)

        tlwhs, ids, confs = [], [], []
        for t in online:
            tlwhs.append(t.tlwh)
            ids.append(t.track_id)
            confs.append(t.score)
        results.append((frame_idx, tlwhs, ids, confs))
        if viz_dir is not None and frame is not None:
            write_viz_frame(viz_dir, frame_idx, frame, tlwhs, ids)
    dt = time.perf_counter() - t0

    res = SequenceResult(
        seq_info["sequence_name"], len(results), results, dt
    )
    if output_file:
        from busca_tpu_torch.eval import mot

        mot.write_results(output_file, results)
    return res


def _frame_inputs(
    seq_info,
    frame_idx: int,
    min_confidence: float,
    nms_max_overlap: float,
    min_detection_height: float,
    load_images: bool,
):
    """One frame's (tlbr, conf, feats, frame_image) from cached artifacts:
    confidence filter, deep_sort NMS, the frame read for BUSCA crops
    (deep_sort_app.py:170-206)."""
    tlwh, conf, feats = create_detections(
        seq_info["detections"], frame_idx, min_detection_height
    )
    keep = conf >= min_confidence
    tlwh, conf, feats = tlwh[keep], conf[keep], feats[keep]
    pick = non_max_suppression(tlwh, nms_max_overlap, conf)
    tlwh, conf, feats = tlwh[pick], conf[pick], feats[pick]
    frame = None
    if load_images and frame_idx in seq_info["image_filenames"]:
        import cv2

        frame = cv2.imread(seq_info["image_filenames"][frame_idx])
    tlbr = tlwh.copy()
    tlbr[:, 2:] += tlbr[:, :2]
    return tlbr, conf, feats, frame


def run_cached_sequences_lockstep(
    specs,
    trackers,
    min_confidence: float = 0.6,
    nms_max_overlap: float = 1.0,
    min_detection_height: float = 0,
    load_images: bool = True,
    max_frames: Optional[int] = None,
    viz_dirs=None,
):
    """Several cached-artifact sequences frame by frame in step, every
    sequence's BUSCA third round served by one grouped association per frame
    (per-request BN groups keep each sequence's numbers equal to its own
    :func:`run_cached_sequence`).

    Args:
      specs: ``(sequence_dir, detection_file, ecc_warps_or_None)`` each.
      trackers: one StrongSortTracker per spec.
      viz_dirs: None, or one online-visualization directory (or None) per
        spec.
    Returns one SequenceResult per spec, each with its share of the wall
    time.
    """
    import time

    from busca_tpu_torch.eval.runner import SequenceResult, write_viz_frame
    from busca_tpu_torch.trackers.base import service_deferred_updates

    infos = [gather_sequence_info(d, f) for d, f, _ in specs]
    ranges = [(s["min_frame_idx"],
               min(s["max_frame_idx"], s["min_frame_idx"] + max_frames - 1)
               if max_frames else s["max_frame_idx"]) for s in infos]
    results = [[] for _ in specs]
    t0 = time.perf_counter()
    step = 0
    while True:
        frame_idxs = [lo + step for lo, _ in ranges]
        live = [i for i, (fi, (_, hi)) in enumerate(zip(frame_idxs, ranges))
                if fi <= hi]
        if not live:
            break
        onlines, pending, frames = {}, [], {}
        for i in live:
            tlbr, conf, feats, frame = _frame_inputs(
                infos[i], frame_idxs[i], min_confidence, nms_max_overlap,
                min_detection_height, load_images,
            )
            frames[i] = frame
            warps = specs[i][2]
            if warps is not None:
                m = ecc_matrix_for_frame(warps, frame_idxs[i])
                if m is not None:
                    trackers[i].camera_update(m)
            trackers[i].predict()
            gen = trackers[i].update_deferred(tlbr, conf, feats, frame)
            try:
                pending.append((i, gen, next(gen)))
            except StopIteration as e:
                onlines[i] = e.value
        if pending:
            onlines.update(service_deferred_updates(pending))
        for i in live:
            online = onlines[i]
            tlwhs = [t.tlwh for t in online]
            ids = [t.track_id for t in online]
            results[i].append((frame_idxs[i], tlwhs, ids,
                               [t.score for t in online]))
            if (viz_dirs is not None and viz_dirs[i] is not None
                    and frames[i] is not None):
                write_viz_frame(viz_dirs[i], frame_idxs[i], frames[i],
                                tlwhs, ids)
        step += 1
    dt = time.perf_counter() - t0
    total = max(sum(len(r) for r in results), 1)
    return [SequenceResult(os.path.basename(d.rstrip("/")), len(results[i]),
                           results[i], dt * len(results[i]) / total)
            for i, (d, _, _) in enumerate(specs)]
