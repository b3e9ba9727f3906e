"""Sequence runner (port of the single-sequence part of
``busca_tpu.eval.runner``): drive one tracker over a sequence, filter its
output like the reference MOT evaluator, and evaluate it."""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from busca_tpu_torch.eval import metrics as metrics_lib


@dataclasses.dataclass
class SequenceResult:
    name: str
    num_frames: int
    results: List[Tuple[int, list, list, list]]
    track_time_s: float
    # optional per-stage wall times (the reference's inference/track split,
    # mot_evaluator.py:671-682), e.g. {"detector_s": ..., "tracker_s": ...}
    stage_times: Optional[Dict[str, float]] = None

    @property
    def fps(self) -> float:
        return self.num_frames / self.track_time_s if self.track_time_s else 0.0


def filter_output_tracks(online, min_box_area=100.0, vertical_thresh=1.6):
    """The reference MOT evaluator's output filter (mot_evaluator.py:216-221):
    drop tiny boxes and "vertical" boxes (w/h > thresh; None skips it).
    Returns (tlwhs, ids, confs)."""
    tlwhs, ids, confs = [], [], []
    for t in online:
        tlwh = t.tlwh
        vertical = (
            vertical_thresh is not None
            and tlwh[3] > 0
            and tlwh[2] / tlwh[3] > vertical_thresh
        )
        if tlwh[2] * tlwh[3] > min_box_area and not vertical:
            tlwhs.append(tlwh)
            ids.append(t.track_id)
            confs.append(t.score)
    return tlwhs, ids, confs


def run_sequence(
    tracker,
    frames: Iterable[Optional[np.ndarray]],
    detections: Sequence[Tuple[np.ndarray, np.ndarray]],
    name: str = "seq",
    scale: float = 1.0,
    min_box_area: float = 100.0,
    vertical_thresh: Optional[float] = 1.6,
) -> SequenceResult:
    """Drive one tracker instance over a sequence.

    Args:
      tracker: object with ``update(bboxes_tlbr, scores, scale, frame)``.
      frames: per-frame images (uint8 BGR) or None (cached detections).
      detections: per-frame (tlbr [N, 4], scores [N]).
    """
    results = []
    t0 = time.perf_counter()
    for idx, (frame, (boxes, scores)) in enumerate(zip(frames, detections)):
        online = tracker.update(boxes, scores, scale, frame)
        tlwhs, ids, confs = filter_output_tracks(
            online, min_box_area, vertical_thresh
        )
        results.append((idx + 1, tlwhs, ids, confs))
    dt = time.perf_counter() - t0
    return SequenceResult(name, len(results), results, dt)


def results_to_pred(
    seq_result: SequenceResult,
) -> Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """SequenceResult -> the {frame: (tlwh, ids, scores)} metric input."""
    out = {}
    for frame_id, tlwhs, ids, confs in seq_result.results:
        if ids:
            out[frame_id] = (
                np.stack(tlwhs),
                np.asarray(ids, int),
                np.asarray(confs),
            )
    return out


def evaluate_sequence(
    seq_result: SequenceResult,
    gt: Dict[int, Tuple[np.ndarray, np.ndarray]],
) -> metrics_lib.MotMetrics:
    return metrics_lib.evaluate_clear(gt, results_to_pred(seq_result))
