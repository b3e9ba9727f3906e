"""Classic SORT, the reference MOT evaluator's ``evaluate_sort`` alternate
(port of ``busca_tpu.trackers.sort``).

The reference evaluator runs SORT beside BYTE
(adapters/ByteTrack/yolox/evaluators/mot_evaluator.py:17,258-379:
``Sort(self.args.track_thresh)``, a per-video reset, the same vertical and
min-area output filter).  The tracker itself lives in the ByteTrack
submodule (empty in the checkout), so this is the published SORT algorithm
(Bewley et al., ICIP 2016) with the ByteTrack repo's defaults:

- per-track constant-velocity Kalman filter over ``[cx, cy, s, r]`` (area
  ``s = w*h`` and aspect ``r = w/h``; ``r`` has no velocity) with the
  published noise and covariance scalings;
- IoU-optimal assignment (``lapjv`` on ``1 - IoU``, standard IoU without
  the +1), matches below ``iou_threshold`` rejected after the optimum;
- tracks reported while ``time_since_update < 1`` and ``hit_streak >=
  min_hits`` (or during the first ``min_hits`` frames);
- detections at or below ``det_thresh`` dropped before association; every
  unmatched detection starts a track; tracks die after ``max_age``
  consecutive misses.

The Kalman predict runs vectorised over every track on the host (7-state
linear algebra); SORT has no BUSCA hook and reads no pixels.

``update(bboxes_tlbr, scores, scale, frame) -> [tracks]`` with ``.tlwh``,
``.track_id`` and ``.score`` in original-image coordinates (the boxes are
divided by ``scale``, as the reference's ``Sort.update``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from busca_tpu_torch.core import hostmath
from busca_tpu_torch.ops.lap import lapjv
from busca_tpu_torch.trackers.base import IdCounter

# constant-velocity transition / observation models (7-state: x y s r + vx
# vy vs) and the published covariance scalings
_F = np.eye(7)
_F[0, 4] = _F[1, 5] = _F[2, 6] = 1.0
_H = np.zeros((4, 7))
_H[0, 0] = _H[1, 1] = _H[2, 2] = _H[3, 3] = 1.0
_R = np.diag([1.0, 1.0, 10.0, 10.0])
_P0 = np.diag([10.0, 10.0, 10.0, 10.0, 1e4, 1e4, 1e4])
_Q = np.diag([1.0, 1.0, 1.0, 1.0, 0.01, 0.01, 1e-4])


def _tlbr_to_z(tlbr: np.ndarray) -> np.ndarray:
    """[x1,y1,x2,y2] -> [cx, cy, s, r] (s = area, r = aspect)."""
    w = tlbr[..., 2] - tlbr[..., 0]
    h = tlbr[..., 3] - tlbr[..., 1]
    cx = tlbr[..., 0] + w / 2.0
    cy = tlbr[..., 1] + h / 2.0
    s = w * h
    r = np.where(h != 0, w / np.maximum(h, 1e-12), 0.0)
    return np.stack([cx, cy, s, r], axis=-1)


def _x_to_tlbr(x: np.ndarray) -> np.ndarray:
    """state [..., 7] -> [x1,y1,x2,y2]."""
    s = np.maximum(x[..., 2], 0.0)
    r = np.maximum(x[..., 3], 1e-12)
    w = np.sqrt(s * r)
    h = np.where(w > 0, s / np.maximum(w, 1e-12), 0.0)
    cx, cy = x[..., 0], x[..., 1]
    return np.stack(
        [cx - w / 2.0, cy - h / 2.0, cx + w / 2.0, cy + h / 2.0], axis=-1
    )


class SortTrack:
    """One SORT track: 7-state Kalman + age bookkeeping."""

    _count = IdCounter(1)

    def __init__(self, tlbr: np.ndarray, score: float):
        self.x = np.zeros(7)
        self.x[:4] = _tlbr_to_z(np.asarray(tlbr, np.float64))
        self.P = _P0.copy()
        self.score = float(score)
        self.track_id = next(SortTrack._count)
        self.time_since_update = 0
        self.hit_streak = 0
        self.age = 0

    # geometry (original-image coordinates are handled by the tracker)
    @property
    def tlbr(self) -> np.ndarray:
        return _x_to_tlbr(self.x)

    @property
    def tlwh(self) -> np.ndarray:
        b = self.tlbr
        return np.array([b[0], b[1], b[2] - b[0], b[3] - b[1]])

    def update(self, tlbr: np.ndarray, score: float):
        z = _tlbr_to_z(np.asarray(tlbr, np.float64))
        y = z - _H @ self.x
        S = _H @ self.P @ _H.T + _R
        K = self.P @ _H.T @ np.linalg.inv(S)
        self.x = self.x + K @ y
        self.P = (np.eye(7) - K @ _H) @ self.P
        self.score = float(score)
        self.time_since_update = 0
        self.hit_streak += 1


@dataclasses.dataclass
class SortConfig:
    det_thresh: float = 0.6  # new tracks need score > det_thresh
    max_age: int = 30
    min_hits: int = 3
    iou_threshold: float = 0.3


class SortTracker:
    """Frame-by-frame SORT over detector outputs."""

    def __init__(self, cfg: Optional[SortConfig] = None, engine=None):
        self.cfg = cfg or SortConfig()
        self.tracks: List[SortTrack] = []
        self.frame_count = 0

    def _predict_all(self):
        """Vectorized Kalman predict across every live track."""
        if not self.tracks:
            return
        X = np.stack([t.x for t in self.tracks])  # [N, 7]
        P = np.stack([t.P for t in self.tracks])  # [N, 7, 7]
        # the published guard: stop area shrinking below zero
        neg = X[:, 6] + X[:, 2] <= 0
        X[neg, 6] = 0.0
        X = X @ _F.T
        P = _F @ P @ _F.T + _Q
        for t, x, p in zip(self.tracks, X, P):
            t.x, t.P = x, p
            t.age += 1
            if t.time_since_update > 0:
                t.hit_streak = 0
            t.time_since_update += 1

    def update(
        self,
        bboxes_tlbr: np.ndarray,
        scores: np.ndarray,
        scale: float = 1.0,
        frame: Optional[np.ndarray] = None,
    ) -> List[SortTrack]:
        self.frame_count += 1
        cfg = self.cfg
        dets = np.asarray(bboxes_tlbr, np.float64).reshape(-1, 4) / scale
        scores = np.asarray(scores, np.float64).reshape(-1)
        # the ByteTrack-repo Sort filters detections BEFORE association
        # (update: scores > det_thresh) — low-score dets neither match nor
        # birth tracks
        keep = scores > cfg.det_thresh
        dets, scores = dets[keep], scores[keep]

        self._predict_all()
        trk_boxes = (
            np.stack([t.tlbr for t in self.tracks])
            if self.tracks
            else np.zeros((0, 4))
        )

        # IoU-optimal assignment, sub-threshold matches rejected (the
        # published SORT association; optimum first, filter after — NOT the
        # cost-limited JV the BYTE family uses)
        matched_det = np.full(len(dets), -1, dtype=int)
        if len(dets) and len(self.tracks):
            iou = hostmath.iou_matrix_std(dets, trk_boxes)
            _, x, _ = lapjv(1.0 - iou, extend_cost=True)
            for di, ti in enumerate(x):
                if ti >= 0 and iou[di, ti] >= cfg.iou_threshold:
                    matched_det[di] = ti

        matched_tracks = set()
        for di, ti in enumerate(matched_det):
            if ti >= 0:
                self.tracks[ti].update(dets[di], scores[di])
                matched_tracks.add(ti)

        # births: every unmatched (already det_thresh-filtered) detection
        for di in np.where(matched_det < 0)[0]:
            self.tracks.append(SortTrack(dets[di], scores[di]))

        # deaths + output
        out, alive = [], []
        for t in self.tracks:
            if t.time_since_update < 1 and (
                t.hit_streak >= cfg.min_hits
                or self.frame_count <= cfg.min_hits
            ):
                out.append(t)
            if t.time_since_update <= cfg.max_age:
                alive.append(t)
        self.tracks = alive
        return out
