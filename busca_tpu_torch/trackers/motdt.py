"""MOTDT, the reference MOT evaluator's ``evaluate_motdt`` alternate (port
of ``busca_tpu.trackers.motdt``).

The reference evaluator runs MOTDT beside BYTE
(adapters/ByteTrack/yolox/evaluators/mot_evaluator.py:19,503-625:
``OnlineTracker(model_folder, min_cls_score=args.track_thresh)``, a
per-video reset, the same vertical and min-area output filter).  The tracker
module lives in the ByteTrack submodule (empty in the checkout), so this is
the published algorithm (Chen et al., ICME 2018):

1. **candidate selection**: the frame's detections are pooled with the
   tracks' Kalman-predicted boxes and non-maximum-suppressed as one set, so
   a track whose detection was missed can live on its own prediction.  The
   paper rescores candidates with an R-FCN classifier that the reference
   does not ship; a prediction carries its track's score decayed per miss
   (``track_decay``), a detection its detector score;
2. **hierarchical association**: Mahalanobis-gated appearance matching
   (cosine distance between a candidate's ReID feature and the track's EMA
   feature, threshold ``min_ap_dist``), then IoU matching of the rest;
3. unmatched *detection* candidates at or above ``min_det_score`` start
   tracks; tracks are dropped after ``max_time_lost`` frames.

The Kalman filter is the batched 8-state host filter
(``core/hostmath.HostKalman``).  Features come through the CLI's
``FeatureShim``: the ReID extractor on K1 crops of the frame on the card, or
a placeholder per detection without one (``update(boxes, scores, features,
frame)``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from busca_tpu_torch.core import hostmath
from busca_tpu_torch.core.hostmath import CHI2INV95, HostKalman
from busca_tpu_torch.ops.lap import linear_assignment
from busca_tpu_torch.trackers.base import IdCounter


@dataclasses.dataclass
class MotdtConfig:
    min_cls_score: float = 0.4  # candidate pool admission
    min_det_score: float = 0.45  # new-track births need a real detection
    min_ap_dist: float = 0.64  # appearance cosine-distance threshold
    iou_thresh: float = 0.3  # second-stage IoU association
    nms_thresh: float = 0.3  # candidate-pool NMS
    max_time_lost: int = 30
    use_tracking: bool = True  # pool track predictions as candidates
    track_decay: float = 0.9  # per-miss score decay of prediction candidates
    ema_alpha: float = 0.9  # feature smoothing


class MotdtTrack:
    _count = IdCounter(1)
    _kf = HostKalman()

    def __init__(self, tlbr: np.ndarray, score: float, feature: np.ndarray):
        tlwh = hostmath.tlbr_to_tlwh(np.asarray(tlbr, np.float64)[None])[0]
        mean, cov = self._kf.initiate(hostmath.tlwh_to_xyah(tlwh)[None])
        self.mean, self.cov = mean[0], cov[0]
        self.score = float(score)
        self.smooth_feat = np.asarray(feature, np.float64)
        self.track_id = next(MotdtTrack._count)
        self.time_since_update = 0
        self.is_lost = False

    @property
    def tlwh(self) -> np.ndarray:
        return hostmath.xyah_to_tlwh(self.mean[:4])

    @property
    def tlbr(self) -> np.ndarray:
        return hostmath.tlwh_to_tlbr(self.tlwh[None])[0]

    def predict(self):
        mean, cov = self._kf.predict(self.mean[None], self.cov[None])
        self.mean, self.cov = mean[0], cov[0]
        self.time_since_update += 1

    def correct(self, tlbr: np.ndarray, score: float,
                feature: Optional[np.ndarray], alpha: float):
        tlwh = hostmath.tlbr_to_tlwh(np.asarray(tlbr, np.float64)[None])[0]
        mean, cov = self._kf.update(
            self.mean[None], self.cov[None],
            hostmath.tlwh_to_xyah(tlwh)[None],
        )
        self.mean, self.cov = mean[0], cov[0]
        self.score = float(score)
        self.time_since_update = 0
        self.is_lost = False
        if feature is not None:
            f = np.asarray(feature, np.float64)
            self.smooth_feat = alpha * self.smooth_feat + (1 - alpha) * f
            n = np.linalg.norm(self.smooth_feat)
            if n > 0:
                self.smooth_feat /= n


def _cosine_distance(track_feats: np.ndarray, cand_feats: np.ndarray):
    a = np.asarray(track_feats, np.float64)
    b = np.asarray(cand_feats, np.float64)
    a = a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-12)
    b = b / np.maximum(np.linalg.norm(b, axis=1, keepdims=True), 1e-12)
    return np.maximum(0.0, 1.0 - a @ b.T)


def _nms(boxes_tlbr: np.ndarray, scores: np.ndarray, thresh: float):
    """Host greedy NMS over the candidate pool.  The pairwise IoU is one
    ``iou_matrix_std`` call (the same float64 arithmetic per pair as
    busca_tpu's call per pair, so the same values)."""
    iou = hostmath.iou_matrix_std(boxes_tlbr, boxes_tlbr)
    keep = []
    for i in np.argsort(-scores):
        if not keep or not (iou[i, keep] > thresh).any():
            keep.append(i)
    return np.asarray(keep, int)


class MotdtTracker:
    """Frame-by-frame MOTDT (candidate pool + two-stage association)."""

    def __init__(self, cfg: Optional[MotdtConfig] = None, engine=None):
        self.cfg = cfg or MotdtConfig()
        self.tracks: List[MotdtTrack] = []
        self.frame_id = 0
        self._kf = HostKalman()

    def update(
        self,
        bboxes_tlbr: np.ndarray,
        scores: np.ndarray,
        features: Optional[np.ndarray] = None,
        frame: Optional[np.ndarray] = None,
    ) -> List[MotdtTrack]:
        cfg = self.cfg
        self.frame_id += 1
        boxes = np.asarray(bboxes_tlbr, np.float64).reshape(-1, 4)
        scores = np.asarray(scores, np.float64).reshape(-1)
        if features is None:
            features = np.zeros((len(boxes), 1))
        features = np.asarray(features, np.float64)
        if features.size == 0:
            features = features.reshape(
                len(boxes), features.shape[1] if features.ndim == 2 else 1
            )
        else:
            features = features.reshape(len(boxes), -1)

        for t in self.tracks:
            t.predict()

        # ---- candidate pool: detections + track predictions, NMS'd together
        keep_det = scores >= cfg.min_cls_score
        cand_boxes = [boxes[keep_det]]
        cand_scores = [scores[keep_det]]
        cand_feats = [features[keep_det]]
        cand_is_det = [np.ones(int(keep_det.sum()), bool)]
        if cfg.use_tracking and self.tracks:
            pred_boxes = np.stack([t.tlbr for t in self.tracks])
            pred_scores = np.asarray(
                [t.score * cfg.track_decay ** t.time_since_update
                 for t in self.tracks]
            )
            ok = pred_scores >= cfg.min_cls_score
            cand_boxes.append(pred_boxes[ok])
            cand_scores.append(pred_scores[ok])
            cand_feats.append(
                np.stack([t.smooth_feat for t in self.tracks])[ok]
                if features.shape[1] > 1
                else np.zeros((int(ok.sum()), features.shape[1]))
            )
            cand_is_det.append(np.zeros(int(ok.sum()), bool))
        cand_boxes = np.concatenate(cand_boxes, axis=0)
        cand_scores = np.concatenate(cand_scores, axis=0)
        cand_feats = np.concatenate(cand_feats, axis=0)
        cand_is_det = np.concatenate(cand_is_det, axis=0)
        if len(cand_boxes):
            keep = _nms(cand_boxes, cand_scores, cfg.nms_thresh)
            cand_boxes, cand_scores = cand_boxes[keep], cand_scores[keep]
            cand_feats, cand_is_det = cand_feats[keep], cand_is_det[keep]

        matched_tracks, matched_cands = set(), set()
        if len(self.tracks) and len(cand_boxes):
            # ---- stage 1: motion-gated appearance association
            tfeats = np.stack([t.smooth_feat for t in self.tracks])
            ap = _cosine_distance(tfeats, cand_feats)
            means = np.stack([t.mean for t in self.tracks])
            covs = np.stack([t.cov for t in self.tracks])
            xyah = hostmath.tlwh_to_xyah(
                hostmath.tlbr_to_tlwh(cand_boxes)
            )
            gate = self._kf.gating_distance(means, covs, xyah)
            ap = np.where(gate > CHI2INV95[4], 1e5, ap)
            matches, _, _ = linear_assignment(ap, cfg.min_ap_dist)
            for ti, ci in matches:
                self.tracks[ti].correct(
                    cand_boxes[ci], cand_scores[ci],
                    cand_feats[ci] if cand_feats.shape[1] > 1 else None,
                    cfg.ema_alpha,
                )
                matched_tracks.add(ti)
                matched_cands.add(ci)

            # ---- stage 2: IoU association for the remainder
            rt = [i for i in range(len(self.tracks))
                  if i not in matched_tracks]
            rc = [i for i in range(len(cand_boxes))
                  if i not in matched_cands]
            if rt and rc:
                iou = hostmath.iou_matrix_std(
                    np.stack([self.tracks[i].tlbr for i in rt]),
                    cand_boxes[rc],
                )
                matches, _, _ = linear_assignment(
                    1.0 - iou, 1.0 - cfg.iou_thresh
                )
                for a, b in matches:
                    ti, ci = rt[a], rc[b]
                    self.tracks[ti].correct(
                        cand_boxes[ci], cand_scores[ci],
                        cand_feats[ci] if cand_feats.shape[1] > 1 else None,
                        cfg.ema_alpha,
                    )
                    matched_tracks.add(ti)
                    matched_cands.add(ci)

        # ---- lifecycle
        for i, t in enumerate(self.tracks):
            if i not in matched_tracks:
                t.is_lost = True
        self.tracks = [
            t for t in self.tracks
            if t.time_since_update <= cfg.max_time_lost
        ]

        # ---- births: unmatched detection candidates with real-det scores
        for ci in range(len(cand_boxes)):
            if (
                ci not in matched_cands
                and cand_is_det[ci]
                and cand_scores[ci] >= cfg.min_det_score
            ):
                self.tracks.append(
                    MotdtTrack(cand_boxes[ci], cand_scores[ci],
                               cand_feats[ci])
                )

        return [t for t in self.tracks if not t.is_lost]
