"""Frozen copy of ``busca_tpu_torch/trackers/byte.py`` at commit c2c24f5, part of the
benchmark's plain reference (it imports nothing of the program; edits
to the program do not reach it).  Changes: the frame taken as given (no
pixels, no upload), and cut to what the configurations run: no
camera-motion compensation, no detection-coverage gate
(``reliable_thresh``), no memory cap (``mem_cap``); ``CUT`` lists those
options with the values at which they do nothing, and the check refuses a
configuration that sets one otherwise.

BYTE tracker strategy with the BUSCA third association round (port of
``busca_tpu.trackers.byte``).

Behavioral rebuild of the canonical adapter
(adapters/ByteTrack/yolox/tracker/byte_tracker.py:195-456):

1. split detections by score into first round (> track_thresh) and second
   round (0.1 .. track_thresh);
2. round 1: IoU (+score fusion) + LAPJV over tracked+lost tracks;
3. round 2: IoU over remaining *tracked* tracks vs low-score detections;
4. **round 3b (BUSCA)**: for still-unmatched tracks — Kalman-prediction
   candidates and the decision-Transformer association; a track stays alive
   iff its own Kalman candidate wins with prob > ``busca_thresh``;
5. unconfirmed-track round, new-track init, lost-track pruning, duplicate
   removal, and the removed-list leak fix (byte_tracker.py:441-443).

The BUSCA crops for all considered detections are extracted in one crop-op
call (kernel K1 on the card) instead of the reference's per-detection cv2
loop (byte_tracker.py:278-287); the frame is uploaded to the engine's device
once per update.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from benchref import hostmath
from benchref import lap
from benchref.base import (
    KALMAN_CANDIDATE_CONF,
    Track,
    TrackState,
    extract_uint8_crops,
    joint_tracks,
    remove_duplicate_tracks,
    run_third_round,
    ThirdRoundRequest,
    sub_tracks,
)

# the program's options cut from this copy, each with the values at which
# it does nothing
CUT = {"use_camera_motion_compensation": (False,), "cmc_scale": (1.0,),
       "reliable_thresh": (None,), "mem_cap": (None,)}


@dataclasses.dataclass
class ByteTrackerConfig:
    track_thresh: float = 0.6
    track_buffer: int = 30
    match_thresh: float = 0.9
    mot20: bool = False
    # BUSCA knobs (config/ByteTrack/*/config_bytetrack_*.yml)
    use_busca: bool = False
    busca_thresh: float = 0.5
    seq_len: int = 11
    num_candidates: int = 5
    use_broader_memory: bool = True
    select_highest_candidate: bool = True
    highest_candidate_minimum_thresh: Optional[float] = None
    transformer_update_mems_only_first_round: bool = True
    crop_hw: tuple = (384, 128)


class ByteTracker:
    """One instance per video sequence (reset per video like the reference,
    mot_evaluator.py:166-173)."""

    def __init__(
        self,
        config: ByteTrackerConfig,
        assoc_engine=None,
        frame_rate: int = 30,
    ):
        self.cfg = config
        self.engine = assoc_engine
        self.tracked: List[Track] = []
        self.lost: List[Track] = []
        self.removed: List[Track] = []
        self.frame_id = 0
        self.det_thresh = config.track_thresh + 0.1
        self.buffer_size = int(frame_rate / 30.0 * config.track_buffer)
        self.max_time_lost = self.buffer_size
        self.use_busca = config.use_busca and assoc_engine is not None

    # ------------------------------------------------------------------ main --
    def update(
        self,
        bboxes_tlbr: np.ndarray,
        scores: np.ndarray,
        scale: float = 1.0,
        frame: Optional[np.ndarray] = None,
    ) -> List[Track]:
        """Process one frame.

        Args:
          bboxes_tlbr: ``[N, 4]`` detections in detector coordinates.
          scores: ``[N]`` confidences.
          scale: detector-coords = original-coords * scale.
          frame: uint8 BGR frame ``[H, W, 3]`` (needed for BUSCA crops): a
            host array, or a tensor on a device, such as a detector's
            canvas (the crops then read it where it lies).
        Returns:
          the activated output tracks.
        """
        gen = self._update_gen(bboxes_tlbr, scores, scale, frame)
        try:
            req = next(gen)
            while True:
                res = self._third_round(
                    req.pool, req.considered, req.kalman_cands, req.thresh
                )
                req = gen.send(res)
        except StopIteration as e:
            return e.value

    def update_deferred(
        self,
        bboxes_tlbr: np.ndarray,
        scores: np.ndarray,
        scale: float = 1.0,
        frame: Optional[np.ndarray] = None,
    ):
        """Deferred-third-round mode: returns the update generator; it
        yields at most one :class:`ThirdRoundRequest` (serviced by the
        caller via ``gen.send((matches, u_track))``) and returns the output
        tracks via ``StopIteration.value``."""
        return self._update_gen(bboxes_tlbr, scores, scale, frame)

    def _engine_kwargs(self) -> dict:
        """The engine kwargs _third_round passes (for batched servicing)."""
        return dict(
            use_broader_memory=self.cfg.use_broader_memory,
            select_highest_candidate=self.cfg.select_highest_candidate,
            highest_candidate_minimum_thresh=(
                self.cfg.highest_candidate_minimum_thresh
            ),
        )

    def _update_gen(
        self,
        bboxes_tlbr: np.ndarray,
        scores: np.ndarray,
        scale: float = 1.0,
        frame: Optional[np.ndarray] = None,
    ):
        self.frame_id += 1
        cfg = self.cfg
        activated, refind, lost, removed = [], [], [], []

        bboxes_tlbr = np.asarray(bboxes_tlbr, dtype=np.float64).reshape(-1, 4)
        scores = np.asarray(scores, dtype=np.float64).reshape(-1)

        first_mask = scores > cfg.track_thresh
        second_mask = (scores > 0.1) & (scores < cfg.track_thresh)
        considered_mask = first_mask | second_mask

        dets_first = bboxes_tlbr[first_mask]
        scores_first = scores[first_mask]
        dets_second = bboxes_tlbr[second_mask]
        scores_second = scores[second_mask]
        dets_considered = bboxes_tlbr[considered_mask]
        scores_considered = scores[considered_mask]

        # One crop call for every detection group.  The considered set IS
        # first ∪ second (same boxes, same order within each mask), so one
        # call over the considered boxes serves all three groups (the
        # reference crops per detection per group, byte_tracker.py:278-287).
        # The frame goes to the engine's device once; the Kalman-candidate
        # crops of the third round reuse it.
        frame_t = None
        if self.use_busca and cfg.busca_thresh > 0 and frame is not None:
            # a detector's device canvas stays where it is
            frame_t = frame
            imgs_considered = self._crops(frame_t, dets_considered * scale)
            fidx = np.where(first_mask[considered_mask])[0]
            sidx = np.where(second_mask[considered_mask])[0]
            imgs_first = [imgs_considered[i] for i in fidx]
            imgs_second = [imgs_considered[i] for i in sidx]
        else:
            imgs_first = [None] * len(dets_first)
            imgs_second = [None] * len(dets_second)
            imgs_considered = [None] * len(dets_considered)

        detections = [
            Track(hostmath.tlbr_to_tlwh(b), s, im, scale)
            for b, s, im in zip(dets_first, scores_first, imgs_first)
        ]
        considered_dets = [
            Track(hostmath.tlbr_to_tlwh(b), s, im, scale)
            for b, s, im in zip(dets_considered, scores_considered, imgs_considered)
        ]

        unconfirmed = [t for t in self.tracked if not t.is_activated]
        tracked = [t for t in self.tracked if t.is_activated]

        # ---- round 1: high-score detections ---------------------------------
        pool = joint_tracks(tracked, self.lost)
        Track.multi_predict(pool)
        dists = hostmath.iou_distance(
            np.stack([t.tlbr for t in pool]) if pool else np.zeros((0, 4)),
            np.stack([d.tlbr for d in detections]) if detections else np.zeros((0, 4)),
        )
        if not cfg.mot20:
            dists = hostmath.fuse_score(
                dists, np.array([d.score for d in detections])
            )
        matches, u_track, u_det = lap.linear_assignment(dists, cfg.match_thresh)

        post = Track.multi_update_posterior(
            [(pool[it], detections[idet]) for it, idet in matches]
        )
        for (it, idet), kf in zip(matches, post):
            track, det = pool[it], detections[idet]
            update_mems = det.score >= self.det_thresh
            if track.state == TrackState.Tracked:
                track.update(det, self.frame_id, update_mems, kf_posterior=kf)
                activated.append(track)
            else:
                track.re_activate(det, self.frame_id, False, update_mems,
                                  kf_posterior=kf)
                refind.append(track)

        # ---- round 2: low-score detections vs remaining tracked tracks ------
        detections_second = [
            Track(hostmath.tlbr_to_tlwh(b), s, im, scale)
            for b, s, im in zip(dets_second, scores_second, imgs_second)
        ]
        r_tracked = [
            pool[i] for i in u_track if pool[i].state == TrackState.Tracked
        ]
        r_lost = [
            pool[i] for i in u_track if pool[i].state != TrackState.Tracked
        ]
        dists = hostmath.iou_distance(
            np.stack([t.tlbr for t in r_tracked]) if r_tracked else np.zeros((0, 4)),
            np.stack([d.tlbr for d in detections_second])
            if detections_second
            else np.zeros((0, 4)),
        )
        matches, u_track, _ = lap.linear_assignment(dists, 0.5)
        post = Track.multi_update_posterior(
            [(r_tracked[it], detections_second[idet]) for it, idet in matches]
        )
        for (it, idet), kf in zip(matches, post):
            track, det = r_tracked[it], detections_second[idet]
            update_mems = not cfg.transformer_update_mems_only_first_round
            track.update(det, self.frame_id, update_mems, kf_posterior=kf)
            activated.append(track)

        unassigned = joint_tracks([r_tracked[i] for i in u_track], r_lost)
        u_track = list(range(len(unassigned)))

        # ---- round 3b: BUSCA -------------------------------------------------
        if self.use_busca and cfg.busca_thresh > 0:
            if frame is None:
                # no pixels -> no crops and no Kalman-candidate column
                # (defensive: the reference always has the eval image here;
                # reachable via a failed imread in a cached-detection run)
                pass
            else:
                third_pool = unassigned
                kalman_cands = self._kalman_candidates(third_pool, frame_t)
                third_matches, u_track = yield ThirdRoundRequest(
                    third_pool, considered_dets, kalman_cands,
                    cfg.busca_thresh, self._engine_kwargs(), self.engine,
                )
                post = Track.multi_update_posterior(
                    [(third_pool[it], kalman_cands[it])
                     for it, _prob in third_matches]
                )
                for (it, _prob), kf in zip(third_matches, post):
                    track = third_pool[it]
                    det = kalman_cands[it]
                    if track.state == TrackState.Tracked:
                        track.update(det, self.frame_id, update_mems=False,
                                     kf_posterior=kf)
                        activated.append(track)

        for it in u_track:
            track = unassigned[it]
            if track.state != TrackState.Lost:
                track.mark_lost()
                lost.append(track)

        # ---- unconfirmed tracks ---------------------------------------------
        detections = [detections[i] for i in u_det]
        dists = hostmath.iou_distance(
            np.stack([t.tlbr for t in unconfirmed]) if unconfirmed else np.zeros((0, 4)),
            np.stack([d.tlbr for d in detections]) if detections else np.zeros((0, 4)),
        )
        if not cfg.mot20:
            dists = hostmath.fuse_score(
                dists, np.array([d.score for d in detections])
            )
        matches, u_unconfirmed, u_det = lap.linear_assignment(dists, 0.7)
        post = Track.multi_update_posterior(
            [(unconfirmed[it], detections[idet]) for it, idet in matches]
        )
        for (it, idet), kf in zip(matches, post):
            unconfirmed[it].update(detections[idet], self.frame_id, True,
                                   kf_posterior=kf)
            activated.append(unconfirmed[it])
        for it in u_unconfirmed:
            track = unconfirmed[it]
            track.mark_removed()
            removed.append(track)

        # ---- init new tracks --------------------------------------------------
        for inew in u_det:
            track = detections[inew]
            if track.score < self.det_thresh:
                continue
            track.activate(self.frame_id)
            activated.append(track)

        # ---- prune lost --------------------------------------------------------
        for track in self.lost:
            if self.frame_id - track.end_frame > self.max_time_lost:
                track.mark_removed()
                removed.append(track)

        self.tracked = [t for t in self.tracked if t.state == TrackState.Tracked]
        self.tracked = joint_tracks(self.tracked, activated)
        self.tracked = joint_tracks(self.tracked, refind)
        self.lost = sub_tracks(self.lost, self.tracked)
        self.lost.extend(lost)
        self.lost = sub_tracks(self.lost, self.removed)
        self.removed.extend(removed)
        # leak fix (byte_tracker.py:441-443)
        self.removed = [
            t
            for t in self.removed
            if self.frame_id - t.end_frame < 10 * self.max_time_lost
        ]
        self.tracked, self.lost = remove_duplicate_tracks(self.tracked, self.lost)
        return [t for t in self.tracked if t.is_activated]

    # ------------------------------------------------------------ internals --
    def _crops(self, frame: torch.Tensor, boxes_tlbr: np.ndarray):
        """Uint8 BGR crops for the track memories (normalize happens in the
        association engine, like the reference's normalize_ims=True path)."""
        return extract_uint8_crops(
            frame, boxes_tlbr, self.cfg.crop_hw,
            bank=getattr(self.engine, "bank", None), device=frame.device,
        )

    def _kalman_candidates(self, pool: List[Track], frame) -> List[Track]:
        """Pseudo-detections at each track's Kalman-predicted position
        (byte_tracker.py:468-479)."""
        cands = []
        boxes = [t.tlbr * t.scale for t in pool]
        crops = self._crops(frame, np.array(boxes).reshape(-1, 4)) if pool else []
        for t, im in zip(pool, crops):
            cands.append(
                Track(t.tlwh, np.float32(KALMAN_CANDIDATE_CONF), im, t.scale)
            )
        return cands

    def _third_round(self, pool, considered_dets, kalman_cands, thresh):
        """BUSCA association; a track survives iff its Kalman candidate wins
        (byte_tracker.py:481-532).  Shared logic in base.run_third_round."""
        return run_third_round(
            self.engine,
            pool,
            considered_dets,
            kalman_cands,
            thresh,
            use_broader_memory=self.cfg.use_broader_memory,
            select_highest_candidate=self.cfg.select_highest_candidate,
            highest_candidate_minimum_thresh=self.cfg.highest_candidate_minimum_thresh,
        )
