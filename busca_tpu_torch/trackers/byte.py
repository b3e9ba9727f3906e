"""BYTE tracker strategy with the BUSCA third association round (port of
``busca_tpu.trackers.byte``).

Behavioral rebuild of the canonical adapter
(adapters/ByteTrack/yolox/tracker/byte_tracker.py:195-456):

1. split detections by score into first round (> track_thresh) and second
   round (0.1 .. track_thresh);
2. round 1: IoU (+score fusion) + LAPJV over tracked+lost tracks;
3. round 2: IoU over remaining *tracked* tracks vs low-score detections;
4. **round 3b (BUSCA)**: for still-unmatched tracks — detection-coverage
   reliability gate, ECC camera-motion compensation, Kalman-prediction
   candidates, and the decision-Transformer association; a track stays alive
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
from typing import List, Optional, Sequence

import numpy as np
import torch

from busca_tpu_torch.core import hostmath
from busca_tpu_torch.ops import lap
from busca_tpu_torch.trackers import cmc
from busca_tpu_torch.trackers.base import (
    KALMAN_CANDIDATE_CONF,
    Track,
    TrackState,
    extract_uint8_crops,
    host_frame,
    joint_tracks,
    remove_duplicate_tracks,
    run_third_round,
    ThirdRoundRequest,
    sub_tracks,
)
from busca_tpu_torch.utils import profiling


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
    reliable_thresh: Optional[Sequence[float]] = None
    use_camera_motion_compensation: bool = True
    # ECC solve resolution: 1.0 = the reference's full-res recipe
    # (byte_tracker.py:626-650)
    cmc_scale: float = 1.0
    crop_hw: tuple = (384, 128)
    # bounded appearance memory for long-stream serving (None = reference
    # semantics: per-track memories grow unboundedly,
    # byte_tracker.py:150-156).  Keeps a dense tail of recent admissions +
    # an even-stride archive of the older history (Track._compact_mems);
    # use >= ~5*seq_len.  A deviation from the reference.
    mem_cap: Optional[int] = None


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
        if config.mem_cap is not None and config.mem_cap < 4:
            raise ValueError(
                f"mem_cap must be >= 4 (recommended >= ~5*seq_len; the cap "
                f"splits into a dense tail and a strided archive), "
                f"got {config.mem_cap}"
            )
        self.engine = assoc_engine
        self.tracked: List[Track] = []
        self.lost: List[Track] = []
        self.removed: List[Track] = []
        self.frame_id = 0
        self.det_thresh = config.track_thresh + 0.1
        self.buffer_size = int(frame_rate / 30.0 * config.track_buffer)
        self.max_time_lost = self.buffer_size
        self.last_image: Optional[np.ndarray] = None
        self.use_busca = config.use_busca and assoc_engine is not None
        # a prefetched ECC warp for the next update, consumed once (the
        # lockstep drivers' cmc_prefetch; cmc.submit_warp)
        self._warp_hint = None

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
          frame: uint8 BGR frame ``[H, W, 3]`` (needed for BUSCA crops /
            CMC): a host array, or a tensor on a device, such as a
            detector's canvas (the crops then read it where it lies).
        Returns:
          the activated output tracks.
        """
        gen = self._update_gen(bboxes_tlbr, scores, scale, frame)
        with profiling.span("tracker.update"):
            try:
                req = next(gen)
                while True:
                    res = self._third_round(
                        req.pool, req.considered, req.kalman_cands,
                        req.thresh
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
        return profiling.spanned_steps(
            self._update_gen(bboxes_tlbr, scores, scale, frame),
            "tracker.update")

    def set_warp_hint(self, warp_fn):
        """A zero-argument callable giving ``(cc, warp_2x3)`` for the next
        update's camera-motion compensation, solved on the frame pair that
        update would align itself, so the result equals the inline path.
        Consumed once; ignored when CMC is off or the third round does not
        run."""
        self._warp_hint = warp_fn

    def cmc_prefetch(self, cur_frame):
        """Schedule the ECC solve of the next ``update(..., frame=cur_frame)``
        on the shared CMC pool (:func:`cmc.submit_warp`) with this tracker's
        recipe, and hold it as the warp hint.  The lockstep drivers call
        this for every sequence before any update runs.  Returns the future,
        or None when the update would not align."""
        cfg = self.cfg
        if (not self.use_busca or not cfg.use_camera_motion_compensation
                or cur_frame is None or self.last_image is None):
            return None
        fut = cmc.submit_warp(self.last_image, host_frame(cur_frame),
                              scale=cfg.cmc_scale)
        self.set_warp_hint(fut.result)
        return fut

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
        warp_hint, self._warp_hint = self._warp_hint, None
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
            frame_t = torch.as_tensor(frame).to(self.engine.device)
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
        match = profiling.begin("tracker.match")
        dists = hostmath.iou_distance(
            np.stack([t.tlbr for t in pool]) if pool else np.zeros((0, 4)),
            np.stack([d.tlbr for d in detections]) if detections else np.zeros((0, 4)),
        )
        if not cfg.mot20:
            dists = hostmath.fuse_score(
                dists, np.array([d.score for d in detections])
            )
        matches, u_track, u_det = lap.linear_assignment(dists, cfg.match_thresh)
        match.end()

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
        match = profiling.begin("tracker.match")
        dists = hostmath.iou_distance(
            np.stack([t.tlbr for t in r_tracked]) if r_tracked else np.zeros((0, 4)),
            np.stack([d.tlbr for d in detections_second])
            if detections_second
            else np.zeros((0, 4)),
        )
        matches, u_track, _ = lap.linear_assignment(dists, 0.5)
        match.end()
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
            elif cfg.reliable_thresh is not None and not self._is_reliable(
                frame, self.tracked, cfg.reliable_thresh
            ):
                pass  # unreliable frame: skip the third round entirely
            else:
                third_pool = unassigned
                if cfg.use_camera_motion_compensation and self.frame_id > 1:
                    if warp_hint is not None:
                        _cc, warp = warp_hint()
                        cmc.apply_warp(third_pool, warp)
                    else:
                        cmc.compensate_tracks(
                            third_pool, self.last_image, host_frame(frame),
                            scale=cfg.cmc_scale,
                        )
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
        match = profiling.begin("tracker.match")
        dists = hostmath.iou_distance(
            np.stack([t.tlbr for t in unconfirmed]) if unconfirmed else np.zeros((0, 4)),
            np.stack([d.tlbr for d in detections]) if detections else np.zeros((0, 4)),
        )
        if not cfg.mot20:
            dists = hostmath.fuse_score(
                dists, np.array([d.score for d in detections])
            )
        matches, u_unconfirmed, u_det = lap.linear_assignment(dists, 0.7)
        match.end()
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
            track.mem_cap = cfg.mem_cap
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

        # keep the frame only if next frame's CMC will read it
        keep_frame = (
            frame is not None
            and self.use_busca
            and cfg.use_camera_motion_compensation
        )
        self.last_image = host_frame(frame).copy() if keep_frame else None
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

    def _is_reliable(self, frame, active_tracks, p) -> bool:
        """Detection-coverage gate (byte_tracker.py:459-465, 574-623)."""
        cov = detection_coverage(frame, active_tracks)
        return cov["area_covered"] > cov["area_covered_per_obj"] * p[0] + p[1]


def detection_coverage(frame: np.ndarray, tracks: Sequence[Track]) -> dict:
    """Fraction of the frame covered by track boxes + per-object stats.

    numpy rasterization equivalent to the reference's cv2.rectangle fill
    (byte_tracker.py:574-623), including the inclusive right/bottom edges of
    cv2.rectangle and the reference's (quirky, tuned-around) axis-swapped
    normalization of per-box areas.
    """
    h, w = frame.shape[0], frame.shape[1]
    canvas = np.zeros((h, w), dtype=bool)
    bbox_areas = []
    for t in tracks:
        b = np.array(t.tlbr) * t.scale
        x1, y1, x2, y2 = int(b[0]), int(b[1]), int(b[2]), int(b[3])
        x1, x2 = min(x1, x2), max(x1, x2)
        y1, y2 = min(y1, y2), max(y1, y2)
        # cv2.rectangle(thickness=-1) fills [y1, y2] x [x1, x2] inclusive.
        ys, ye = max(y1, 0), min(y2 + 1, h)
        xs, xe = max(x1, 0), min(x2 + 1, w)
        if ys < ye and xs < xe:
            canvas[ys:ye, xs:xe] = True
        # NOTE: x-extent normalized by H and y-extent by W — reproducing the
        # reference exactly; reliable_thresh values were tuned with this.
        area = max(min(((b[2] - b[0]) / h) * ((b[3] - b[1]) / w), 1.0), 0.0)
        bbox_areas.append(area)

    covered = float(canvas.sum()) / (h * w)
    n = len(bbox_areas)
    if n > 0:
        per_obj = covered / n
        avg_area = float(np.sqrt(np.array(bbox_areas)).mean() ** 2)
        max_area = float(max(bbox_areas))
    else:
        per_obj, avg_area, max_area = 0.0, 0.0, 0.0
    return {
        "area_covered": covered,
        "area_covered_per_obj": per_obj,
        "max_bbox_area": max_area,
        "average_bbox_area": avg_area,
        "bbox_areas": bbox_areas,
    }
