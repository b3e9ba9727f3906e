"""GHOST tracker strategy with the BUSCA third association round (port of
``busca_tpu.trackers.ghost``).

Behavioral rebuild of the reference adapter (adapters/GHOST/src/
{tracker,base_tracker,tracking_utils}.py):

- active tracks + inactive tracks with an inactivity *patience*;
- appearance association on ReID features with **proxy distances**: the
  distance from a detection to a track is a reduction (min / mean / max /
  (max+min)/2 / median) over the track's feature history
  (tracker.py:279-304);
- **dynamic ReID thresholds**: act/inact thresholds re-estimated per frame
  from the distance statistics (``mean - k * std``,
  base_tracker.py:495-531);
- linear motion model (mean velocity over the last n positions,
  base_tracker.py:648-698) with IoU motion distance combined as
  ``(1 - a) * appearance + a * iou`` (``combi='sum_a'``,
  base_tracker.py:713-731);
- **ECC ego-motion compensation** (tracktor recipe, base_tracker.py:
  599-633): when ``motion_compensation`` is on and the sequence camera is
  moving (``is_moving``, tracking_utils.py:209-221), the stored position
  *history* of every active and inactive track is warped by the ECC
  alignment of the previous frame onto the current one (template =
  current frame, gaussFiltSize 15) before association — the current
  ``pos`` is deliberately left unwarped, matching the reference's
  rebinding of the ``last_pos`` list slots only (base_tracker.py:624-630);
  the velocity model then runs over the warped history.  The reference
  solves the ECC even on static cameras just to record a debug norm —
  here the solve is skipped when it would not be applied (flagged
  improvement, SURVEY §7.4; identical tracking behavior);
- assignment via ``solve_dense`` with nan-forbidden entries
  (tracker.py:395-412);
- **BUSCA third round** over unmatched active tracks with positive area
  (tracker.py:501-567), Kalman/linear-motion pseudo-candidates whose ReID
  features are computed *fresh on the crop* (tracker.py:684-708), and the
  conf-gated memory admission shared with the StrongSORT strategy.

The frame goes to the engine's device once per update; the detection crops
and the Kalman-candidate crops are cut from it there (kernel K1 on the
card), and the candidates' crops go into the feature extractor on the
device.  ECC runs on the host with cv2; the lockstep drivers prefetch it on
the shared CMC pool (``cmc_prefetch``, ``set_warp_hint``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from busca_tpu_torch.core import hostmath
from busca_tpu_torch.ops import lap
from busca_tpu_torch.trackers.base import (
    KALMAN_CANDIDATE_CONF,
    compact_mem_lists,
    device_crops,
    extract_uint8_crops,
    host_crops,
    host_frame,
    run_third_round,
    ThirdRoundRequest,
)
from busca_tpu_torch.utils import profiling

PROXY_REDUCERS = {
    "min": lambda d: d.min(axis=1),
    "mean": lambda d: d.mean(axis=1),
    "max": lambda d: d.max(axis=1),
    "meanminmax": lambda d: (d.max(axis=1) + d.min(axis=1)) / 2,
    "median": lambda d: np.median(d, axis=1),
}


class GhostTrack:
    """GHOST track: position, feature history, linear motion, BUSCA memory."""

    def __init__(self, track_id, pos_tlbr, feats, conf, frame, label=0,
                 image=None, conf_threshold=0.0, max_feats=100):
        self.track_id = track_id
        self.pos = np.asarray(pos_tlbr, dtype=np.float64)
        self.feats = np.asarray(feats, dtype=np.float64)
        self.past_feats: List[np.ndarray] = [self.feats]
        self.last_pos: List[np.ndarray] = [self.pos.copy()]
        self.past_frames: List[int] = [frame]
        self.last_v = np.zeros(4)
        self.inactive_count = 0
        self.label = label
        self.conf = conf
        self.conf_threshold = conf_threshold
        self.max_feats = max_feats
        self.scale = 1.0

        self._tlwh_mem: List[np.ndarray] = [self.tlwh.copy()]
        self._images_mem: List[Optional[np.ndarray]] = [image]
        self.conf_mem: List[float] = [conf]
        self.image = image
        # bounded appearance memory for long-stream serving (None =
        # reference semantics; see trackers/base.py compact_mem_lists)
        self.mem_cap: Optional[int] = None
        self._mem_stride = 1
        self._mem_clock = 1
        self._mem_ticks: List[int] = [0]

    def __len__(self):
        return len(self.past_frames)

    @property
    def tlwh(self) -> np.ndarray:
        p = self.pos
        return np.array([p[0], p[1], p[2] - p[0], p[3] - p[1]])

    @property
    def tlbr(self) -> np.ndarray:
        return self.pos.copy()

    @property
    def score(self) -> float:
        """Runner-protocol alias for the last admission confidence."""
        return self.conf

    # conf-filtered BUSCA memory views (tracking_utils.py:408-439)
    @property
    def tlwh_mem(self):
        return [
            b
            for b, c in zip(self._tlwh_mem, self.conf_mem)
            if c >= self.conf_threshold
        ]

    @property
    def images_mem(self):
        return [
            im
            for im, c in zip(self._images_mem, self.conf_mem)
            if c >= self.conf_threshold and im is not None
        ]

    def add_detection(self, pos_tlbr, feats, conf, frame, image=None,
                      save_memory=False):
        self.pos = np.asarray(pos_tlbr, dtype=np.float64)
        self.feats = np.asarray(feats, dtype=np.float64)
        self.past_feats.append(self.feats)
        self.past_feats = self.past_feats[-self.max_feats:]
        self.last_pos.append(self.pos.copy())
        self.past_frames.append(frame)
        self.conf = conf
        self._tlwh_mem.append(self.tlwh.copy())
        self.conf_mem.append(conf)
        if save_memory and conf < self.conf_threshold:
            self._images_mem.append(None)  # memory-saving mode (tracker.py:249-259)
        else:
            self._images_mem.append(image)
        self.image = image
        self._mem_ticks.append(self._mem_clock)
        self._mem_clock += 1
        if (self.mem_cap is not None
                and len(self._mem_ticks) > self.mem_cap):
            lists, self._mem_ticks, self._mem_stride = compact_mem_lists(
                [self._tlwh_mem, self.conf_mem, self._images_mem],
                self._mem_ticks, self.mem_cap, self._mem_stride,
            )
            self._tlwh_mem, self.conf_mem, self._images_mem = lists
        if self.mem_cap is not None and len(self.last_pos) > self.mem_cap:
            # position history: only the last_n_frames tail is ever read
            # (update_velocity); a plain sliding window suffices, and it
            # also bounds warp_position_history's O(len) per-frame cost
            del self.last_pos[: -self.mem_cap]
            del self.past_frames[: -self.mem_cap]

    def update_velocity(self, last_n: int):
        if len(self.last_pos) < 2:
            return
        pos = np.asarray(self.last_pos[-last_n:])
        frames = np.asarray(self.past_frames[-last_n:], dtype=np.float64)
        dt = np.maximum(frames[1:] - frames[:-1], 1.0)[:, None]
        vs = (pos[1:] - pos[:-1]) / dt
        self.last_v = vs.mean(axis=0)

    def motion_step(self):
        self.pos = self.pos + self.last_v

    def warp_position_history(self, warp: np.ndarray):
        """Warp every stored ``last_pos`` entry by a 2x3 matrix — and ONLY
        the history, not the current ``pos`` (the reference rebinds the
        ``last_pos`` list slots, leaving ``track.pos`` aliased to the old
        array, base_tracker.py:624-630 + tracking_utils.py:167-173)."""
        w = np.asarray(warp, dtype=np.float64)
        for i, p in enumerate(self.last_pos):
            p1 = w @ np.array([p[0], p[1], 1.0])
            p2 = w @ np.array([p[2], p[3], 1.0])
            self.last_pos[i] = np.array([p1[0], p1[1], p2[0], p2[1]])


@dataclasses.dataclass
class GhostConfig:
    act_reid_thresh: float = 0.7    # or "tbd" for dynamic
    inact_reid_thresh: float = 0.7
    thresh_every: bool = False       # re-estimate thresholds every frame
    thresh_tbd: bool = False         # estimate once from first frame stats
    inact_patience: int = 50
    proxy_act: str = "last"          # 'last' or a PROXY_REDUCERS key
    proxy_inact: str = "meanminmax"
    apply_motion_model: bool = True
    last_n_frames: int = 5
    combi: str = "sum_0.3"
    # ECC ego-motion compensation (base_tracker.py:599-633); applied only
    # when the sequence camera moves (is_moving, tracking_utils.py:209)
    motion_compensation: bool = False
    is_moving: bool = True
    mc_num_iter: int = 100
    mc_termination_eps: float = 1e-5
    cmc_scale: float = 1.0
    remove_unconfirmed: bool = False
    det_conf: float = 0.5
    # BUSCA knobs (config/GHOST/*/config_ghost_*.yml)
    use_busca: bool = False
    busca_thresh: float = 0.5
    seq_len: int = 11
    num_candidates: int = 5
    use_broader_memory: bool = True
    select_highest_candidate: bool = True
    highest_candidate_minimum_thresh: Optional[float] = None
    keep_highest_value: bool = False
    minimum_conf_modifier: float = 0.20
    transformer_update_mems_only_first_round: bool = True
    update_feats_third_round: bool = False
    avoid_memory_leak: bool = False
    crop_hw: Tuple[int, int] = (384, 128)
    # bounded appearance memory for long-stream serving (None = reference
    # semantics; see trackers/base.py compact_mem_lists).  Also bounds the
    # per-track position history (last_pos/past_frames, read only within
    # last_n_frames) to the same cap.
    mem_cap: Optional[int] = None


class GhostTracker:
    """One instance per sequence.

    Args:
      feature_extractor: optional ``crops_uint8 [N,H,W,3] -> feats [N,F]``
        callable (such as
        :class:`~busca_tpu_torch.eval.features.ReidFeatureExtractor`), used
        to compute fresh ReID features for Kalman candidates
        (tracker.py:684-708); it is handed the candidates' crops as a tensor
        on the engine's device.  Without it the track's last features are
        used.
    """

    def __init__(self, config: GhostConfig, assoc_engine=None,
                 feature_extractor: Optional[Callable] = None):
        self.cfg = config
        if config.mem_cap is not None and config.mem_cap < 4:
            raise ValueError(
                f"mem_cap must be >= 4 (recommended >= ~5*seq_len), "
                f"got {config.mem_cap}"
            )
        if (config.mem_cap is not None
                and config.mem_cap < config.last_n_frames):
            # the bounded position history doubles as the velocity window
            # source (update_velocity reads the last_n_frames tail); a cap
            # below it would silently shorten the velocity estimate
            raise ValueError(
                f"mem_cap ({config.mem_cap}) must be >= last_n_frames "
                f"({config.last_n_frames}): the position-history bound "
                f"would truncate the velocity window"
            )
        self.engine = assoc_engine
        self.feature_extractor = feature_extractor
        self.tracks: Dict[int, GhostTrack] = {}
        self.inactive_tracks: Dict[int, GhostTrack] = {}
        self._next_id = 1
        self.frame_id = 0
        self.use_busca = config.use_busca and assoc_engine is not None
        self.act_thresh = config.act_reid_thresh
        self.inact_thresh = config.inact_reid_thresh
        self._last_mc_frame: Optional[np.ndarray] = None
        # a prefetched ECC warp for the next update, consumed once
        self._warp_hint = None
        self.conf_threshold = (
            config.det_conf + config.minimum_conf_modifier
            if self.use_busca and config.transformer_update_mems_only_first_round
            else 0.0
        )

    # ------------------------------------------------------------------ api --
    def update(
        self,
        boxes_tlbr: np.ndarray,
        scores: np.ndarray,
        features: np.ndarray,
        frame: Optional[np.ndarray] = None,
    ) -> List[GhostTrack]:
        gen = self._update_gen(boxes_tlbr, scores, features, frame)
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
        boxes_tlbr: np.ndarray,
        scores: np.ndarray,
        features: np.ndarray,
        frame: Optional[np.ndarray] = None,
    ):
        """Deferred-third-round mode: yields at most one
        :class:`ThirdRoundRequest`, output via ``StopIteration.value``."""
        return profiling.spanned_steps(
            self._update_gen(boxes_tlbr, scores, features, frame),
            "tracker.update")

    def set_warp_hint(self, warp_fn):
        """A zero-argument callable giving ``(cc, warp_2x3)`` for the next
        update's ego-motion compensation, solved on the frame pair and with
        the recipe that update would use inline.  Consumed once."""
        self._warp_hint = warp_fn

    def cmc_prefetch(self, cur_frame):
        """Schedule the next update's ECC solve on the shared CMC pool
        (:func:`cmc.submit_warp`) with GHOST's recipe (template = the
        current frame, gauss_filt_size 15, base_tracker.py:607-620) and
        hold it as the warp hint.  Returns the future, or None when the
        update would not align."""
        cfg = self.cfg
        if (not cfg.motion_compensation or cur_frame is None
                or self._last_mc_frame is None or not cfg.is_moving
                or not (self.tracks or self.inactive_tracks)):
            return None
        from busca_tpu_torch.trackers import cmc

        fut = cmc.submit_warp(
            host_frame(cur_frame), self._last_mc_frame, scale=cfg.cmc_scale,
            number_of_iterations=cfg.mc_num_iter,
            termination_eps=cfg.mc_termination_eps, gauss_filt_size=15,
        )
        self.set_warp_hint(fut.result)
        return fut

    def _engine_kwargs(self) -> dict:
        cfg = self.cfg
        return dict(
            use_broader_memory=cfg.use_broader_memory,
            select_highest_candidate=cfg.select_highest_candidate,
            highest_candidate_minimum_thresh=(
                cfg.highest_candidate_minimum_thresh
            ),
            keep_highest_value=cfg.keep_highest_value,
        )

    def _update_gen(
        self,
        boxes_tlbr: np.ndarray,
        scores: np.ndarray,
        features: np.ndarray,
        frame: Optional[np.ndarray] = None,
    ):
        self.frame_id += 1
        cfg = self.cfg
        boxes_tlbr = np.asarray(boxes_tlbr, dtype=np.float64).reshape(-1, 4)
        scores = np.asarray(scores, dtype=np.float64).reshape(-1)
        n = len(boxes_tlbr)
        feats = (
            np.asarray(features, dtype=np.float64).reshape(n, -1)
            if n
            else np.zeros((0, 1))
        )

        # ---- ECC ego-motion compensation (base_tracker.py:599-633) ----------
        # before association; warps the position HISTORY of every active and
        # inactive track when the camera moves.  Solve skipped when it would
        # not be applied (the reference runs it anyway for a debug norm).
        warp_hint, self._warp_hint = self._warp_hint, None
        if cfg.motion_compensation and frame is not None:
            host = host_frame(frame)
            if (
                self._last_mc_frame is not None
                and cfg.is_moving
                and (self.tracks or self.inactive_tracks)
            ):
                from busca_tpu_torch.trackers import cmc

                # template = CURRENT frame ("changed this from tracktor",
                # base_tracker.py:607-611): the warp maps last-frame coords
                # into current-frame coords for the stored positions
                if warp_hint is not None:
                    _cc, warp = warp_hint()
                else:
                    _cc, warp = cmc.ecc_align(
                        host,
                        self._last_mc_frame,
                        number_of_iterations=cfg.mc_num_iter,
                        termination_eps=cfg.mc_termination_eps,
                        scale=cfg.cmc_scale,
                        gauss_filt_size=15,
                    )
                for group in (self.tracks, self.inactive_tracks):
                    for t in group.values():
                        t.warp_position_history(warp)
            # defensive copy: np.asarray would alias a caller-owned buffer,
            # and a reused/decoded-in-place frame would silently turn the
            # next solve into frame-vs-itself (identity warp)
            self._last_mc_frame = np.array(host, copy=True)

        # the frame goes to the engine's device once; the detection crops
        # and the Kalman-candidate crops are cut from it there
        det_images = [None] * n
        frame_t = None
        if self.use_busca and frame is not None:
            frame_t = torch.as_tensor(frame).to(self.engine.device)
            if n:
                det_images = extract_uint8_crops(
                    frame_t, boxes_tlbr, cfg.crop_hw,
                    bank=getattr(self.engine, "bank", None),
                    device=frame_t.device,
                )

        curr_inactive = {
            k: t
            for k, t in self.inactive_tracks.items()
            if t.inactive_count <= cfg.inact_patience
        }

        if not self.tracks and not curr_inactive:
            for i in range(n):
                self._new_track(boxes_tlbr[i], feats[i], scores[i],
                                det_images[i])
            self._age_inactive()
            return list(self.tracks.values())

        act_ids = list(self.tracks.keys())
        inact_ids = list(curr_inactive.keys())
        num_active = len(act_ids)

        # ---- appearance distances (proxy reductions) -------------------------
        match = profiling.begin("tracker.match")
        dist_cols = []
        for tid in act_ids:
            dist_cols.append(
                self._proxy_dist(self.tracks[tid], feats, cfg.proxy_act)
            )
        for tid in inact_ids:
            dist_cols.append(
                self._proxy_dist(curr_inactive[tid], feats, cfg.proxy_inact)
            )
        if dist_cols and n:
            dist = np.stack(dist_cols, axis=1)  # [num_dets, num_tracks]
        else:
            dist = np.zeros((n, len(dist_cols)))
        match.end()

        self._update_thresholds(dist, num_active, len(inact_ids))

        # ---- motion model -----------------------------------------------------
        if cfg.apply_motion_model and n:
            for t in self.tracks.values():
                t.update_velocity(cfg.last_n_frames)
                t.motion_step()
            for t in curr_inactive.values():
                if len(t.last_pos) > 1:
                    t.motion_step()
            all_pos = np.array(
                [self.tracks[k].pos for k in act_ids]
                + [curr_inactive[k].pos for k in inact_ids]
            ).reshape(-1, 4)
            iou_dist = 1 - hostmath.iou_matrix(boxes_tlbr, all_pos)
            if cfg.combi.startswith("sum"):
                alpha = float(cfg.combi.split("_")[-1])
                dist = (1 - alpha) * dist + alpha * iou_dist

        # ---- forbid over-threshold entries, solve -----------------------------
        match = profiling.begin("tracker.match")
        if dist.size:
            work = dist.copy()
            work[:, :num_active] = np.where(
                work[:, :num_active] <= self.act_thresh,
                work[:, :num_active],
                np.nan,
            )
            work[:, num_active:] = np.where(
                work[:, num_active:] <= self.inact_thresh,
                work[:, num_active:],
                np.nan,
            )
            rows, cols = lap.solve_dense(work)
        else:
            rows, cols = np.zeros(0, int), np.zeros(0, int)
        match.end()

        all_ids = act_ids + inact_ids
        active_now: List[int] = []
        assigned_dets: set = set()
        for r, c in zip(rows, cols):
            tid = all_ids[c]
            conf = scores[r]
            if self.use_busca and cfg.transformer_update_mems_only_first_round:
                conf = max(conf, self.conf_threshold)
            if c >= num_active:
                # revive an inactive track
                track = self.inactive_tracks.pop(tid)
                track.inactive_count = 0
                self.tracks[tid] = track
            self.tracks[tid].add_detection(
                boxes_tlbr[r], feats[r], conf, self.frame_id,
                det_images[r], save_memory=cfg.avoid_memory_leak,
            )
            active_now.append(tid)
            assigned_dets.add(r)

        # ---- BUSCA third round -------------------------------------------------
        if self.use_busca and cfg.busca_thresh > 0 and frame is not None:
            third_ids, third_pool = [], []
            for k in list(self.tracks.keys()):
                if k in active_now:
                    continue
                t = self.tracks[k]
                tlwh_area = t.tlwh[2] * t.tlwh[3]
                pos_area = (t.pos[2] - t.pos[0]) * (t.pos[3] - t.pos[1])
                if tlwh_area <= 0 or pos_area <= 0:
                    continue  # negative-area filter (tracker.py:512-517)
                third_ids.append(k)
                third_pool.append(t)
            if third_pool:
                kalman_cands = self._kalman_candidates(third_pool, frame_t)
                considered = self._considered_dets(
                    boxes_tlbr, scores, feats, det_images
                )
                matches3, _ = yield ThirdRoundRequest(
                    third_pool, considered, kalman_cands, cfg.busca_thresh,
                    self._engine_kwargs(), self.engine,
                )
                for it, _prob in matches3:
                    track = third_pool[it]
                    det = kalman_cands[it]
                    if cfg.transformer_update_mems_only_first_round:
                        new_feats = (
                            det.feats
                            if cfg.update_feats_third_round
                            else track.feats
                        )
                        new_img = (
                            track._images_mem[-1] if track._images_mem else None
                        )
                        new_conf = KALMAN_CANDIDATE_CONF
                    else:
                        new_feats = det.feats
                        new_img = det.image
                        new_conf = det.conf
                    track.add_detection(
                        det.pos, new_feats, new_conf, self.frame_id, new_img,
                        save_memory=cfg.avoid_memory_leak,
                    )
                    active_now.append(third_ids[it])

        # ---- deactivate unmatched active tracks --------------------------------
        for k in list(self.tracks.keys()):
            if k not in active_now:
                confirmed = (
                    len(self.tracks[k]) >= 2 if cfg.remove_unconfirmed else True
                )
                if confirmed:
                    self.inactive_tracks[k] = self.tracks[k]
                    self.inactive_tracks[k].inactive_count = 0
                del self.tracks[k]

        self._age_inactive()

        # ---- new tracks ----------------------------------------------------------
        for i in range(n):
            if i not in assigned_dets:
                conf = scores[i]
                if self.use_busca and cfg.transformer_update_mems_only_first_round:
                    conf = max(conf, self.conf_threshold)
                self._new_track(boxes_tlbr[i], feats[i], conf, det_images[i])

        return list(self.tracks.values())

    # ------------------------------------------------------------ internals --
    def _new_track(self, pos, feats, conf, image):
        tr = GhostTrack(
            self._next_id, pos, feats, conf, self.frame_id, image=image,
            conf_threshold=self.conf_threshold,
        )
        tr.mem_cap = self.cfg.mem_cap
        self.tracks[self._next_id] = tr
        self._next_id += 1

    def _age_inactive(self):
        dead = []
        for k, t in self.inactive_tracks.items():
            t.inactive_count += 1
            if t.inactive_count > self.cfg.inact_patience:
                dead.append(k)
        for k in dead:
            del self.inactive_tracks[k]

    @staticmethod
    def _cosine_dist(x: np.ndarray, y: np.ndarray) -> np.ndarray:
        xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        yn = y / np.maximum(np.linalg.norm(y, axis=1, keepdims=True), 1e-12)
        return 1.0 - xn @ yn.T

    def _proxy_dist(self, track, det_feats, mode: str) -> np.ndarray:
        if len(det_feats) == 0:
            return np.zeros(0)
        if mode == "last" or len(track.past_feats) == 1:
            return self._cosine_dist(det_feats, track.feats[None])[:, 0]
        d = self._cosine_dist(det_feats, np.stack(track.past_feats))
        return PROXY_REDUCERS[mode](d)

    def _update_thresholds(self, dist, num_active, num_inactive):
        cfg = self.cfg
        if dist.size == 0:
            return
        if (self.act_thresh == "tbd" or cfg.thresh_every) and num_active > 0:
            d = dist[:, :num_active]
            if cfg.thresh_every:
                self.act_thresh = np.mean(d)
            elif cfg.thresh_tbd or self.act_thresh == "tbd":
                self.act_thresh = np.mean(d) - 0.5 * np.std(d)
        if (self.inact_thresh == "tbd" or cfg.thresh_every) and num_inactive > 0:
            d = dist[:, num_active:]
            if cfg.thresh_every:
                self.inact_thresh = np.mean(d) - 2 * np.std(d)
            elif cfg.thresh_tbd or self.inact_thresh == "tbd":
                self.inact_thresh = np.mean(d) - 1 * np.std(d)

    def _kalman_candidates(self, pool, frame):
        boxes = np.array([t.pos for t in pool]).reshape(-1, 4)
        with profiling.span("tracker.crops"):
            crops_dev = device_crops(frame, boxes, self.cfg.crop_hw,
                                     frame.device)
            crops = host_crops(crops_dev, getattr(self.engine, "bank", None))
        if self.feature_extractor is not None and len(crops):
            # the device crops go into the network without a host copy
            fresh = np.asarray(self.feature_extractor(crops_dev))
        else:
            fresh = np.stack([t.feats for t in pool])
        cands = []
        for t, im, f in zip(pool, crops, fresh):
            cands.append(
                GhostTrack(
                    -1, t.pos, f, self.conf_threshold, self.frame_id, image=im
                )
            )
        return cands

    def _considered_dets(self, boxes, scores, feats, det_images):
        dets = []
        for i in range(len(boxes)):
            conf = scores[i]
            if self.cfg.transformer_update_mems_only_first_round:
                conf = max(conf, self.conf_threshold)
            dets.append(
                GhostTrack(
                    -1, boxes[i], feats[i], conf, self.frame_id,
                    image=det_images[i],
                )
            )
        return dets

    def _third_round(self, pool, considered, kalman_cands, thresh):
        """Shared logic in base.run_third_round (GHOST semantics:
        src/tracker.py:501-567)."""
        cfg = self.cfg
        return run_third_round(
            self.engine,
            pool,
            considered,
            kalman_cands,
            thresh,
            use_broader_memory=cfg.use_broader_memory,
            select_highest_candidate=cfg.select_highest_candidate,
            highest_candidate_minimum_thresh=cfg.highest_candidate_minimum_thresh,
            keep_highest_value=cfg.keep_highest_value,
        )
