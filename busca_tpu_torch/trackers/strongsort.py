"""StrongSORT tracker strategy with the BUSCA third association round (port
of ``busca_tpu.trackers.strongsort``).

Behavioral rebuild of the reference adapter
(adapters/StrongSORT/deep_sort/{tracker,track,linear_assignment}.py):

- DeepSORT state machine (Tentative/Confirmed/Deleted, n_init, max_age);
- appearance association via a budget-capped cosine gallery
  (NearestNeighborDistanceMetric) gated by Mahalanobis distance and fused
  with motion cost (``MC_lambda``, linear_assignment.py:200-209);
- StrongSORT upgrades: NSA Kalman (measurement noise scaled by detection
  confidence, track.py:242), EMA feature smoothing (track.py:245-248),
  vanilla single-level matching instead of the cascade (``woC``);
- IoU association for unconfirmed + age-1 tracks (tracker.py:238-248);
- **BUSCA third round** over unmatched *confirmed, age-1* tracks
  (tracker.py:129-189): Kalman pseudo-detections, conf-threshold-filtered
  memories (``Track._conf_thres`` = min_confidence + minimum_conf_modifier,
  tracker.py:79-84), and the memory-admission policy on a BUSCA match
  (kept alive with conf 0.10000001 so the frame never enters the memory,
  tracker.py:169-183).

This strategy runs on *precomputed detections + ReID features* like the
reference StrongSORT path (deep_sort_app.py:50-52); the frame image is only
needed for BUSCA crops.  The frame goes to the engine's device once per
update; the detection crops and the Kalman-candidate crops of the third
round are cut from it there (kernel K1 on the card).  The cosine gallery,
the Mahalanobis gate and the Hungarian assignment stay numpy on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from busca_tpu_torch.core import hostmath
from busca_tpu_torch.trackers.base import (
    KALMAN_CANDIDATE_CONF,
    compact_mem_lists,
    extract_uint8_crops,
    run_third_round,
    ThirdRoundRequest,
)

INFTY_COST = 1e5

_KF = hostmath.HostKalman()


class SSState:
    Tentative = 1
    Confirmed = 2
    Deleted = 3


class SSTrack:
    """DeepSORT-style track with BUSCA memory views."""

    def __init__(
        self,
        xyah: np.ndarray,
        track_id: int,
        n_init: int,
        max_age: int,
        feature: Optional[np.ndarray] = None,
        score: float = 0.0,
        image: Optional[np.ndarray] = None,
        conf_threshold: float = 1.0,
        ema_alpha: float = 0.9,
    ):
        self.track_id = track_id
        self.hits = 1
        self.age = 1
        self.time_since_update = 0
        self.state = SSState.Tentative
        self._n_init = n_init
        self._max_age = max_age
        self.scale = 1.0
        self.conf_threshold = conf_threshold
        self.ema_alpha = ema_alpha

        self.features: List[np.ndarray] = []
        if feature is not None:
            f = feature / np.linalg.norm(feature)
            self.features.append(f)

        m, c = _KF.initiate(np.asarray(xyah)[None])
        self.mean, self.covariance = m[0], c[0]

        self._tlwh_mem: List[np.ndarray] = [self.tlwh]
        # always append (None for an imageless birth) so the three memory
        # lists stay index-aligned — the conf-filtered zip views and the
        # mem-cap compaction both rely on parallel indices
        self._images_mem: List[Optional[np.ndarray]] = [image]
        self.image = image
        self.conf_mem: List[float] = [score]
        self.score = score
        # bounded appearance memory for long-stream serving (None =
        # reference semantics; see trackers/base.py compact_mem_lists)
        self.mem_cap: Optional[int] = None
        self._mem_stride = 1
        self._mem_clock = 1
        self._mem_ticks: List[int] = [0]

    # ------------------------------------------------------------ geometry --
    @property
    def tlwh(self) -> np.ndarray:
        ret = self.mean[:4].copy()
        ret[2] *= ret[3]
        ret[:2] -= ret[2:] / 2
        return ret

    @property
    def tlbr(self) -> np.ndarray:
        ret = self.tlwh
        ret[2:] += ret[:2]
        return ret

    @property
    def xyah(self) -> np.ndarray:
        return self.mean[:4].copy()

    # -------------------------------------------- BUSCA conf-filtered memory --
    @property
    def tlwh_mem(self) -> List[np.ndarray]:
        """Only the memory entries whose admission confidence clears the BUSCA
        threshold (deep_sort/track.py:177-188)."""
        return [
            b
            for b, c in zip(self._tlwh_mem, self.conf_mem)
            if c >= self.conf_threshold
        ]

    @property
    def images_mem(self) -> List[np.ndarray]:
        return [
            im
            for im, c in zip(self._images_mem, self.conf_mem)
            if c >= self.conf_threshold and im is not None
        ]

    # ---------------------------------------------------------------- states --
    def predict(self):
        m, c = _KF.predict(self.mean[None], self.covariance[None])
        self.mean, self.covariance = m[0], c[0]
        self.age += 1
        self.time_since_update += 1

    def apply_camera_motion(self, warp_matrix: np.ndarray):
        """Warp the full box through the 2x3 matrix (deep_sort/track.py:220-230
        warps both corners, unlike the ByteTrack position-only variant)."""
        x1, y1, x2, y2 = self.tlbr
        p1 = warp_matrix @ np.array([x1, y1, 1.0])
        p2 = warp_matrix @ np.array([x2, y2, 1.0])
        w, h = p2[0] - p1[0], p2[1] - p1[1]
        self.mean[:4] = [p1[0] + w / 2, p1[1] + h / 2, w / h, h]

    @staticmethod
    def multi_update_posterior(triples, nsa=True):
        """Batched Kalman posterior for ``(track, xyah, confidence)`` triples
        — one stacked ``HostKalman.update`` (bit-identical per slice)
        replacing per-track calls whose numpy small-matrix overhead
        dominates the host loop.  Feed results to :meth:`update` via
        ``kf_posterior``."""
        if not triples:
            return []
        means = np.stack([t.mean for t, _, _ in triples])
        covs = np.stack([t.covariance for t, _, _ in triples])
        z = np.stack([np.asarray(x, np.float64) for _, x, _ in triples])
        conf = (
            np.array([c for _, _, c in triples], np.float64) if nsa else None
        )
        m, c = _KF.update(means, covs, z, confidence=conf)
        return list(zip(m, c))

    def update(self, xyah, confidence, feature, image, save_memory=False,
               nsa=True, kf_posterior=None):
        if kf_posterior is None:
            m, c = _KF.update(
                self.mean[None],
                self.covariance[None],
                np.asarray(xyah)[None],
                # NSA Kalman (track.py:242) — off = vanilla DeepSORT noise
                confidence=np.array([confidence]) if nsa else None,
            )
            kf_posterior = (m[0], c[0])
        self.mean, self.covariance = kf_posterior
        if feature is not None:
            f = feature / np.linalg.norm(feature)
            if self.features:
                smooth = self.ema_alpha * self.features[-1] + (1 - self.ema_alpha) * f
                smooth /= np.linalg.norm(smooth)
                self.features = [smooth]
            else:
                self.features = [f]
        self.hits += 1
        self.time_since_update = 0
        self.score = confidence
        if self.state == SSState.Tentative and self.hits >= self._n_init:
            self.state = SSState.Confirmed
        tlwh = np.asarray(xyah).copy()
        tlwh[2] *= tlwh[3]
        tlwh[:2] -= tlwh[2:] / 2
        self._tlwh_mem.append(tlwh)
        self.conf_mem.append(confidence)
        if image is not None:
            if save_memory and confidence < self.conf_threshold:
                self._images_mem.append(None)  # MOT20 leak mitigation
            else:
                self._images_mem.append(image)
            self.image = image
        else:
            self._images_mem.append(None)
        self._mem_ticks.append(self._mem_clock)
        self._mem_clock += 1
        if (self.mem_cap is not None
                and len(self._mem_ticks) > self.mem_cap
                and len(self._images_mem) == len(self.conf_mem)):
            lists, self._mem_ticks, self._mem_stride = compact_mem_lists(
                [self._tlwh_mem, self.conf_mem, self._images_mem],
                self._mem_ticks, self.mem_cap, self._mem_stride,
            )
            self._tlwh_mem, self.conf_mem, self._images_mem = lists

    def mark_missed(self):
        if self.state == SSState.Tentative:
            self.state = SSState.Deleted
        elif self.time_since_update > self._max_age:
            self.state = SSState.Deleted

    def is_confirmed(self):
        return self.state == SSState.Confirmed

    def is_deleted(self):
        return self.state == SSState.Deleted


class NearestNeighborMetric:
    """Budget-capped per-target cosine gallery (DeepSORT nn_matching)."""

    def __init__(self, matching_threshold: float = 0.2, budget: Optional[int] = None):
        self.matching_threshold = matching_threshold
        self.budget = budget
        self.samples: Dict[int, List[np.ndarray]] = {}

    def partial_fit(self, features, targets, active_targets):
        for f, t in zip(features, targets):
            self.samples.setdefault(t, []).append(f)
            if self.budget is not None:
                self.samples[t] = self.samples[t][-self.budget:]
        self.samples = {k: self.samples[k] for k in active_targets if k in self.samples}

    def distance(self, features: np.ndarray, targets: Sequence[int]) -> np.ndarray:
        """[num_targets, num_features] min cosine distance to each gallery."""
        cost = np.zeros((len(targets), len(features)))
        for i, t in enumerate(targets):
            gallery = np.asarray(self.samples.get(t, []))
            if gallery.size == 0 or len(features) == 0:
                cost[i, :] = INFTY_COST
                continue
            sim = gallery @ np.asarray(features).T  # both L2-normalized
            cost[i, :] = (1.0 - sim).min(axis=0)
        return cost


@dataclasses.dataclass
class StrongSortConfig:
    max_iou_distance: float = 0.7
    max_age: int = 30
    n_init: int = 3
    max_cosine_distance: float = 0.45
    nn_budget: Optional[int] = 1
    min_confidence: float = 0.6
    nsa: bool = True  # confidence-scaled measurement noise (NSA Kalman)
    ema: bool = True
    ema_alpha: float = 0.9
    mc: bool = True  # motion-cost fusion
    mc_lambda: float = 0.98
    woc: bool = True  # vanilla (non-cascade) matching
    # BUSCA knobs (config/StrongSORT/*/config_strongsort_*.yml)
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
    reliable_thresh: Optional[Sequence[float]] = None
    crop_hw: Tuple[int, int] = (384, 128)
    # bounded appearance memory for long-stream serving (None = reference
    # semantics: per-track memories grow for the track's life; see
    # trackers/base.py compact_mem_lists and docs/SERVING.md "Long streams")
    mem_cap: Optional[int] = None


class StrongSortTracker:
    """One instance per sequence."""

    def __init__(self, config: StrongSortConfig, assoc_engine=None):
        self.cfg = config
        if config.mem_cap is not None and config.mem_cap < 4:
            raise ValueError(
                f"mem_cap must be >= 4 (recommended >= ~5*seq_len), "
                f"got {config.mem_cap}"
            )
        self.engine = assoc_engine
        self.metric = NearestNeighborMetric(
            config.max_cosine_distance, config.nn_budget
        )
        self.tracks: List[SSTrack] = []
        self._next_id = 1
        self.use_busca = config.use_busca and assoc_engine is not None
        # memory-admission threshold (tracker.py:79-84)
        self.conf_threshold = (
            config.min_confidence + config.minimum_conf_modifier
            if self.use_busca and config.transformer_update_mems_only_first_round
            else 1.0 if not self.use_busca else 0.0
        )

    # ------------------------------------------------------------------ api --
    def predict(self):
        for t in self.tracks:
            t.predict()

    def camera_update(self, warp_matrix: np.ndarray):
        for t in self.tracks:
            t.apply_camera_motion(warp_matrix)

    def update(
        self,
        boxes_tlbr: np.ndarray,
        scores: np.ndarray,
        features: Optional[np.ndarray] = None,
        frame: Optional[np.ndarray] = None,
    ) -> List[SSTrack]:
        """Process one frame (call ``predict()`` first, like DeepSORT).

        Args:
          boxes_tlbr: ``[N, 4]`` detections.
          scores: ``[N]``.
          features: ``[N, F]`` precomputed ReID features (may be None only
            if appearance matching is not used).
          frame: uint8 BGR frame (for BUSCA crops).
        """
        gen = self._update_gen(boxes_tlbr, scores, features, frame)
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
        boxes_tlbr: np.ndarray,
        scores: np.ndarray,
        features: Optional[np.ndarray] = None,
        frame: Optional[np.ndarray] = None,
    ):
        """Deferred-third-round mode: returns the update generator; it yields
        at most one :class:`ThirdRoundRequest` (serviced by the caller via
        ``gen.send((matches, u_track))``) and returns the output tracks via
        ``StopIteration.value``."""
        return self._update_gen(boxes_tlbr, scores, features, frame)

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
        features: Optional[np.ndarray] = None,
        frame: Optional[np.ndarray] = None,
    ):
        cfg = self.cfg
        boxes_tlbr = np.asarray(boxes_tlbr, dtype=np.float64).reshape(-1, 4)
        scores = np.asarray(scores, dtype=np.float64).reshape(-1)
        n = len(boxes_tlbr)
        tlwh = hostmath.tlbr_to_tlwh(boxes_tlbr)
        xyah = hostmath.tlwh_to_xyah(tlwh)

        matches, unmatched_tracks, unmatched_dets = self._match(
            xyah, tlwh, scores, features
        )

        # BUSCA crops for all detections (one crop-op call); the frame goes
        # to the engine's device once and the Kalman-candidate crops reuse it
        det_images = [None] * n
        frame_t = None
        if self.use_busca and cfg.busca_thresh > 0 and frame is not None:
            frame_t = torch.as_tensor(frame).to(self.engine.device)
            if n:
                det_images = self._crops(frame_t, boxes_tlbr)

        # ---- BUSCA third round over unmatched confirmed age-1 tracks --------
        if self.use_busca and cfg.busca_thresh > 0 and frame is not None:
            third_idx = [
                i
                for i in unmatched_tracks
                if self.tracks[i].is_confirmed()
                and self.tracks[i].time_since_update <= 1
            ]
            third_pool = [self.tracks[i] for i in third_idx]
            if third_pool and not self._frame_unreliable(frame):
                kalman_cands = self._kalman_candidates(third_pool, frame_t)
                considered = self._considered_dets(
                    tlwh, scores, features, det_images
                )
                matches3, _ = yield ThirdRoundRequest(
                    third_pool, considered, kalman_cands, cfg.busca_thresh,
                    self._engine_kwargs(), self.engine,
                )
                for it, _prob in matches3:
                    track = third_pool[it]
                    det = kalman_cands[it]
                    if cfg.transformer_update_mems_only_first_round:
                        new_feat = (
                            det.features[-1]
                            if cfg.update_feats_third_round and det.features
                            else (track.features[-1] if track.features else None)
                        )
                        new_img = track._images_mem[-1] if track._images_mem else None
                        new_conf = KALMAN_CANDIDATE_CONF  # stays out of memory
                    else:
                        new_feat = det.features[-1] if det.features else None
                        new_img = det.image
                        new_conf = det.score
                    track.update(
                        det.xyah, new_conf, new_feat, new_img,
                        save_memory=cfg.avoid_memory_leak, nsa=cfg.nsa,
                    )
                    unmatched_tracks.remove(third_idx[it])

        # ---- standard DeepSORT bookkeeping -----------------------------------
        post = SSTrack.multi_update_posterior(
            [(self.tracks[ti], xyah[di], scores[di]) for ti, di in matches],
            nsa=cfg.nsa,
        )
        for (ti, di), kf in zip(matches, post):
            self.tracks[ti].update(
                xyah[di],
                scores[di],
                features[di] if features is not None else None,
                det_images[di],
                save_memory=cfg.avoid_memory_leak,
                nsa=cfg.nsa,
                kf_posterior=kf,
            )
        for ti in unmatched_tracks:
            self.tracks[ti].mark_missed()
        for di in unmatched_dets:
            self._initiate(xyah[di], scores[di],
                           features[di] if features is not None else None,
                           det_images[di])
        self.tracks = [t for t in self.tracks if not t.is_deleted()]

        # refresh the appearance galleries
        active = [t.track_id for t in self.tracks if t.is_confirmed()]
        feats, targets = [], []
        for t in self.tracks:
            if not t.is_confirmed():
                continue
            feats += t.features
            targets += [t.track_id] * len(t.features)
            if not cfg.ema:
                t.features = []
        if feats:
            self.metric.partial_fit(np.asarray(feats), targets, active)
        # output rule of the reference app: confirmed tracks seen within the
        # last frame (deep_sort_app's writer skips time_since_update > 1)
        return [
            t
            for t in self.tracks
            if t.is_confirmed() and t.time_since_update <= 1
        ]

    # ------------------------------------------------------------ internals --
    def _initiate(self, xyah, score, feature, image):
        tr = SSTrack(
            xyah,
            self._next_id,
            self.cfg.n_init,
            self.cfg.max_age,
            feature,
            score,
            image,
            conf_threshold=self.conf_threshold,
            ema_alpha=self.cfg.ema_alpha,
        )
        tr.mem_cap = self.cfg.mem_cap
        self.tracks.append(tr)
        self._next_id += 1

    def _match(self, xyah, tlwh, scores, features):
        cfg = self.cfg
        confirmed = [i for i, t in enumerate(self.tracks) if t.is_confirmed()]
        unconfirmed = [i for i, t in enumerate(self.tracks) if not t.is_confirmed()]

        # appearance association (gated cosine + motion fusion)
        if features is not None and confirmed:
            matches_a, unmatched_a, unmatched_d = self._appearance_match(
                confirmed, xyah, features, list(range(len(xyah)))
            )
        else:
            matches_a, unmatched_a, unmatched_d = (
                [],
                list(confirmed),
                list(range(len(xyah))),
            )

        iou_candidates = unconfirmed + [
            i for i in unmatched_a if self.tracks[i].time_since_update == 1
        ]
        unmatched_a = [
            i for i in unmatched_a if self.tracks[i].time_since_update != 1
        ]
        matches_b, unmatched_b, unmatched_d = self._iou_match(
            iou_candidates, tlwh, unmatched_d
        )
        return (
            matches_a + matches_b,
            list(set(unmatched_a + unmatched_b)),
            unmatched_d,
        )

    def _appearance_match(self, track_indices, xyah, features, det_indices):
        cfg = self.cfg
        targets = [self.tracks[i].track_id for i in track_indices]
        cost = self.metric.distance(
            np.asarray([features[d] for d in det_indices]), targets
        )
        # Mahalanobis gate + motion fusion (linear_assignment.py:200-209)
        gate = hostmath.CHI2INV95[4]
        z = np.asarray([xyah[d] for d in det_indices])
        for row, ti in enumerate(track_indices):
            t = self.tracks[ti]
            gd = _KF.gating_distance(t.mean[None], t.covariance[None], z)[0]
            cost[row, gd > gate] = INFTY_COST
            if cfg.mc:
                cost[row] = cfg.mc_lambda * cost[row] + (1 - cfg.mc_lambda) * gd
        cost[cost > self.metric.matching_threshold] = (
            self.metric.matching_threshold + 1e-5
        )
        return self._assign(cost, track_indices, det_indices,
                            self.metric.matching_threshold)

    def _iou_match(self, track_indices, tlwh, det_indices):
        if not track_indices or not det_indices:
            return [], list(track_indices), list(det_indices)
        t_tlbr = np.stack(
            [self.tracks[i].tlbr for i in track_indices]
        )
        d_tlbr = hostmath.tlwh_to_tlbr(
            np.stack([tlwh[d] for d in det_indices])
        )
        # deep_sort's iou_matching.iou uses the STANDARD convention (no +1;
        # upstream StrongSORT submodule deep_sort/iou_matching.py, wh =
        # max(0, br - tl)) — unlike the ByteTrack family's cython_bbox +1
        # IoU.  At the 0.7 threshold edge the two conventions disagree on
        # whether a coasting track re-attaches (r5 campaign seed 8006,
        # pinned in test_pipeline_fuzz).
        cost = 1.0 - hostmath.iou_matrix_std(t_tlbr, d_tlbr)
        # tracks older than 1 frame are excluded from IoU matching
        for row, ti in enumerate(track_indices):
            if self.tracks[ti].time_since_update > 1:
                cost[row, :] = INFTY_COST
        cost = np.minimum(cost, self.cfg.max_iou_distance + 1e-5)
        return self._assign(
            cost, track_indices, det_indices, self.cfg.max_iou_distance
        )

    @staticmethod
    def _assign(cost, track_indices, det_indices, max_distance):
        """deep_sort ``min_cost_matching`` protocol
        (deep_sort/linear_assignment.py:52-86): the cost matrix arrives
        clamped to ``max_distance + 1e-5``, a FULL Hungarian assignment
        runs on it — clamped over-threshold pairs PARTICIPATE in the
        optimization and can absorb a track/det lane — and pairs above
        ``max_distance`` are discarded afterwards.  This is NOT the
        ByteTrack cost-limit LAP (which prices an unmatched lane at
        limit/2 and can therefore match a pair the reference protocol
        leaves coasting): the r5 extended composed-fuzz campaign found a
        4x4 frame where the two protocols pick different optima (pinned,
        tests/test_pipeline_fuzz.py::test_strongsort_assign_protocol_seed).
        """
        from scipy.optimize import linear_sum_assignment

        cost = np.asarray(cost)
        if cost.size == 0:
            return [], list(track_indices), list(det_indices)
        rows, cols = linear_sum_assignment(cost)
        matches, u_rows, u_cols = [], [], []
        assigned_r, assigned_c = set(), set()
        for r, c in zip(rows, cols):
            if cost[r, c] > max_distance:
                continue
            matches.append((track_indices[r], det_indices[c]))
            assigned_r.add(r)
            assigned_c.add(c)
        u_rows = [track_indices[r] for r in range(len(track_indices))
                  if r not in assigned_r]
        u_cols = [det_indices[c] for c in range(len(det_indices))
                  if c not in assigned_c]
        return matches, u_rows, u_cols

    # ------------------------------------------------------------- BUSCA bits --
    def _considered_dets(self, tlwh, scores, features, det_images):
        cfg = self.cfg
        dets = []
        for i in range(len(tlwh)):
            conf = scores[i]
            if cfg.transformer_update_mems_only_first_round:
                conf = max(conf, self.conf_threshold)  # tracker.py:295-296
            d = SSTrack(
                hostmath.tlwh_to_xyah(tlwh[i]),
                -1,
                self.cfg.n_init,
                self.cfg.max_age,
                features[i] if features is not None else None,
                conf,
                det_images[i],
                conf_threshold=0.0,
            )
            dets.append(d)
        return dets

    def _crops(self, frame: torch.Tensor, boxes_tlbr: np.ndarray):
        """Uint8 BGR crops for the track memories, cut on the frame's
        device."""
        return extract_uint8_crops(
            frame, boxes_tlbr, self.cfg.crop_hw,
            bank=getattr(self.engine, "bank", None), device=frame.device,
        )

    def _kalman_candidates(self, pool, frame):
        cands = []
        boxes = np.array([t.tlbr for t in pool]).reshape(-1, 4)
        crops = self._crops(frame, boxes)
        for t, im in zip(pool, crops):
            # admission conf = the track threshold (tracker.py:149-150)
            cands.append(
                SSTrack(
                    t.xyah, -1, self.cfg.n_init, self.cfg.max_age,
                    None, self.conf_threshold, im, conf_threshold=0.0,
                )
            )
        return cands

    def _third_round(self, pool, considered, kalman_cands, thresh):
        """Shared logic in base.run_third_round (DeepSORT semantics:
        deep_sort/tracker.py:129-189)."""
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

    def _frame_unreliable(self, frame) -> bool:
        if self.cfg.reliable_thresh is None:
            return False
        from busca_tpu_torch.trackers.byte import detection_coverage

        cov = detection_coverage(
            frame, [t for t in self.tracks if t.is_confirmed()]
        )
        p = self.cfg.reliable_thresh
        return not (
            cov["area_covered"] > cov["area_covered_per_obj"] * p[0] + p[1]
        )
