"""Track state machine and the shared third-round machinery (port of
``busca_tpu.trackers.base``).

One ``Track`` class serves every adapter strategy (SURVEY.md §7.1.5) — the
reference forks its track class per tracker (STrack, deep_sort Track, GHOST
Track); here the shared memory/geometry machinery lives in one place and the
strategies differ only in their association loops.

Behavioral contract follows the canonical ByteTrack adapter
(adapters/ByteTrack/yolox/tracker/byte_tracker.py:23-192):

- state machine New -> Tracked -> Lost -> Removed.
- appearance memory ``images_mem`` (uint8 BGR crops) and ``tlwh_mem`` grow on
  gated updates (``update_mems``).
- Kalman state in xyah; ``predict`` zeroes the h-velocity for non-tracked
  tracks (byte_tracker.py:44-48).
- ``scale``: memories are stored in original-image coordinates; the detector
  coordinate scale is carried per track (byte_tracker.py:34).
"""

from __future__ import annotations

import dataclasses as _dataclasses
import threading
from typing import List, Optional

import numpy as np

from busca_tpu_torch.core import hostmath
from busca_tpu_torch.utils import profiling

_KF = hostmath.HostKalman()


class TrackState:
    New = 0
    Tracked = 1
    Lost = 2
    Removed = 3


def compact_mem_lists(lists, ticks, cap, stride):
    """Two-region bounded-memory compaction shared by the track classes
    (base ``Track``, StrongSORT's ``SSTrack``, GHOST's ``GhostTrack``).

    Keeps the DENSE TAIL — the most recent ``cap//2`` admissions, so the
    freshest stored entry is always the latest admission — plus an
    even-stride ARCHIVE of the older history (admission indices ≡ 0 mod
    ``stride``; index 0 = birth always survives).  The stride doubles
    until the archive fits its share with headroom, so compaction is
    amortized O(1) per admission.

    Args:
      lists: parallel per-entry lists (boxes/crops/confs), equal length.
      ticks: admission index per entry (aligned with ``lists``).
      cap: max entries to keep; no-op while ``len(ticks) <= cap``.
      stride: current archive stride (monotone, returned possibly doubled).

    Returns:
      ``(new_lists, new_ticks, new_stride)`` — fresh list objects.
    """
    if len(ticks) <= cap:
        return lists, ticks, stride
    tail_n = max(cap // 2, 1)
    headroom = max(cap // 4, 1)
    old_budget = max(cap - tail_n - headroom, 1)
    split = len(ticks) - tail_n
    old = ticks[:split]
    s = stride
    while sum(1 for t in old if t % s == 0) > old_budget:
        s *= 2
    keep = [i for i, t in enumerate(old) if t % s == 0]
    keep.extend(range(split, len(ticks)))
    return (
        [[lst[i] for i in keep] for lst in lists],
        [ticks[i] for i in keep],
        s,
    )


class IdCounter:
    """Thread-safe track-id mint with snapshot support.

    Minting is atomic, and ``peek``/``advance_to`` cannot race a
    concurrent ``next()`` (a server that mints ids from several threads
    while another takes a snapshot would otherwise mint one id twice)."""

    __slots__ = ("_lock", "_next")

    def __init__(self, start: int = 1):
        self._lock = threading.Lock()
        self._next = int(start)

    def __next__(self) -> int:
        with self._lock:
            v = self._next
            self._next += 1
            return v

    def __iter__(self):
        return self

    def peek(self) -> int:
        """The id the next ``next()`` will mint (nothing is consumed)."""
        with self._lock:
            return self._next

    def advance_to(self, at_least: int):
        """Never-regress: ensure future ids are >= ``at_least``."""
        with self._lock:
            if at_least > self._next:
                self._next = int(at_least)


class Track:
    _count = IdCounter(1)

    def __init__(
        self,
        tlwh: np.ndarray,
        score: float,
        image: Optional[np.ndarray] = None,
        scale: float = 1.0,
    ):
        self._tlwh = np.asarray(tlwh, dtype=np.float64)
        self.score = float(score)
        self.scale = scale
        self.mean: Optional[np.ndarray] = None  # [8]
        self.covariance: Optional[np.ndarray] = None  # [8, 8]
        self.is_activated = False
        self.state = TrackState.New
        self.tracklet_len = 0
        self.track_id = 0
        self.frame_id = 0
        self.start_frame = 0

        self.tlwh_mem: List[np.ndarray] = [self._tlwh.copy()]
        self.images_mem: List[np.ndarray] = []
        self.conf_mem: List[float] = [self.score]
        if image is not None:
            self.images_mem.append(image)

        # Bounded appearance memory (opt-in, None = reference semantics:
        # memories grow for the track's whole life,
        # byte_tracker.py:150-156).  For long-stream serving a live track
        # otherwise accumulates ~150 KB/frame of crops; with ``mem_cap`` set
        # the memory holds at most ``mem_cap`` entries in two regions:
        # a DENSE TAIL of the most recent ``mem_cap//2`` admissions (so the
        # freshest stored crop is always the latest admission — zero
        # staleness for the last-seq_len sampler) and an even-stride
        # ARCHIVE of the older history (admission indices that are
        # multiples of ``_mem_stride``; the birth entry, index 0, is always
        # retained, so the stored span is the track's whole life — what the
        # broader-memory sampler consumes, assoc/engine._get_track_mem).
        # The stride doubles as the history outgrows the archive's share.
        # A deviation from the reference; use mem_cap >= ~5*seq_len.
        self.mem_cap: Optional[int] = None
        self._mem_stride = 1
        self._mem_clock = 0          # next admission index
        self._mem_ticks: List[int] = []  # admission index per stored entry

    # ----------------------------------------------------------- geometry --
    @property
    def tlwh(self) -> np.ndarray:
        if self.mean is None:
            return self._tlwh.copy()
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
    def end_frame(self) -> int:
        return self.frame_id

    @staticmethod
    def next_id() -> int:
        return next(Track._count)

    @staticmethod
    def reset_id_counter():
        Track._count = IdCounter(1)

    # -------------------------------------------------------------- kalman --
    def predict(self):
        mean_state = self.mean.copy()
        if self.state != TrackState.Tracked:
            mean_state[7] = 0
        m, c = _KF.predict(mean_state[None], self.covariance[None])
        self.mean, self.covariance = m[0], c[0]

    @staticmethod
    def multi_predict(tracks: List["Track"]):
        """Batched Kalman predict over a track pool (byte_tracker.py:50-61)."""
        if not tracks:
            return
        means = np.stack([t.mean for t in tracks])
        covs = np.stack([t.covariance for t in tracks])
        for i, t in enumerate(tracks):
            if t.state != TrackState.Tracked:
                means[i, 7] = 0
        means, covs = _KF.predict(means, covs)
        for i, t in enumerate(tracks):
            t.mean, t.covariance = means[i], covs[i]

    # ---------------------------------------------------------- transitions --
    def activate(self, frame_id: int):
        self.track_id = self.next_id()
        m, c = _KF.initiate(hostmath.tlwh_to_xyah(self._tlwh)[None])
        self.mean, self.covariance = m[0], c[0]
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        if frame_id == 1:
            self.is_activated = True
        self.frame_id = frame_id
        self.start_frame = frame_id

    @staticmethod
    def multi_update_posterior(pairs):
        """Batched Kalman posterior for matched ``(track, detection)`` pairs.

        One stacked ``HostKalman.update`` replaces len(pairs) per-track
        calls — numpy's per-call overhead on the tiny 8x8 systems dominates
        the host tracker otherwise (the batched LAPACK/einsum path is
        bit-identical per slice).  Pass each returned ``(mean, cov)`` to
        :meth:`update` / :meth:`re_activate` via ``kf_posterior``.
        """
        if not pairs:
            return []
        means = np.stack([t.mean for t, _ in pairs])
        covs = np.stack([t.covariance for t, _ in pairs])
        z = np.stack([hostmath.tlwh_to_xyah(d.tlwh) for _, d in pairs])
        m, c = _KF.update(means, covs, z)
        return list(zip(m, c))

    def re_activate(self, new_track: "Track", frame_id: int, new_id=False,
                    update_mems=True, kf_posterior=None):
        if kf_posterior is None:
            m, c = _KF.update(
                self.mean[None],
                self.covariance[None],
                hostmath.tlwh_to_xyah(new_track.tlwh)[None],
            )
            kf_posterior = (m[0], c[0])
        self.mean, self.covariance = kf_posterior
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = True
        self.frame_id = frame_id
        if new_id:
            self.track_id = self.next_id()
        self.score = new_track.score
        self.scale = new_track.scale
        self._extend_mems(new_track, update_mems)

    def update(self, new_track: "Track", frame_id: int, update_mems=True,
               kf_posterior=None):
        self.frame_id = frame_id
        self.tracklet_len += 1
        if kf_posterior is None:
            m, c = _KF.update(
                self.mean[None],
                self.covariance[None],
                hostmath.tlwh_to_xyah(new_track.tlwh)[None],
            )
            kf_posterior = (m[0], c[0])
        self.mean, self.covariance = kf_posterior
        self.state = TrackState.Tracked
        self.is_activated = True
        self.score = new_track.score
        self.scale = new_track.scale
        self._extend_mems(new_track, update_mems)

    def _extend_mems(self, new_track: "Track", update_mems: bool):
        """Append the new detection's memory entries.

        A BUSCA memory entry is a (crop, box, conf) TRIPLE consumed by
        index (assoc/engine._get_track_mem pairs ``images_mem[i]`` with
        ``tlwh_mem[i]``), so once this track carries crops the three lists
        must stay in lockstep: an imageless frame (e.g. a failed imread) is
        dropped from memory rather than appended box-only, and the first
        crop after an imageless birth trims the unpaired box history."""
        if not update_mems:
            return
        has_img = bool(new_track.images_mem)
        if self.images_mem and not has_img:
            return
        n_new = len(new_track.tlwh_mem)
        if n_new:
            self.tlwh_mem.extend(new_track.tlwh_mem)
            self.conf_mem.extend(new_track.conf_mem)
        if has_img:
            self.images_mem.extend(new_track.images_mem)
            excess = len(self.tlwh_mem) - len(self.images_mem)
            if excess > 0:
                del self.tlwh_mem[:excess]
                del self.conf_mem[:excess]
                if self._mem_ticks:
                    del self._mem_ticks[:excess]
        if self.mem_cap is not None and n_new:
            if len(self._mem_ticks) != len(self.tlwh_mem) - n_new:
                # cap engaged mid-life (or after an excess trim): treat the
                # existing history as consecutive admissions
                self._mem_ticks = list(
                    range(len(self.tlwh_mem) - n_new)
                )
                self._mem_clock = len(self._mem_ticks)
            for _ in range(min(n_new, len(self.tlwh_mem)
                               - len(self._mem_ticks))):
                self._mem_ticks.append(self._mem_clock)
                self._mem_clock += 1
            self._compact_mems()

    def _compact_mems(self):
        """Bound the memory lists at ``mem_cap`` entries via the shared
        :func:`compact_mem_lists` (dense recent tail + even-stride archive,
        birth always retained)."""
        cap = self.mem_cap
        if cap is None or len(self.tlwh_mem) <= cap:
            return
        if self.images_mem and len(self.images_mem) != len(self.tlwh_mem):
            # transient imageless-birth misalignment: compact after the
            # first crop re-aligns the triple (_extend_mems trims it)
            return
        lists = [self.tlwh_mem, self.conf_mem]
        if self.images_mem:
            lists.append(self.images_mem)
        lists, self._mem_ticks, self._mem_stride = compact_mem_lists(
            lists, self._mem_ticks, cap, self._mem_stride
        )
        self.tlwh_mem, self.conf_mem = lists[0], lists[1]
        if len(lists) > 2:
            self.images_mem = lists[2]

    def mark_lost(self):
        self.state = TrackState.Lost

    def mark_removed(self):
        self.state = TrackState.Removed

    # ------------------------------------------------------- camera motion --
    def apply_camera_motion(self, warp_matrix: np.ndarray):
        """Warp the track position by a 2x3 motion matrix
        (byte_tracker.py:123-138)."""
        if self.mean is None:
            pos = self._tlwh[:2].copy()
        else:
            pos = self.mean[:2].copy()
        pos = pos * self.scale
        p = warp_matrix @ np.array([pos[0], pos[1], 1.0])
        new_pos = p[:2] / self.scale
        if self.mean is None:
            self._tlwh[:2] = new_pos
        else:
            self.mean[:2] = new_pos

    def __repr__(self):
        return f"OT_{self.track_id}_({self.start_frame}-{self.end_frame})"


# ------------------------------------------------------------- pool algebra --

def joint_tracks(a: List[Track], b: List[Track]) -> List[Track]:
    seen = {}
    res = []
    for t in a:
        seen[t.track_id] = 1
        res.append(t)
    for t in b:
        if not seen.get(t.track_id, 0):
            seen[t.track_id] = 1
            res.append(t)
    return res


def sub_tracks(a: List[Track], b: List[Track]) -> List[Track]:
    pool = {t.track_id: t for t in a}
    for t in b:
        pool.pop(t.track_id, None)
    return list(pool.values())


def remove_duplicate_tracks(a: List[Track], b: List[Track]):
    """Drop the younger of near-duplicate (IoU > 0.85) track pairs
    (byte_tracker.py:685-698)."""
    if not a or not b:
        return a, b
    pdist = hostmath.iou_distance(
        np.stack([t.tlbr for t in a]), np.stack([t.tlbr for t in b])
    )
    pairs = np.where(pdist < 0.15)
    dup_a, dup_b = set(), set()
    for p, q in zip(*pairs):
        time_a = a[p].frame_id - a[p].start_frame
        time_b = b[q].frame_id - b[q].start_frame
        if time_a > time_b:
            dup_b.add(q)
        else:
            dup_a.add(p)
    return (
        [t for i, t in enumerate(a) if i not in dup_a],
        [t for i, t in enumerate(b) if i not in dup_b],
    )


# ---------------------------------------------------------------------------
# Shared third-round (BUSCA) machinery
# ---------------------------------------------------------------------------

# The Kalman pseudo-detection confidence: barely above the 0.1 second-round
# floor (byte_tracker.py:468) — affects downstream memory admission.  Shared
# by every strategy (byte/strongsort/ghost re-export it).
KALMAN_CANDIDATE_CONF = 0.10000001


def host_frame(frame) -> np.ndarray:
    """A frame as a host array: a tensor (a frame on a device) is copied
    back; CMC's ECC runs on the host."""
    import torch

    if torch.is_tensor(frame):
        return frame.cpu().numpy()
    return np.asarray(frame)


def device_crops(frame, boxes_tlbr, crop_hw, device="cuda"):
    """Uint8-valued BGR crops ``[N, h, w, 3]`` (float32) of a batch of boxes
    on ``device``: one crop-op call (kernel K1 on a CUDA device) replacing
    the reference's per-box cv2 loop.

    ``frame``: uint8 BGR ``[H, W, 3]``, numpy or a tensor (moved to
    ``device`` if it is not there).
    """
    import torch

    from busca_tpu_torch.ops.crop import crop_resize_normalize

    frame_t = torch.as_tensor(frame).to(device)
    boxes = torch.as_tensor(
        np.asarray(boxes_tlbr, dtype=np.float32).reshape(-1, 4)
    ).to(frame_t.device)
    return crop_resize_normalize(
        frame_t, boxes, crop_hw, normalize=False, bgr_input=True,
        rgb_output=False, quantize_uint8=True,
    )


def host_crops(crops_dev, bank=None) -> List[np.ndarray]:
    """Host uint8 copies of :func:`device_crops`' output for the track
    memories.  With a :class:`~busca_tpu_torch.assoc.bank.DeviceCropBank`
    the device crops are also copied into the bank before the host fetch,
    and the returned host mirrors carry their unit ids."""
    import torch

    from busca_tpu_torch.assoc.bank import next_uid, tag

    n = crops_dev.shape[0]
    if bank is not None:
        uids = bank.put_device(crops_dev, n)
    else:
        uids = [next_uid() for _ in range(n)]
    crops = crops_dev.to(torch.uint8).cpu().numpy()
    return [tag(crops[i], uids[i]) for i in range(n)]


def extract_uint8_crops(frame, boxes_tlbr, crop_hw, bank=None,
                        device="cuda") -> List[np.ndarray]:
    """Uint8 BGR ReID crops for a batch of boxes, on the host
    (:func:`device_crops` then :func:`host_crops`).  Normalization happens
    later in the association engine."""
    if frame is None or len(boxes_tlbr) == 0:
        return []
    with profiling.span("tracker.crops"):
        return host_crops(device_crops(frame, boxes_tlbr, crop_hw, device),
                          bank)


def run_third_round(
    engine,
    pool,
    considered,
    kalman_cands,
    thresh: float,
    *,
    use_broader_memory: bool = True,
    select_highest_candidate: bool = True,
    highest_candidate_minimum_thresh=None,
    keep_highest_value: bool = False,
):
    """The BUSCA third association round, shared by all strategies.

    A track survives iff its own Kalman candidate wins with probability >
    ``thresh`` (byte_tracker.py:481-532; deep_sort/tracker.py:129-189;
    GHOST src/tracker.py:501-567 — the ``recover_only_kalman`` semantics).

    Returns ``(matches, u_track)`` with matches as ``[track_idx, prob]``.
    """
    if thresh <= 0.0 or not pool:
        return [], list(range(len(pool)))
    dist_fn = getattr(engine, "center_distances", None) or getattr(
        engine, "_center_distances"
    )
    dists = dist_fn(pool, considered)
    probs, reliable = engine.associate(
        pool,
        considered,
        dists,
        use_broader_memory=use_broader_memory,
        select_highest_candidate=select_highest_candidate,
        highest_candidate_minimum_thresh=highest_candidate_minimum_thresh,
        keep_highest_value=keep_highest_value,
        extra_kalman_candidates=kalman_cands,
    )
    return select_third_round_matches(probs, reliable, len(considered),
                                      len(pool), thresh)


def select_third_round_matches(probs, reliable, n_dets, n_pool, thresh):
    """Third-round tail: a track survives iff its own Kalman candidate's
    probability (column ``n_dets + i``) clears ``thresh`` and the track's
    memory is reliable (byte_tracker.py:505-529)."""
    if probs is None or probs.shape[1] < n_dets + n_pool:
        # no Kalman-candidate columns (e.g. crops unavailable): nothing can
        # clear the recover-only-kalman rule
        return [], list(range(n_pool))
    matches, u_track = [], []
    for i in range(n_pool):
        p = probs[i, n_dets + i]
        if reliable[i] and p > thresh:
            matches.append([i, p])
        else:
            u_track.append(i)
    return matches, u_track


@_dataclasses.dataclass
class ThirdRoundRequest:
    """A suspended third-round association (deferred mode).

    A tracker's ``update_deferred`` generator yields one of these at its
    Step-3b point; the lockstep drivers batch every sequence's request into
    one model call (:func:`service_deferred_updates`, per-request BN groups)
    and send ``(matches, u_track)`` back into the generator.
    """

    pool: list
    considered: list
    kalman_cands: list
    thresh: float
    engine_kwargs: dict
    engine: object = None  # the yielding tracker's association engine


def service_deferred_updates(pending):
    """Finish a batch of suspended tracker updates.

    ``pending``: ``(key, generator, ThirdRoundRequest)`` each.  The requests
    are grouped by engine, each group is served by one batched association
    (:func:`run_third_round_many`), and each result is sent back into its
    generator, which is driven to its end.  Returns ``{key: output}``.
    """
    outputs = {}
    by_engine = {}
    for p in pending:
        by_engine.setdefault(id(p[2].engine), []).append(p)
    for group in by_engine.values():
        outs = run_third_round_many(group[0][2].engine,
                                    [p[2] for p in group])
        for (key, gen, _), res in zip(group, outs):
            # a follow-up yield is served on its own, as update() would
            while True:
                try:
                    req = gen.send(res)
                except StopIteration as e:
                    outputs[key] = e.value
                    break
                res = run_third_round(req.engine, req.pool, req.considered,
                                      req.kalman_cands, req.thresh,
                                      **req.engine_kwargs)
    return outputs


def run_third_round_many(engine, requests):
    """Serve a batch of :class:`ThirdRoundRequest`\\ s with one batched
    association (``engine.associate_many``).  The requests must share their
    ``engine_kwargs`` (lockstep sequences share one tracker config); those
    with a disabled threshold or an empty pool never reach the device, as in
    :func:`run_third_round`.  Returns ``(matches, u_track)`` per request."""
    if not requests:
        return []
    if not hasattr(engine, "associate_many"):
        # stub engines: one request at a time
        return [run_third_round(engine, r.pool, r.considered,
                                r.kalman_cands, r.thresh, **r.engine_kwargs)
                for r in requests]
    kw = requests[0].engine_kwargs
    if any(r.engine_kwargs != kw for r in requests[1:]):
        raise ValueError("batched third round needs uniform engine kwargs")
    active = [r for r in requests if r.thresh > 0.0 and r.pool]
    dist_fn = getattr(engine, "center_distances", None) or getattr(
        engine, "_center_distances", None)
    assoc_reqs = [
        (r.pool, r.considered,
         dist_fn(r.pool, r.considered)
         if (r.considered or r.kalman_cands) else None,
         r.kalman_cands)
        for r in active
    ]
    outs = engine.associate_many(assoc_reqs, **kw) if assoc_reqs else []
    by_active = {id(r): out for r, out in zip(active, outs)}
    results = []
    for r in requests:
        out = by_active.get(id(r))
        if out is None:
            results.append(([], list(range(len(r.pool)))))
        else:
            probs, reliable = out
            results.append(select_third_round_matches(
                probs, reliable, len(r.considered), len(r.pool), r.thresh))
    return results
