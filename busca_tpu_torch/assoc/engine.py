"""The association engine — ``BUSCA.associate_embeddings`` (port of
``busca_tpu.assoc.engine``, batch mode).

The single entry point of the third association round (busca/network.py:
282-429).  Given unmatched tracks and the frame's considered detections it
returns a ``[T, D(+T)]`` probability matrix plus a per-track reliability
flag.  The tensor work (normalize, ReID, Transformer, softmax) is one model
call per power-of-two track bucket on the engine's device; padded lanes
carry ``sample_mask=0`` and stay out of the ReID BN statistics.  Memory and
candidate selection stays on the host.

Reference semantics kept:
- memory sampling incl. ``use_broader_memory`` even-stride re-sampling
  (network.py:247-279) and the ``track.scale`` rescale;
- incomplete memories -> zero crops + dummy ``[250, 250, 500, 500]`` boxes,
  flagged unreliable (network.py:300-308);
- candidates: ``num_candidates`` nearest detections by center distance;
  missing slots -> zero crop + the ltwh sentinel box (network.py:329-355);
- the Kalman candidate replaces slot ``min(len(dets), C-1)`` with index
  ``D + t`` in the output matrix (network.py:363-380);
- the one-hot post-processing (network.py:415-422).

The model computes in ``config.dtype`` (busca_tpu's ``AssociationEngine``
builds its model from the config); the crops are prepared in float32 and
the ReID casts them at its entry (busca_tpu/models/reid.py:225).

:meth:`AssociationEngine.associate_many` scores several independent
requests (one per lockstep sequence) in one model call, with BN statistics
per request, so each request's numbers equal its own :meth:`associate`.

``reid_stats='frozen'`` is the opt-in serving deviation of busca_tpu
(PARITY.md "Frozen-stats ReID"): BN normalizes with the stored running
statistics, so a crop's feature does not depend on its batch and is cached
across frames by crop uid, in a ``[cap, F]`` float32 feature bank on the
engine's device (``feat_bank=True``) or on the host.  A third round then
encodes only the frame's new crops.  ``'auto'`` has the same numbers and
scores calls of at most ``auto_fused_max_t`` tracks in one fused forward.

``debug_dir`` writes the decision montage of each scored call (the
reference's visualization, network.py:234-242): the tracks' memory crops
beside their candidate crops with the predicted probabilities, as
``<debug_dir>/decision_%06d.jpg`` (``viz/draw.py::create_batch_image``).
The montage needs every candidate crop of the call on the host, so with it
a call takes the duplicated-candidate path (no dedup, no crop bank), as in
busca_tpu; frozen modes refuse it.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from busca_tpu_torch.core import hostmath
from busca_tpu_torch.models import encodings
from busca_tpu_torch.models.busca import (
    INPUT_PIXEL_MEAN_BGR,
    INPUT_PIXEL_STD_BGR,
    BuscaConfig,
    BuscaModel,
)
from busca_tpu_torch.models.reid import BatchNorm
from busca_tpu_torch.utils import profiling
from busca_tpu_torch.utils.padding import next_pow2

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)
# reid_stats='auto': at or below this per-call track count one fused forward
# scores the call; above it, the cached path (encode the new crops, then
# score from features).  busca_tpu's constant (busca_tpu/assoc/engine.py:57),
# chosen there on a TPU; chip_smoke.py phase 15 measures the card's own
# crossover.  Frozen BN numerics either way.
AUTO_FUSED_MAX_T = 1
INCOMPLETE_MEM_BBOX_TLWH = np.array([250.0, 250.0, 500.0, 500.0])


def _get_track_mem(track, seq_len: int, use_broader_memory: bool):
    """Memory sampling (network.py:247-279). Returns (crops list, ltwh [L,4])."""
    full = track.images_mem
    n = len(full)
    if use_broader_memory and n >= seq_len and seq_len > 1:
        sep = float(n - 1) / float(seq_len - 1)
        idx = [int(i * sep) for i in range(seq_len)]
        crops = [full[i] for i in idx]
        bboxes = [track.tlwh_mem[i] for i in idx]
    else:
        crops = full[-seq_len:]
        bboxes = track.tlwh_mem[-seq_len:]
    bboxes = np.array(bboxes, dtype=np.float64) * track.scale
    return crops, bboxes


def _dedup_gather(det_inds, start, end, c, b, unit_crop):
    """Unique-candidate bookkeeping of the dedup scorers: maps each (track,
    candidate slot) to a unique crop index (0 = the zero/missing crop) and
    counts slot occurrences as the BN multiplicity weights.  Returns
    (gather [b, c] int32, weights list, crops list with crops[0] = None)."""
    unit_to_idx = {}
    gather = np.zeros((b, c), dtype=np.int32)
    weights = [0.0]
    crops_list = [None]
    for ti in range(start, end):
        for ci, di in enumerate(det_inds[ti]):
            if di is None:
                weights[0] += 1.0
                continue
            if di not in unit_to_idx:
                unit_to_idx[di] = len(crops_list)
                crops_list.append(unit_crop(di))
                weights.append(0.0)
            ui = unit_to_idx[di]
            gather[ti - start, ci] = ui
            weights[ui] += 1.0
    return gather, weights, crops_list


def _padded(x: np.ndarray, start: int, end: int, pad: int) -> np.ndarray:
    if pad == 0:
        return x[start:end]
    return np.pad(x[start:end], [(0, pad)] + [(0, 0)] * (x.ndim - 1))


class AssociationEngine:
    """Bucketed BUSCA association on one device."""

    def __init__(
        self,
        config: BuscaConfig,
        model: BuscaModel,
        seq_len: int = 11,
        num_candidates: int = 5,
        crop_hw: Tuple[int, int] = (384, 128),
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        debug_dir: Optional[str] = None,
        dedup_candidates: bool = True,
        bank=None,
        reid_stats: str = "batch",
        feat_cache_slots: int = 16384,
        feat_bank: bool = True,
        auto_fused_max_t: int = AUTO_FUSED_MAX_T,
    ):
        if reid_stats not in ("batch", "frozen", "auto"):
            raise ValueError(f"reid_stats must be 'batch', 'frozen' or "
                             f"'auto', got {reid_stats!r}")
        frozen = reid_stats in ("frozen", "auto")
        if frozen:
            # busca_tpu refuses variables without 'batch_stats' and rebuilds
            # its model with reid_use_batch_stats=False; the port takes the
            # built module and never flips the BN mode of a module another
            # engine may share, so it refuses a batch-statistics ReID
            if any(m.use_batch_stats for m in model.modules()
                   if isinstance(m, BatchNorm)):
                raise ValueError(
                    f"reid_stats={reid_stats!r} needs a model whose "
                    "BatchNorm uses its running statistics (batch_stats): "
                    "build it with BuscaConfig(reid_use_batch_stats=False) "
                    "and load them (a reference .pth, an .npz's "
                    "batch_stats, or eval/frozen_delta.py::"
                    "calibrate_batch_stats)")
            if debug_dir is not None:
                raise ValueError("the decision montage is not supported with "
                                 f"reid_stats={reid_stats!r} (use the "
                                 "default batch mode)")
            config = dataclasses.replace(config, reid_use_batch_stats=False)
        if bank is not None and tuple(bank.crop_hw) != tuple(crop_hw):
            raise ValueError("bank crop_hw mismatch")
        if model.config.dtype != config.dtype:
            raise ValueError(f"the model computes in {model.config.dtype}, "
                             f"the config says {config.dtype}")
        self.reid_stats = reid_stats
        self.auto_fused_max_t = int(auto_fused_max_t)
        self.config = config
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.seq_len = seq_len
        self.num_candidates = num_candidates
        self.crop_hw = tuple(crop_hw)
        self.buckets = tuple(sorted(buckets))
        self.bank = bank
        # Deduplicated candidate ReID: tracks share one detection pool, so
        # the [T, C] candidate batch is mostly repeats — ReID runs once per
        # unique crop with multiplicity-weighted BN statistics (numerics
        # equal to the duplicated batch).
        self.dedup_candidates = dedup_candidates
        self.debug_dir = debug_dir
        self._debug_count = 0
        self._mean = torch.tensor(INPUT_PIXEL_MEAN_BGR.tolist(),
                                  device=self.device)
        self._std = torch.tensor(INPUT_PIXEL_STD_BGR.tolist(),
                                 device=self.device)
        self._255 = torch.full((), 255.0, device=self.device)
        if frozen:
            # uid-keyed LRU of encoded features: with the device feature
            # bank it maps (uid, normalize) -> a row of the [cap, F] bank
            # (16384 x 512 float32 = 32 MB), without it it holds the [F]
            # vectors on the host
            self._feat_cache: OrderedDict = OrderedDict()
            self._feat_cache_cap = int(feat_cache_slots)
            self._zero_crop = np.zeros(self.crop_hw + (3,), np.uint8)
            self._feat_bank = bool(feat_bank)
            if self._feat_bank:
                # slot 0 is scratch: encode-batch padding rows are written
                # there and score-batch padding rows read it (masked lanes;
                # the feature scorer couples no rows)
                self._slot_of: OrderedDict = OrderedDict()
                self._free_slots = list(range(self._feat_cache_cap - 1, 0,
                                              -1))
                self._bank = None  # [cap, F] float32 zeros, made lazily
                self._bank_gen = 0  # bumped by _reset_bank

    @property
    def banked(self) -> bool:
        """Whether scoring ships crop-bank slot indices instead of pixels.
        Frozen modes ship features, never pixels; the debug montage needs
        the pixels on the host."""
        return (self.bank is not None and self.dedup_candidates
                and self.debug_dir is None and self.reid_stats == "batch")

    @property
    def _keep_mem_lists(self) -> bool:
        """Request prep keeps per-track crop LISTS (not one stacked array)
        where a crop's identity matters: the crop bank or the feature
        cache."""
        return self.banked or self.reid_stats in ("frozen", "auto")

    # ------------------------------------------------------------ device --
    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _prep(self, x: torch.Tensor, normalize_ims: bool) -> torch.Tensor:
        """uint8 (or float) BGR HWC crops -> normalized RGB float32."""
        x = x.to(torch.float32)
        if normalize_ims:
            # a device tensor, not a Python scalar: torch on CUDA divides by
            # a scalar as a multiplication by its reciprocal
            x = (x / self._255 - self._mean) / self._std
        return x.flip(-1)  # BGR -> RGB (network.py:396-398)

    def _scores(self, mem_crops, can_crops, mem_boxes, can_boxes, mask,
                normalize_ims, can_weights=None, can_gather=None,
                mem_group=None, can_group=None,
                num_groups=1) -> torch.Tensor:
        """One model call on device tensors: softmax probabilities
        ``[B, C + extras]`` on the device (what
        ``serve/export.py::export_associate_scorer`` traces)."""
        logits = self.model(
            self._prep(mem_crops, normalize_ims),
            self._prep(can_crops, normalize_ims),
            mem_boxes, can_boxes, mask,
            can_weights=can_weights, can_gather=can_gather,
            mem_group=mem_group, can_group=can_group,
            num_groups=num_groups,
        )
        return torch.softmax(logits, dim=-1)

    @torch.inference_mode()
    def _probs(self, mem_crops, can_crops, mem_boxes, can_boxes, mask,
               normalize_ims, can_weights=None, can_gather=None,
               mem_group=None, can_group=None, num_groups=1) -> np.ndarray:
        """One model call; crops are device tensors, the rest numpy.
        Returns softmax probabilities ``[B, C + extras]`` on the host."""

        def opt(x):
            return None if x is None else self._tensor(x)

        if profiling.tracing():
            # a crop is the last three dimensions of either batch
            self._count_call(int(mask.sum()), mem_crops.shape[0],
                             mem_crops.shape[:-3].numel()
                             + can_crops.shape[:-3].numel())
        with profiling.span("assoc.prep"):
            args = (self._tensor(mem_boxes), self._tensor(can_boxes),
                    self._tensor(mask))
            kw = dict(can_weights=opt(can_weights),
                      can_gather=opt(can_gather), mem_group=opt(mem_group),
                      can_group=opt(can_group))
        probs = self._scores(mem_crops, can_crops, *args, normalize_ims,
                             num_groups=num_groups, **kw)
        with profiling.span("assoc.readback"):
            return probs.cpu().numpy()

    @staticmethod
    def _count_call(tracks: int, rows: int, crops: int):
        """The third round's counters at one model call: the tracks it
        scores, the track rows it launches (bucket padding included) and
        the crops through the ReID ResNet-50."""
        profiling.count("assoc.tracks", tracks)
        profiling.count("assoc.rows", rows)
        profiling.count("assoc.crops", crops)

    # --------------------------------------------------------------- api --
    def associate(
        self,
        tracks: Sequence,
        dets: Sequence,
        dists_matrix: Optional[np.ndarray] = None,
        *,
        use_broader_memory: bool = True,
        select_highest_candidate: bool = True,
        highest_candidate_minimum_thresh: Optional[float] = None,
        keep_highest_value: bool = False,
        extra_kalman_candidates: Sequence = (),
        normalize_ims: bool = True,
    ):
        """Returns (probs_matrix [T, D(+T)], reliable [T]) or (None, None)."""
        with profiling.span("assoc.call"):
            with profiling.span("assoc.prep"):
                req = self._prep_request(
                    tracks, dets, dists_matrix,
                    use_broader_memory=use_broader_memory,
                    extra_kalman_candidates=extra_kalman_candidates,
                )
            if req is None:
                return None, None
            probs = self._score_prepped(req, normalize_ims)
            (_, _, reliable, det_inds, _, _, num_available, d_count, _) = req
            with profiling.span("assoc.post"):
                return self._postprocess(
                    probs, reliable, det_inds, num_available,
                    d_count + len(extra_kalman_candidates),
                    select_highest_candidate=select_highest_candidate,
                    highest_candidate_minimum_thresh=(
                        highest_candidate_minimum_thresh),
                    keep_highest_value=keep_highest_value,
                )

    def associate_many(
        self,
        requests: Sequence,
        *,
        use_broader_memory: bool = True,
        select_highest_candidate: bool = True,
        highest_candidate_minimum_thresh: Optional[float] = None,
        keep_highest_value: bool = False,
        normalize_ims: bool = True,
    ):
        """Several independent association calls in one model call.

        ``requests``: ``(tracks, dets, dists_matrix_or_None,
        extra_kalman_candidates)`` each, e.g. one per lockstep sequence.  BN
        statistics are per request (``BuscaModel``'s ``mem_group``), so each
        request's numbers equal its own :meth:`associate` call.  Returns one
        ``(probs_matrix, reliable)`` or ``(None, None)`` per request, in
        order.
        """
        with profiling.span("assoc.call"):
            return self._associate_many(
                requests, normalize_ims, use_broader_memory=use_broader_memory,
                select_highest_candidate=select_highest_candidate,
                highest_candidate_minimum_thresh=(
                    highest_candidate_minimum_thresh),
                keep_highest_value=keep_highest_value)

    def _associate_many(self, requests, normalize_ims, *,
                        use_broader_memory, **post_kw):
        results = [(None, None)] * len(requests)
        preps = []
        with profiling.span("assoc.prep"):
            for i, (tracks, dets, dists, kal) in enumerate(requests):
                req = self._prep_request(
                    tracks, dets, dists,
                    use_broader_memory=use_broader_memory,
                    extra_kalman_candidates=kal,
                )
                if req is not None:
                    preps.append((i, req, len(dets) + len(kal)))
        if not preps:
            return results
        t_total = sum(req[8] for _, req, _ in preps)
        if self.reid_stats == "frozen" or (
                self.reid_stats == "auto"
                and t_total > self.auto_fused_max_t):
            return self._associate_many_frozen(preps, results,
                                               normalize_ims, post_kw)
        if (self.reid_stats == "auto" or len(preps) == 1
                or t_total > self.buckets[-1] or not self.dedup_candidates
                or self.debug_dir is not None):
            # a tiny auto batch (fused per request, as _score_prepped
            # routes it), one live request, a batch above the largest
            # bucket, or the duplicated path (also the montage's): the
            # prepped requests one by one
            # (busca_tpu/assoc/engine.py:636-654)
            for i, req, ndt in preps:
                probs = self._score_prepped(req, normalize_ims)
                (_, _, reliable, det_inds, _, _, num_avail, _, _) = req
                with profiling.span("assoc.post"):
                    results[i] = self._postprocess(
                        probs, reliable, det_inds, num_avail, ndt, **post_kw)
            return results
        probs, rows = self._score_grouped(preps, normalize_ims)
        with profiling.span("assoc.post"):
            for i, row0, t_count, reliable, det_inds, num_avail, ndt in rows:
                results[i] = self._postprocess(
                    probs[row0:row0 + t_count], reliable, det_inds,
                    num_avail, ndt, **post_kw)
        return results

    def _associate_many_frozen(self, preps, results, normalize_ims,
                               post_kw):
        """The frozen branch of :meth:`associate_many`: frozen features
        couple no requests, so the requests are scored as one batch
        (busca_tpu/assoc/engine.py:573-634)."""
        probs = self._frozen_scores([req for _, req, _ in preps],
                                    normalize_ims)
        row = 0
        with profiling.span("assoc.post"):
            for i, req, ndt in preps:
                (_, _, reliable, det_inds, _, _, num_avail, _, t_count) = req
                results[i] = self._postprocess(
                    probs[row:row + t_count], reliable, det_inds, num_avail,
                    ndt, **post_kw)
                row += t_count
        return results

    def _score_grouped(self, preps, normalize_ims):
        """One model call over every prepped request, the track batch
        padded to its bucket and ``next_pow2(r)`` BN groups per kind.  Each
        request has its own unique candidate units and its own zero
        "missing slot" unit, so its weights land in its own group.  Returns
        the raw probabilities and ``(i, row0, t_count, reliable, det_inds,
        num_available, n_cols)`` per request."""
        prep = profiling.begin("assoc.prep")
        seq_len, c = self.seq_len, self.num_candidates
        h, w = self.crop_hw
        t_total = sum(req[8] for _, req, _ in preps)
        b = self._bucket(t_total)
        banked = self.banked
        mem_entries: list = []
        if not banked:
            mem_crops = np.zeros((b, seq_len, h, w, 3), np.uint8)
        mem_boxes = np.zeros((b, seq_len, 4), np.float32)
        can_boxes = np.zeros((b, c, 4), np.float32)
        mask = np.zeros(b, np.float32)
        mem_group = np.zeros(b, np.int64)
        gather = np.zeros((b, c), np.int64)
        uniq_crops: List[Optional[np.ndarray]] = []
        uniq_weights: List[float] = []
        uniq_group: List[int] = []
        spans = []
        row = 0
        for slot, (i, req, ndt) in enumerate(preps):
            (m_crops, m_boxes, reliable, det_inds, c_boxes, unit_crop,
             num_available, _d_count, t_count) = req
            zero_idx = len(uniq_crops)
            uniq_crops.append(None)
            uniq_weights.append(0.0)
            uniq_group.append(slot)
            unit_to_idx = {}
            for ti in range(t_count):
                for ci, di in enumerate(det_inds[ti]):
                    if di is None:
                        uniq_weights[zero_idx] += 1.0
                        gather[row + ti, ci] = zero_idx
                        continue
                    if di not in unit_to_idx:
                        unit_to_idx[di] = len(uniq_crops)
                        uniq_crops.append(unit_crop(di))
                        uniq_weights.append(0.0)
                        uniq_group.append(slot)
                    ui = unit_to_idx[di]
                    gather[row + ti, ci] = ui
                    uniq_weights[ui] += 1.0
            if banked:
                mem_entries.extend(m_crops)
            else:
                mem_crops[row:row + t_count] = m_crops
            mem_boxes[row:row + t_count] = m_boxes
            can_boxes[row:row + t_count] = c_boxes
            mask[row:row + t_count] = 1.0
            mem_group[row:row + t_count] = slot
            spans.append((i, row, t_count, reliable, det_inds,
                          num_available, ndt))
            row += t_count
        u = len(uniq_crops)
        u_pad = next_pow2(u, min_bucket=8)
        w_arr = np.zeros(u_pad, np.float32)
        w_arr[:u] = uniq_weights
        g_arr = np.zeros(u_pad, np.int64)
        g_arr[:u] = uniq_group
        if banked:
            flat: list = []
            for e in mem_entries:
                flat.extend(e if e is not None else [None] * seq_len)
            flat.extend(uniq_crops)  # the zero units resolve to slot 0
            slots = self.bank.resolve(flat)
            n_mem = row * seq_len
            mem_slots = np.zeros((b, seq_len), np.int64)
            mem_slots[:row] = slots[:n_mem].reshape(row, seq_len)
            uniq_slots = np.zeros(u_pad, np.int64)
            uniq_slots[:u] = slots[n_mem:]
            bank = self.bank.array
            mem_t = bank[self._tensor(mem_slots)]
            uniq_t = bank[self._tensor(uniq_slots)]
        else:
            uniq = np.zeros((u_pad, h, w, 3), np.uint8)
            for ui, crop in enumerate(uniq_crops):
                if crop is not None:
                    uniq[ui] = crop
            mem_t, uniq_t = self._tensor(mem_crops), self._tensor(uniq)
        prep.end()
        probs = self._probs(
            mem_t, uniq_t, mem_boxes, can_boxes, mask, normalize_ims,
            can_weights=w_arr, can_gather=gather, mem_group=mem_group,
            can_group=g_arr, num_groups=next_pow2(len(preps)),
        )
        return probs, spans

    def _score_prepped(self, req, normalize_ims) -> np.ndarray:
        """Raw probabilities ``[T, C + extras]`` of one prepped request."""
        (mem_crops, mem_boxes, _reliable, det_inds, can_boxes, unit_crop,
         _num_available, _d_count, t_count) = req
        if self.reid_stats in ("frozen", "auto"):
            return self._score_frozen(mem_crops, mem_boxes, det_inds,
                                      can_boxes, unit_crop, t_count,
                                      normalize_ims)
        if self.banked:
            return self._score_bucketed_unique_b(
                mem_crops, det_inds, unit_crop, mem_boxes, can_boxes,
                normalize_ims,
            )
        if self.dedup_candidates and self.debug_dir is None:
            return self._score_bucketed_unique(
                mem_crops, det_inds, unit_crop, mem_boxes, can_boxes,
                normalize_ims,
            )
        c = self.num_candidates
        h, w = self.crop_hw
        prep = profiling.begin("assoc.prep")
        can_crops = np.zeros((t_count, c, h, w, 3), dtype=np.uint8)
        for ti in range(t_count):
            for ci, di in enumerate(det_inds[ti]):
                if di is not None:
                    can_crops[ti, ci] = unit_crop(di)
        prep.end()
        probs = self._score_bucketed(
            mem_crops, can_crops, mem_boxes, can_boxes, normalize_ims
        )
        if self.debug_dir is not None:
            self._write_debug_montage(mem_crops, can_crops, probs)
        return probs

    def _write_debug_montage(self, mem_crops, can_crops, probs):
        """The decision montage of this call as
        ``<debug_dir>/decision_%06d.jpg`` (network.py:234-242,
        visualization.py ``create_batch_image``)."""
        import os

        import cv2

        from busca_tpu_torch.viz import create_batch_image

        montage = create_batch_image(mem_crops, can_crops, probs)
        os.makedirs(self.debug_dir, exist_ok=True)
        cv2.imwrite(os.path.join(self.debug_dir,
                                 f"decision_{self._debug_count:06d}.jpg"),
                    montage)
        self._debug_count += 1

    def _prep_request(
        self,
        tracks: Sequence,
        dets: Sequence,
        dists_matrix: Optional[np.ndarray] = None,
        *,
        use_broader_memory: bool = True,
        extra_kalman_candidates: Sequence = (),
    ):
        """Host-side request prep.  Returns (mem_crops, mem_boxes, reliable,
        det_inds, can_boxes, unit_crop, num_available, d_count, t_count) or
        None for an empty request."""
        if len(tracks) == 0:
            return None
        if len(dets) == 0 and len(extra_kalman_candidates) == 0:
            return None
        if dists_matrix is None:
            dists_matrix = self.center_distances(tracks, dets)

        seq_len, c = self.seq_len, self.num_candidates
        h, w = self.crop_hw
        t_count = len(tracks)
        d_count = len(dets)

        # mem crops stay per-track host-mirror lists where crop identity
        # matters (None = zero memory)
        keep_lists = self._keep_mem_lists
        if keep_lists:
            mem_crops: list = [None] * t_count
        else:
            mem_crops = np.zeros((t_count, seq_len, h, w, 3), dtype=np.uint8)
        mem_boxes = np.zeros((t_count, seq_len, 4), dtype=np.float64)
        reliable = np.zeros(t_count, dtype=bool)
        for ti, track in enumerate(tracks):
            crops, bboxes = _get_track_mem(track, seq_len, use_broader_memory)
            if len(crops) == seq_len:
                reliable[ti] = True
                mem_crops[ti] = crops if keep_lists else np.stack(crops)
                mem_boxes[ti] = bboxes
            else:
                mem_boxes[ti] = INCOMPLETE_MEM_BBOX_TLWH  # zero crops stay

        can_boxes = np.tile(
            encodings.missing_candidate_bbox("ltwh"), (t_count, c, 1)
        )
        det_inds: List[List[Optional[int]]] = []
        num_available = min(d_count, c)
        for ti in range(t_count):
            order = (np.argsort(dists_matrix[ti])[:c].tolist()
                     if d_count else [])
            order += [None] * (c - len(order))
            det_inds.append(order)
            for ci, di in enumerate(order):
                if di is None:
                    continue
                det = dets[di]
                can_boxes[ti, ci] = (
                    np.asarray(det.tlwh_mem[-1], dtype=np.float64) * det.scale
                )

        if len(extra_kalman_candidates) > 0:
            num_available = min(d_count + 1, c)
            k_slot = min(d_count, c - 1)
            for ti, kdet in enumerate(extra_kalman_candidates):
                det_inds[ti][k_slot] = d_count + ti
                can_boxes[ti, k_slot] = np.asarray(kdet.tlwh) * kdet.scale

        def unit_crop(idx: int) -> np.ndarray:
            """Candidate-unit crop: detection index or d_count+ti = Kalman."""
            if idx < d_count:
                return dets[idx].images_mem[-1]
            return extra_kalman_candidates[idx - d_count].images_mem[-1]

        # tlwh -> ltrb (network.py:391-394)
        mem_boxes = hostmath.tlwh_to_tlbr(mem_boxes).astype(np.float32)
        can_boxes = hostmath.tlwh_to_tlbr(can_boxes).astype(np.float32)
        return (mem_crops, mem_boxes, reliable, det_inds, can_boxes,
                unit_crop, num_available, d_count, t_count)

    @staticmethod
    def _postprocess(
        probs, reliable, det_inds, num_available, num_dets_total,
        *,
        select_highest_candidate: bool = True,
        highest_candidate_minimum_thresh: Optional[float] = None,
        keep_highest_value: bool = False,
    ):
        """Scatter per-track probabilities into the global [T, D(+T)]
        matrix with the one-hot post-processing (network.py:407-429)."""
        t_count = probs.shape[0]
        probs_matrix = np.zeros((t_count, num_dets_total))
        for ti in range(t_count):
            track_probs = probs[ti]
            if select_highest_candidate:
                new = np.zeros_like(track_probs)
                mt = highest_candidate_minimum_thresh
                if mt is None or mt == 0 or track_probs.max() >= mt:
                    new[track_probs.argmax()] = (
                        track_probs.max() if keep_highest_value else 1.0
                    )
                track_probs = new
            inds = det_inds[ti][:num_available]
            probs_matrix[ti, inds] = track_probs[:num_available]
        return probs_matrix, reliable

    def center_distances(self, tracks, dets) -> np.ndarray:
        """Center-distance matrix from track/det current boxes
        (busca/tracking.py:23-60) — the candidate-selection distance."""
        if len(tracks) == 0 or len(dets) == 0:
            return np.zeros((len(tracks), len(dets)))
        a = np.stack([t.tlbr for t in tracks])
        b = np.stack([d.tlbr for d in dets])
        return hostmath.center_distance(a, b)

    def _bucket(self, t: int) -> int:
        for b in self.buckets:
            if t <= b:
                return b
        return self.buckets[-1]

    def _chunks(self, t_count: int):
        """(start, end, bucket, pad, mask) per chunk of at most the largest
        bucket."""
        max_b = self.buckets[-1]
        for start in range(0, t_count, max_b):
            end = min(start + max_b, t_count)
            n = end - start
            b = self._bucket(n)
            mask = np.zeros(b, dtype=np.float32)
            mask[:n] = 1.0
            yield start, end, b, b - n, mask

    def _score_bucketed_unique(self, mem_crops, det_inds, unit_crop,
                               mem_boxes, can_boxes,
                               normalize_ims) -> np.ndarray:
        """Dedup scoring: per chunk, the unique candidate units once (index
        0 = the zero "missing slot" crop, weighted by the number of missing
        slots) and a ``[B, C]`` gather map."""
        c = can_boxes.shape[1]
        h, w = self.crop_hw
        out = []
        for start, end, b, pad, mask in self._chunks(mem_crops.shape[0]):
            prep = profiling.begin("assoc.prep")
            gather, weights, crops_list = _dedup_gather(
                det_inds, start, end, c, b, unit_crop)
            u = len(crops_list)
            u_pad = next_pow2(u, min_bucket=8)
            uniq = np.zeros((u_pad, h, w, 3), dtype=np.uint8)
            for ui, crop in enumerate(crops_list[1:], start=1):
                uniq[ui] = crop
            w_arr = np.zeros(u_pad, dtype=np.float32)
            w_arr[:u] = weights
            mem_t = self._tensor(_padded(mem_crops, start, end, pad))
            uniq_t = self._tensor(uniq)
            prep.end()
            probs = self._probs(
                mem_t, uniq_t,
                _padded(mem_boxes, start, end, pad),
                _padded(can_boxes, start, end, pad),
                mask, normalize_ims, can_weights=w_arr, can_gather=gather,
            )
            out.append(probs[:end - start])
        return np.concatenate(out, axis=0)

    def _score_bucketed_unique_b(self, mem_entries, det_inds, unit_crop,
                                 mem_boxes, can_boxes,
                                 normalize_ims) -> np.ndarray:
        """Banked dedup scoring: one :meth:`DeviceCropBank.resolve` per chunk
        covers the memory crops and the unique candidate units; the crops
        are gathered from the device bank by slot.  Numerics equal
        :meth:`_score_bucketed_unique` (the bank holds the same uint8
        crops)."""
        seq_len = self.seq_len
        c = can_boxes.shape[1]
        out = []
        for start, end, b, pad, mask in self._chunks(len(mem_entries)):
            n = end - start
            prep = profiling.begin("assoc.prep")
            gather, weights, crops_list = _dedup_gather(
                det_inds, start, end, c, b, unit_crop)
            u = len(crops_list)
            u_pad = next_pow2(u, min_bucket=8)
            w_arr = np.zeros(u_pad, dtype=np.float32)
            w_arr[:u] = weights
            flat: list = []
            for ti in range(start, end):
                e = mem_entries[ti]
                flat.extend(e if e is not None else [None] * seq_len)
            flat.extend(crops_list[1:])
            slots = self.bank.resolve(flat)
            mem_slots = np.zeros((b, seq_len), np.int64)
            mem_slots[:n] = slots[: n * seq_len].reshape(n, seq_len)
            uniq_slots = np.zeros(u_pad, np.int64)
            uniq_slots[1:u] = slots[n * seq_len:]
            bank = self.bank.array
            mem_t = bank[self._tensor(mem_slots)]
            uniq_t = bank[self._tensor(uniq_slots)]
            prep.end()
            probs = self._probs(
                mem_t, uniq_t,
                _padded(mem_boxes, start, end, pad),
                _padded(can_boxes, start, end, pad),
                mask, normalize_ims, can_weights=w_arr, can_gather=gather,
            )
            out.append(probs[:n])
        return np.concatenate(out, axis=0)

    def _score_bucketed(self, mem_crops, can_crops, mem_boxes, can_boxes,
                        normalize_ims) -> np.ndarray:
        """Duplicated-candidate scoring, bucket-padded and chunked."""
        out = []
        for start, end, _b, pad, mask in self._chunks(mem_crops.shape[0]):
            with profiling.span("assoc.prep"):
                mem_t = self._tensor(_padded(mem_crops, start, end, pad))
                can_t = self._tensor(_padded(can_crops, start, end, pad))
            probs = self._probs(
                mem_t, can_t,
                _padded(mem_boxes, start, end, pad),
                _padded(can_boxes, start, end, pad),
                mask, normalize_ims,
            )
            out.append(probs[:end - start])
        return np.concatenate(out, axis=0)

    # ------------------------------------------------ frozen-stats scoring --
    def _score_frozen(self, mem_crops, mem_boxes, det_inds, can_boxes,
                      unit_crop, t_count, normalize_ims) -> np.ndarray:
        """Frozen and auto branches of :meth:`_score_prepped`
        (busca_tpu/assoc/engine.py:473-508): ``[T, C + extras]``."""
        if self.reid_stats == "auto" and t_count <= self.auto_fused_max_t:
            # a tiny call: one fused forward (BN on the running statistics
            # there too, so the numbers are the cached path's)
            return self._score_bucketed_unique(
                self._stack_mem_lists(mem_crops), det_inds, unit_crop,
                mem_boxes, can_boxes, normalize_ims)
        return self._frozen_scores(
            [(mem_crops, mem_boxes, None, det_inds, can_boxes, unit_crop,
              None, None, t_count)], normalize_ims)

    def _frozen_scores(self, reqs, normalize_ims) -> np.ndarray:
        """Probabilities of prepped requests' rows, concatenated, from
        cached features: through the device bank (the call's new crops
        encoded and written in one go; a failure rolls the call's keys
        back, and one after the scatter resets the bank, as busca_tpu
        does) or the host cache."""
        ctx = self._new_bank_ctx() if self._feat_bank else None
        mem, can = [], []
        try:
            for m_crops, _, _, det_inds, _, unit_crop, _, _, _ in reqs:
                if ctx is not None:
                    mf, cf = self._frozen_request_slots(
                        m_crops, det_inds, unit_crop, normalize_ims, ctx)
                else:
                    mf, cf = self._frozen_request_feats(
                        m_crops, det_inds, unit_crop, normalize_ims)
                mem.append(mf)
                can.append(cf)
            arrays = (np.concatenate(mem), np.concatenate(can),
                      np.concatenate([r[1] for r in reqs]),
                      np.concatenate([r[4] for r in reqs]))
            if ctx is None:
                return self._score_feats_chunked(*arrays)
            self._flush_fresh(ctx, normalize_ims)
            probs = self._score_bank_chunked(*arrays)
        except Exception:
            if ctx is not None:
                if ctx["flushed"]:
                    self._reset_bank()
                self._rollback_ctx(ctx)
            raise
        self._release_ephemeral(ctx)
        return probs

    @torch.inference_mode()
    def _encode(self, crops: np.ndarray, normalize_ims) -> torch.Tensor:
        """uint8 BGR crops ``[N, h, w, 3]`` -> L2-normalized features
        ``[N, F]`` on the device (BN on the running statistics: each
        crop's feature is its own)."""
        profiling.count("assoc.crops", crops.shape[0])
        _, feats = self.model.reid_encoder.model(
            self._prep(self._tensor(crops), normalize_ims))
        return feats

    @torch.inference_mode()
    def _encode_scatter(self, crops: np.ndarray, slots: np.ndarray,
                        normalize_ims):
        """Encode ``crops`` and write their features into the bank's rows
        ``slots`` in place, on the current stream."""
        feats = self._encode(crops, normalize_ims)
        self._bank.index_copy_(0, self._tensor(slots),
                               feats.to(self._bank.dtype))

    @torch.inference_mode()
    def _score_feats(self, mem_feats, can_feats, mem_boxes, can_boxes,
                     mask) -> torch.Tensor:
        """The decision forward from features ``[B, L, F]`` and ``[B, C,
        F]``: probabilities on the device."""
        logits = self.model(None, None, mem_boxes, can_boxes, mask,
                            mem_feats=mem_feats, can_feats=can_feats)
        return torch.softmax(logits, dim=-1)

    @torch.inference_mode()
    def _score_bank(self, mem_slots, can_slots, mem_boxes, can_boxes,
                    mask) -> torch.Tensor:
        """:meth:`_score_feats` on the bank's rows ``mem_slots [B, L]`` and
        ``can_slots [B, C]``."""
        return self._score_feats(self._bank[mem_slots],
                                 self._bank[can_slots], mem_boxes,
                                 can_boxes, mask)

    def _resolve_feats(self, units, normalize_ims) -> np.ndarray:
        """Host features ``[n, F]`` of ``(uid_or_None, crop_or_None)``
        units.  ``crop=None`` is the zero crop (a missing slot or an
        incomplete memory), cached under uid 0 (network.py:300-308,
        352-355).  Cached uids hit the LRU; the rest are encoded in one
        bucketed call and inserted.  Untagged crops (uid None) are encoded
        every time."""
        out = np.zeros((len(units), self.config.dim_embedding), np.float32)
        cache = self._feat_cache
        enc_crops: list = []
        enc_keys: list = []
        enc_pos: List[List[int]] = []
        pending = {}  # cache key -> row in enc_crops
        for i, (uid, crop) in enumerate(units):
            if crop is None:
                uid, crop = 0, self._zero_crop
            key = None if uid is None else (uid, bool(normalize_ims))
            if key is not None:
                hit = cache.get(key)
                if hit is not None:
                    cache.move_to_end(key)
                    out[i] = hit
                    continue
                j = pending.get(key)
                if j is not None:
                    enc_pos[j].append(i)
                    continue
                pending[key] = len(enc_crops)
            enc_keys.append(key)
            enc_pos.append([i])
            enc_crops.append(crop)
        if enc_crops:
            feats = self._encode(self._crop_batch(enc_crops),
                                 bool(normalize_ims)).cpu().numpy()
            for j, key in enumerate(enc_keys):
                f = feats[j]
                for i in enc_pos[j]:
                    out[i] = f
                if key is not None:
                    cache[key] = f
                    if len(cache) > self._feat_cache_cap:
                        cache.popitem(last=False)
        return out

    def _crop_batch(self, crops) -> np.ndarray:
        """``crops`` stacked into a batch padded with zero crops to
        ``next_pow2(n, 8)`` rows."""
        batch = np.zeros((next_pow2(len(crops), min_bucket=8),)
                         + self.crop_hw + (3,), np.uint8)
        for j, cr in enumerate(crops):
            batch[j] = cr
        return batch

    def _frozen_request_feats(self, mem_entries, det_inds, unit_crop,
                              normalize_ims):
        """One request's feature batches ``([T, L, F], [T, C, F])``: memory
        crops hit the cross-frame cache, candidates are deduplicated across
        tracks before encoding and expanded per slot on the host."""
        t_count = len(mem_entries)
        seq_len, c = self.seq_len, self.num_candidates
        units: list = []
        for e in mem_entries:
            if e is None:
                units.extend([(0, None)] * seq_len)
            else:
                units.extend([(getattr(cr, "uid", None), cr) for cr in e])
        unit_to_row = {}
        can_units: list = [(0, None)]  # row 0 = the zero crop
        gather = np.zeros((t_count, c), np.int64)
        for ti in range(t_count):
            for ci, di in enumerate(det_inds[ti]):
                if di is None:
                    continue  # gather stays 0: the zero crop's feature
                row = unit_to_row.get(di)
                if row is None:
                    crop = unit_crop(di)
                    row = len(can_units)
                    unit_to_row[di] = row
                    can_units.append((getattr(crop, "uid", None), crop))
                gather[ti, ci] = row
        feats = self._resolve_feats(units + can_units, normalize_ims)
        n_mem = t_count * seq_len
        mem_feats = feats[:n_mem].reshape(t_count, seq_len, -1)
        return mem_feats, feats[n_mem:][gather]

    # ----------------------------------------- frozen device feature bank --
    def _new_bank_ctx(self) -> dict:
        """Per-call bank context: the fresh crops to encode and their slots,
        the ephemeral (untagged-crop) slots released after the call, the
        keys the call references (spared from eviction), the keys it
        registered (rolled back if it fails before its scatter), and the
        bank generation it was built against."""
        return {"fresh_crops": [], "fresh_slots": [], "ephemeral": [],
                "referenced": set(), "new_keys": [], "flushed": False,
                "gen": self._bank_gen}

    def _reset_bank(self):
        """Drop the bank and every registration: the recovery after a
        failure once the scatter was enqueued (its rows are then unknown).
        Speed only: every feature re-encodes deterministically."""
        self._bank = None
        self._slot_of.clear()
        self._free_slots = list(range(self._feat_cache_cap - 1, 0, -1))
        self._bank_gen += 1

    def _rollback_ctx(self, ctx):
        """Undo a failed call's registrations, which would otherwise hit
        bank rows never written."""
        if ctx["gen"] != self._bank_gen:
            # the bank was reset under this call: its slots are reclaimed
            ctx["new_keys"].clear()
            ctx["ephemeral"].clear()
            return
        for key, slot in ctx["new_keys"]:
            if self._slot_of.get(key) == slot:
                del self._slot_of[key]
                self._free_slots.append(slot)
        ctx["new_keys"].clear()
        self._release_ephemeral(ctx)

    def _alloc_slot(self, ctx) -> int:
        if self._free_slots:
            return self._free_slots.pop()
        # evict the least recently used key that this call does not
        # reference: the call's gather indices stay valid until it scores
        referenced = ctx["referenced"]
        for key in self._slot_of:
            if key not in referenced:
                return self._slot_of.pop(key)
        raise RuntimeError(
            "feature bank exhausted: one call references more than "
            f"{self._feat_cache_cap - 1} distinct crops; raise "
            "feat_cache_slots")

    def _slot_for(self, uid, crop, normalize_flag: bool, ctx) -> int:
        """The bank slot of one unit, a fresh encode queued on a miss.
        ``crop=None`` is the zero crop (uid 0, as the host cache)."""
        if crop is None:
            uid = 0
        key = None if uid is None else (uid, normalize_flag)
        slots = self._slot_of
        if key is not None:
            s = slots.get(key)
            if s is not None:
                slots.move_to_end(key)
                ctx["referenced"].add(key)
                return s
        s = self._alloc_slot(ctx)
        ctx["fresh_crops"].append(self._zero_crop if crop is None else crop)
        ctx["fresh_slots"].append(s)
        if key is None:
            ctx["ephemeral"].append(s)  # encoded for this call only
        else:
            slots[key] = s
            ctx["referenced"].add(key)
            ctx["new_keys"].append((key, s))
        return s

    def _frozen_request_slots(self, mem_entries, det_inds, unit_crop,
                              normalize_ims, ctx):
        """One request's bank gather maps ``([T, L], [T, C])``, as
        :meth:`_frozen_request_feats` with slots for feature rows."""
        t_count = len(mem_entries)
        seq_len, c = self.seq_len, self.num_candidates
        flag = bool(normalize_ims)
        zero_slot = self._slot_for(0, None, flag, ctx)
        mem_slots = np.full((t_count, seq_len), zero_slot, np.int64)
        for ti, e in enumerate(mem_entries):
            if e is None:
                continue  # an incomplete memory: zero-crop features
            for li, cr in enumerate(e):
                mem_slots[ti, li] = self._slot_for(
                    getattr(cr, "uid", None), cr, flag, ctx)
        can_slots = np.full((t_count, c), zero_slot, np.int64)
        unit_slot: dict = {}
        for ti in range(t_count):
            for ci, di in enumerate(det_inds[ti]):
                if di is None:
                    continue
                s = unit_slot.get(di)
                if s is None:
                    cr = unit_crop(di)
                    s = self._slot_for(getattr(cr, "uid", None), cr, flag,
                                       ctx)
                    unit_slot[di] = s
                can_slots[ti, ci] = s
        return mem_slots, can_slots

    def _bank_init(self):
        if self._bank is None:
            with torch.inference_mode():
                self._bank = torch.zeros(
                    (self._feat_cache_cap, self.config.dim_embedding),
                    dtype=torch.float32, device=self.device)

    def _flush_fresh(self, ctx, normalize_ims):
        """One encode + scatter for the call's fresh crops (padding rows go
        to the scratch slot 0)."""
        crops = ctx["fresh_crops"]
        if not crops:
            return
        self._bank_init()
        batch = self._crop_batch(crops)
        slots = np.zeros(len(batch), np.int64)
        slots[:len(crops)] = ctx["fresh_slots"]
        try:
            self._encode_scatter(batch, slots, bool(normalize_ims))
        except Exception:
            self._reset_bank()
            raise
        ctx["flushed"] = True

    def _chunked_scores(self, t_count, arrays, scorer) -> np.ndarray:
        """The chunk loop of the two frozen scorers: each slice of
        ``arrays`` padded to its bucket, ``scorer(*padded, mask)``, the
        probability rows trimmed and concatenated."""
        out = []
        for start, end, b, pad, mask in self._chunks(t_count):
            if profiling.tracing():
                self._count_call(end - start, b, 0)
            probs = scorer(*(self._tensor(_padded(a, start, end, pad))
                             for a in arrays), self._tensor(mask))
            out.append(probs.cpu().numpy()[:end - start])
        return np.concatenate(out, axis=0)

    def _score_bank_chunked(self, mem_slots, can_slots, mem_boxes,
                            can_boxes) -> np.ndarray:
        """The bank scorer over the bucket-padded slot batch (padding rows
        read the scratch slot)."""
        self._bank_init()
        return self._chunked_scores(
            mem_slots.shape[0], (mem_slots, can_slots, mem_boxes, can_boxes),
            lambda *a: self._score_bank(*a))

    def _release_ephemeral(self, ctx):
        # the call's work is enqueued on one stream, so a later scatter into
        # these slots runs after its gathers; nothing to do if the bank was
        # reset under the call
        if ctx["gen"] == self._bank_gen:
            self._free_slots.extend(ctx["ephemeral"])
        ctx["ephemeral"].clear()

    def _score_feats_chunked(self, mem_feats, can_feats, mem_boxes,
                             can_boxes) -> np.ndarray:
        """The feature scorer over the bucket-padded feature batch."""
        return self._chunked_scores(
            mem_feats.shape[0], (mem_feats, can_feats, mem_boxes, can_boxes),
            lambda *a: self._score_feats(*a))

    def _stack_mem_lists(self, mem_entries) -> np.ndarray:
        """Per-track crop lists (the frozen prep's format) as the ``[T, L,
        H, W, 3]`` array the fused scorers take; ``None`` (an incomplete
        memory) gives zero crops (network.py:300-308)."""
        out = np.zeros((len(mem_entries), self.seq_len) + self.crop_hw
                       + (3,), np.uint8)
        for ti, entry in enumerate(mem_entries):
            if entry is not None:
                for li, cr in enumerate(entry):
                    out[ti, li] = cr
        return out
