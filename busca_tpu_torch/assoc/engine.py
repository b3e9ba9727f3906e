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

Batch mode only: ``reid_stats='frozen'|'auto'`` (and with it the frozen
branch of ``associate_many``) and the debug montage are not ported yet
(ROADMAP.md Queue 1, items 7 and 24).
"""

from __future__ import annotations

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
from busca_tpu_torch.utils.padding import next_pow2

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)
INCOMPLETE_MEM_BBOX_TLWH = np.array([250.0, 250.0, 500.0, 500.0])
_NOT_PORTED = "not ported yet (ROADMAP.md Queue 1, {}): {}"


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
    ):
        if reid_stats != "batch":
            raise NotImplementedError(
                _NOT_PORTED.format("items 7 and 24",
                                   f"reid_stats={reid_stats!r}"))
        if debug_dir is not None:
            raise NotImplementedError(
                _NOT_PORTED.format("item 25", "debug montage"))
        if bank is not None and tuple(bank.crop_hw) != tuple(crop_hw):
            raise ValueError("bank crop_hw mismatch")
        if model.config.dtype != config.dtype:
            raise ValueError(f"the model computes in {model.config.dtype}, "
                             f"the config says {config.dtype}")
        self.reid_stats = reid_stats
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
        self._mean = torch.tensor(INPUT_PIXEL_MEAN_BGR.tolist(),
                                  device=self.device)
        self._std = torch.tensor(INPUT_PIXEL_STD_BGR.tolist(),
                                 device=self.device)
        self._255 = torch.full((), 255.0, device=self.device)

    @property
    def banked(self) -> bool:
        """Whether scoring ships bank slot indices instead of pixels."""
        return self.bank is not None and self.dedup_candidates

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

        return self._scores(
            mem_crops, can_crops, self._tensor(mem_boxes),
            self._tensor(can_boxes), self._tensor(mask), normalize_ims,
            can_weights=opt(can_weights), can_gather=opt(can_gather),
            mem_group=opt(mem_group), can_group=opt(can_group),
            num_groups=num_groups,
        ).cpu().numpy()

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
        req = self._prep_request(
            tracks, dets, dists_matrix,
            use_broader_memory=use_broader_memory,
            extra_kalman_candidates=extra_kalman_candidates,
        )
        if req is None:
            return None, None
        probs = self._score_prepped(req, normalize_ims)
        (_, _, reliable, det_inds, _, _, num_available, d_count, _) = req
        return self._postprocess(
            probs, reliable, det_inds, num_available,
            d_count + len(extra_kalman_candidates),
            select_highest_candidate=select_highest_candidate,
            highest_candidate_minimum_thresh=highest_candidate_minimum_thresh,
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
        results = [(None, None)] * len(requests)
        preps = []
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
        post_kw = dict(
            select_highest_candidate=select_highest_candidate,
            highest_candidate_minimum_thresh=highest_candidate_minimum_thresh,
            keep_highest_value=keep_highest_value,
        )
        t_total = sum(req[8] for _, req, _ in preps)
        if (len(preps) == 1 or t_total > self.buckets[-1]
                or not self.dedup_candidates):
            # one live request, a batch above the largest bucket, or the
            # duplicated path: the prepped requests one by one
            # (busca_tpu/assoc/engine.py:651-669)
            for i, req, ndt in preps:
                probs = self._score_prepped(req, normalize_ims)
                (_, _, reliable, det_inds, _, _, num_avail, _, _) = req
                results[i] = self._postprocess(
                    probs, reliable, det_inds, num_avail, ndt, **post_kw)
            return results
        probs, spans = self._score_grouped(preps, normalize_ims)
        for i, row0, t_count, reliable, det_inds, num_avail, ndt in spans:
            results[i] = self._postprocess(
                probs[row0:row0 + t_count], reliable, det_inds, num_avail,
                ndt, **post_kw)
        return results

    def _score_grouped(self, preps, normalize_ims):
        """One model call over every prepped request, the track batch
        padded to its bucket and ``next_pow2(r)`` BN groups per kind.  Each
        request has its own unique candidate units and its own zero
        "missing slot" unit, so its weights land in its own group.  Returns
        the raw probabilities and ``(i, row0, t_count, reliable, det_inds,
        num_available, n_cols)`` per request."""
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
        if self.banked:
            return self._score_bucketed_unique_b(
                mem_crops, det_inds, unit_crop, mem_boxes, can_boxes,
                normalize_ims,
            )
        if self.dedup_candidates:
            return self._score_bucketed_unique(
                mem_crops, det_inds, unit_crop, mem_boxes, can_boxes,
                normalize_ims,
            )
        c = self.num_candidates
        h, w = self.crop_hw
        can_crops = np.zeros((t_count, c, h, w, 3), dtype=np.uint8)
        for ti in range(t_count):
            for ci, di in enumerate(det_inds[ti]):
                if di is not None:
                    can_crops[ti, ci] = unit_crop(di)
        return self._score_bucketed(
            mem_crops, can_crops, mem_boxes, can_boxes, normalize_ims
        )

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

        # banked scoring keeps per-track crop LISTS (crop identity matters)
        keep_lists = self.banked
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
            gather, weights, crops_list = _dedup_gather(
                det_inds, start, end, c, b, unit_crop)
            u = len(crops_list)
            u_pad = next_pow2(u, min_bucket=8)
            uniq = np.zeros((u_pad, h, w, 3), dtype=np.uint8)
            for ui, crop in enumerate(crops_list[1:], start=1):
                uniq[ui] = crop
            w_arr = np.zeros(u_pad, dtype=np.float32)
            w_arr[:u] = weights
            probs = self._probs(
                self._tensor(_padded(mem_crops, start, end, pad)),
                self._tensor(uniq),
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
            probs = self._probs(
                bank[self._tensor(mem_slots)],
                bank[self._tensor(uniq_slots)],
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
            probs = self._probs(
                self._tensor(_padded(mem_crops, start, end, pad)),
                self._tensor(_padded(can_crops, start, end, pad)),
                _padded(mem_boxes, start, end, pad),
                _padded(can_boxes, start, end, pad),
                mask, normalize_ims,
            )
            out.append(probs[:end - start])
        return np.concatenate(out, axis=0)
