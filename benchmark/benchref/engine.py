"""Frozen copy of ``busca_tpu_torch/assoc/engine.py`` at commit c2c24f5, part of the
benchmark's plain reference (it imports nothing of the program; edits
to the program do not reach it).  Cut to what the configurations run:
batch-statistics ReID with deduplicated candidates, crops as pixels (no
crop bank: the bank holds the same uint8 crops), no frozen-statistics
modes, no decision montage.  The candidate-selection distance is always
worked out here from the boxes (a passed distance matrix is not read).

The third association round from a request: memory and candidate
selection on the host, the model call per power-of-two track bucket (or
one grouped call over a lockstep tick's requests, BN statistics per
request), and the one-hot post-processing (busca/network.py:247-429).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from benchref import hostmath
from benchref.busca import INPUT_PIXEL_MEAN_BGR, INPUT_PIXEL_STD_BGR
from benchref.encodings import missing_candidate_bbox
from benchref.padding import next_pow2

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)
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
    """(gather [b, c] int32, weights, crops with crops[0] = None): each
    (track, candidate slot) mapped to a unique crop (0 = the zero crop of a
    missing slot), slot occurrences counted as the BN weights."""
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


class ReferenceEngine:
    """The third round on the reference BUSCA model.  ``raw`` collects each
    request's probabilities before the post-processing, in the order the
    requests are post-processed."""

    def __init__(self, model, seq_len: int = 11, num_candidates: int = 5,
                 crop_hw: Tuple[int, int] = (384, 128),
                 buckets: Sequence[int] = DEFAULT_BUCKETS):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.seq_len = seq_len
        self.num_candidates = num_candidates
        self.crop_hw = tuple(crop_hw)
        self.buckets = tuple(sorted(buckets))
        self.raw: List[np.ndarray] = []
        self._mean = torch.tensor(INPUT_PIXEL_MEAN_BGR.tolist(),
                                  device=self.device)
        self._std = torch.tensor(INPUT_PIXEL_STD_BGR.tolist(),
                                 device=self.device)
        self._255 = torch.full((), 255.0, device=self.device)

    # ------------------------------------------------------------ device --
    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _prep(self, x: torch.Tensor, normalize_ims: bool) -> torch.Tensor:
        """uint8 BGR HWC crops -> normalized RGB float32."""
        x = x.to(torch.float32)
        if normalize_ims:
            x = (x / self._255 - self._mean) / self._std
        return x.flip(-1)  # BGR -> RGB (network.py:396-398)

    @torch.inference_mode()
    def _probs(self, mem_crops, can_crops, mem_boxes, can_boxes, mask,
               normalize_ims, can_weights=None, can_gather=None,
               mem_group=None, can_group=None, num_groups=1) -> np.ndarray:
        def opt(x):
            return None if x is None else self._tensor(x)

        logits = self.model(
            self._prep(mem_crops, normalize_ims),
            self._prep(can_crops, normalize_ims),
            self._tensor(mem_boxes), self._tensor(can_boxes),
            self._tensor(mask),
            can_weights=opt(can_weights), can_gather=opt(can_gather),
            mem_group=opt(mem_group), can_group=opt(can_group),
            num_groups=num_groups)
        return torch.softmax(logits, dim=-1).cpu().numpy()

    # --------------------------------------------------------------- api --
    def associate(self, tracks, dets, dists_matrix=None, *,
                  use_broader_memory: bool = True,
                  select_highest_candidate: bool = True,
                  highest_candidate_minimum_thresh: Optional[float] = None,
                  keep_highest_value: bool = False,
                  extra_kalman_candidates: Sequence = (),
                  normalize_ims: bool = True):
        """(probs_matrix [T, D(+T)], reliable [T]) or (None, None)."""
        req = self._prep_request(tracks, dets, use_broader_memory,
                                 extra_kalman_candidates)
        if req is None:
            return None, None
        probs = self._score_prepped(req, normalize_ims)
        (_, _, reliable, det_inds, _, _, num_available, d_count, _) = req
        return self._postprocess(
            probs, reliable, det_inds, num_available,
            d_count + len(extra_kalman_candidates),
            select_highest_candidate=select_highest_candidate,
            highest_candidate_minimum_thresh=highest_candidate_minimum_thresh,
            keep_highest_value=keep_highest_value)

    def associate_many(self, requests, *, use_broader_memory: bool = True,
                       select_highest_candidate: bool = True,
                       highest_candidate_minimum_thresh: Optional[float] = None,
                       keep_highest_value: bool = False,
                       normalize_ims: bool = True):
        """``(tracks, dets, dists_or_None, kalman)`` requests in one model
        call where they fit one bucket (BN statistics per request), else one
        by one; one ``(probs_matrix, reliable)`` per request."""
        results = [(None, None)] * len(requests)
        preps = []
        for i, (tracks, dets, _dists, kal) in enumerate(requests):
            req = self._prep_request(tracks, dets, use_broader_memory, kal)
            if req is not None:
                preps.append((i, req, len(dets) + len(kal)))
        if not preps:
            return results
        post_kw = dict(
            select_highest_candidate=select_highest_candidate,
            highest_candidate_minimum_thresh=highest_candidate_minimum_thresh,
            keep_highest_value=keep_highest_value)
        t_total = sum(req[8] for _, req, _ in preps)
        if len(preps) == 1 or t_total > self.buckets[-1]:
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
        """One model call over every prepped request: the track batch padded
        to its bucket, ``next_pow2(r)`` BN groups, each request with its own
        unique candidate crops and its own zero crop."""
        seq_len, c = self.seq_len, self.num_candidates
        h, w = self.crop_hw
        t_total = sum(req[8] for _, req, _ in preps)
        b = self._bucket(t_total)
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
        uniq = np.zeros((u_pad, h, w, 3), np.uint8)
        for ui, crop in enumerate(uniq_crops):
            if crop is not None:
                uniq[ui] = crop
        probs = self._probs(
            self._tensor(mem_crops), self._tensor(uniq), mem_boxes,
            can_boxes, mask, normalize_ims, can_weights=w_arr,
            can_gather=gather, mem_group=mem_group, can_group=g_arr,
            num_groups=next_pow2(len(preps)))
        return probs, spans

    def _score_prepped(self, req, normalize_ims) -> np.ndarray:
        """Raw probabilities ``[T, C + extras]`` of one request: per chunk of
        at most the largest bucket, the unique candidate crops once (index
        0 = the zero crop, weighted by the missing slots) and a gather
        map."""
        (mem_crops, mem_boxes, _reliable, det_inds, can_boxes, unit_crop,
         _num_available, _d_count, _t_count) = req
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
                mask, normalize_ims, can_weights=w_arr, can_gather=gather)
            out.append(probs[:end - start])
        return np.concatenate(out, axis=0)

    def _prep_request(self, tracks, dets, use_broader_memory,
                      extra_kalman_candidates):
        """(mem_crops, mem_boxes, reliable, det_inds, can_boxes, unit_crop,
        num_available, d_count, t_count), or None for an empty request."""
        if len(tracks) == 0:
            return None
        if len(dets) == 0 and len(extra_kalman_candidates) == 0:
            return None
        dists_matrix = self.center_distances(tracks, dets)
        seq_len, c = self.seq_len, self.num_candidates
        h, w = self.crop_hw
        t_count = len(tracks)
        d_count = len(dets)
        mem_crops = np.zeros((t_count, seq_len, h, w, 3), dtype=np.uint8)
        mem_boxes = np.zeros((t_count, seq_len, 4), dtype=np.float64)
        reliable = np.zeros(t_count, dtype=bool)
        for ti, track in enumerate(tracks):
            crops, bboxes = _get_track_mem(track, seq_len, use_broader_memory)
            if len(crops) == seq_len:
                reliable[ti] = True
                mem_crops[ti] = np.stack(crops)
                mem_boxes[ti] = bboxes
            else:
                mem_boxes[ti] = INCOMPLETE_MEM_BBOX_TLWH  # zero crops stay
        can_boxes = np.tile(missing_candidate_bbox("ltwh"), (t_count, c, 1))
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
                    np.asarray(det.tlwh_mem[-1], dtype=np.float64) * det.scale)
        if len(extra_kalman_candidates) > 0:
            num_available = min(d_count + 1, c)
            k_slot = min(d_count, c - 1)
            for ti, kdet in enumerate(extra_kalman_candidates):
                det_inds[ti][k_slot] = d_count + ti
                can_boxes[ti, k_slot] = np.asarray(kdet.tlwh) * kdet.scale

        def unit_crop(idx: int) -> np.ndarray:
            """Candidate crop: detection index, or d_count + ti = Kalman."""
            if idx < d_count:
                return dets[idx].images_mem[-1]
            return extra_kalman_candidates[idx - d_count].images_mem[-1]

        # tlwh -> ltrb (network.py:391-394)
        mem_boxes = hostmath.tlwh_to_tlbr(mem_boxes).astype(np.float32)
        can_boxes = hostmath.tlwh_to_tlbr(can_boxes).astype(np.float32)
        return (mem_crops, mem_boxes, reliable, det_inds, can_boxes,
                unit_crop, num_available, d_count, t_count)

    def _postprocess(self, probs, reliable, det_inds, num_available,
                     num_dets_total, *, select_highest_candidate=True,
                     highest_candidate_minimum_thresh=None,
                     keep_highest_value=False):
        """Per-track probabilities scattered into the [T, D(+T)] matrix
        with the one-hot post-processing (network.py:407-429)."""
        self.raw.append(np.array(probs, copy=True))
        t_count = probs.shape[0]
        probs_matrix = np.zeros((t_count, num_dets_total))
        for ti in range(t_count):
            track_probs = probs[ti]
            if select_highest_candidate:
                new = np.zeros_like(track_probs)
                mt = highest_candidate_minimum_thresh
                if mt is None or mt == 0 or track_probs.max() >= mt:
                    new[track_probs.argmax()] = (
                        track_probs.max() if keep_highest_value else 1.0)
                track_probs = new
            inds = det_inds[ti][:num_available]
            probs_matrix[ti, inds] = track_probs[:num_available]
        return probs_matrix, reliable

    @staticmethod
    def center_distances(tracks, dets) -> np.ndarray:
        """Center distances of the current boxes (busca/tracking.py:23-60),
        the candidate-selection distance."""
        if len(tracks) == 0 or len(dets) == 0:
            return np.zeros((len(tracks), len(dets)))
        return hostmath.center_distance(np.stack([t.tlbr for t in tracks]),
                                        np.stack([d.tlbr for d in dets]))

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
