"""Training episodes for the multi-choice objective (port of
``busca_tpu.train.data``).

The reference trains BUSCA offline on MOTSynth (README.md:17, arXiv paper
§4) and ships no training code.  This module gives the episodes:

- ``synthetic_batch``: procedurally generated episodes (moving rectangles on
  noise), numpy only, equal to busca_tpu's for the same ``RandomState``;
- ``MotEpisodeSampler``: episodes from MOT-format sequences on disk
  (gt.txt + frames), cropped through the port's crop op (kernel K1 on the
  card);
- ``EpisodeSpec``: the batch layout both produce.

Label convention: ``label in [0, C)`` = the correct candidate slot;
``label == C`` = NON ("none of the above"); ``label == C+1`` = BAD
("corrupt memory", only when the flavour has a BAD token).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from busca_tpu_torch.models.busca import (
    INPUT_PIXEL_MEAN_BGR,
    INPUT_PIXEL_STD_BGR,
)


@dataclasses.dataclass(frozen=True)
class EpisodeSpec:
    batch: int = 8
    seq_len: int = 11
    num_candidates: int = 5
    crop_hw: Tuple[int, int] = (384, 128)
    has_bad: bool = True
    neg_threshold: float = 0.5  # IoU below which no candidate is "correct"
    # Opt-in broader-memory augmentation: per-episode random stride in
    # [1, mem_stride_max] between memory entries, so even-stride-subsampled
    # memories (use_broader_memory / the mem-cap archive,
    # network.py:262-271) are in-distribution.  1 = consecutive frames.
    mem_stride_max: int = 1

    @property
    def num_choices(self) -> int:
        return self.num_candidates + (2 if self.has_bad else 1)


def _normalize(mem_crops: np.ndarray, can_crops: np.ndarray):
    """Uint8-valued BGR crops -> the inference pipeline's normalized RGB
    (GHOST BGR statistics, then RGB order), in place then flipped."""
    for arr in (mem_crops, can_crops):
        arr /= 255.0
        arr -= INPUT_PIXEL_MEAN_BGR
        arr /= INPUT_PIXEL_STD_BGR
    return mem_crops[..., ::-1].copy(), can_crops[..., ::-1].copy()


def _empty_batch(spec: EpisodeSpec):
    b, l, c = spec.batch, spec.seq_len, spec.num_candidates
    h, w = spec.crop_hw
    return (np.zeros((b, l, h, w, 3), np.float32),
            np.zeros((b, c, h, w, 3), np.float32),
            np.zeros((b, l, 4), np.float32),
            np.zeros((b, c, 4), np.float32),
            np.zeros((b,), np.int32))


def synthetic_batch(rng: np.random.RandomState,
                    spec: EpisodeSpec) -> Dict[str, np.ndarray]:
    """One training batch of synthetic episodes.

    Each episode: a target with a distinctive mean colour moving with
    constant velocity; memory crops show it at past positions; one
    candidate (at a random slot) shows it at the current position; the
    others show distractors.  With probability ~0.2 the target disappears
    (label = NON); with probability ~0.1 the memory is scrambled (label =
    BAD, if present).
    """
    b, l, c = spec.batch, spec.seq_len, spec.num_candidates
    h, w = spec.crop_hw
    mem_crops, can_crops, mem_boxes, can_boxes, labels = _empty_batch(spec)

    for i in range(b):
        color = rng.uniform(40, 215, 3)
        vx, vy = rng.uniform(-4, 4, 2)
        x0, y0 = rng.uniform(100, 500), rng.uniform(100, 300)
        bw, bh = rng.uniform(30, 60), rng.uniform(60, 120)

        def crop_of(col, noise=12.0):
            return np.clip(
                col + rng.randn(h, w, 3) * noise, 0, 255
            ).astype(np.float32)

        mem_stride = (1 if spec.mem_stride_max <= 1
                      else rng.randint(1, spec.mem_stride_max + 1))
        for t in range(l):
            mem_crops[i, t] = crop_of(color)
            x = x0 + vx * (t - l + 1) * mem_stride
            y = y0 + vy * (t - l + 1) * mem_stride
            mem_boxes[i, t] = [x, y, x + bw, y + bh]

        u = rng.uniform()
        if spec.has_bad and u < 0.1:
            labels[i] = c + 1  # BAD: scramble the memory colours
            for t in range(l):
                mem_crops[i, t] = crop_of(rng.uniform(0, 255, 3))
            target_slot = -1
        elif u < 0.3:
            labels[i] = c  # NON: target vanished
            target_slot = -1
        else:
            target_slot = rng.randint(c)
            labels[i] = target_slot

        # detector dropouts put the correct candidate several frames ahead
        # of the last memory entry: a random gap teaches extrapolation
        gap = rng.randint(1, 7)
        for ci in range(c):
            if ci == target_slot:
                can_crops[i, ci] = crop_of(color)
                x = x0 + vx * gap
                y = y0 + vy * gap
                can_boxes[i, ci] = [x, y, x + bw, y + bh]
            else:
                can_crops[i, ci] = crop_of(rng.uniform(0, 255, 3))
                dx, dy = rng.uniform(-300, 300, 2)
                x, y = x0 + dx, y0 + dy
                can_boxes[i, ci] = [x, y, x + bw * rng.uniform(0.5, 2),
                                    y + bh * rng.uniform(0.5, 2)]

    mem_crops, can_crops = _normalize(mem_crops, can_crops)
    return {
        "mem_crops": mem_crops,
        "can_crops": can_crops,
        "mem_boxes": mem_boxes,
        "can_boxes": can_boxes,
        "labels": labels,
    }


class MotEpisodeSampler:
    """Training episodes from MOT-format sequences on disk (gt.txt +
    frames), as busca_tpu's sampler builds them: memory = a track's crops
    over ``seq_len`` past gt frames, candidates = the gt boxes at a frame
    ``gap`` ahead (the track's own box at a random slot while it is still
    present, NON when it left), distractors = the frame's other identities,
    nearest first.

    A batch draws every episode first (the same ``rng`` calls in the same
    order as busca_tpu), then crops: one crop-op call per (sequence, frame)
    with all of that frame's boxes of the batch, through
    ``trackers/base.py::extract_uint8_crops`` on ``device`` (K1 on the card).
    The crop op treats each box on its own, so the crops equal one call per
    box.  Frames are decoded with cv2 in :meth:`_frame`, the one place that
    reads them.
    """

    def __init__(self, seq_dirs, spec: EpisodeSpec, min_visibility=0.3,
                 cache_frames: int = 32, device="cuda"):
        from busca_tpu_torch.eval import mot

        self.spec = spec
        self.device = device
        self.seqs = []
        for d in seq_dirs:
            info = mot.load_seqinfo(d)
            gt = mot.read_gt(f"{d}/gt/gt.txt", min_visibility=min_visibility)
            by_id: Dict[int, Dict[int, np.ndarray]] = {}
            for f, (tlwh, ids) in gt.items():
                for box, tid in zip(tlwh, ids):
                    by_id.setdefault(int(tid), {})[int(f)] = box
            usable = {tid: frames for tid, frames in by_id.items()
                      if len(frames) >= spec.seq_len + 1}
            if usable:
                self.seqs.append((info, gt, usable))
        if not self.seqs:
            raise ValueError("no usable sequences/tracks for episodes")
        self._frame_cache: Dict[Tuple[int, int], np.ndarray] = {}
        self._cache_cap = cache_frames

    def _frame(self, si: int, f: int) -> np.ndarray:
        """The decoded BGR frame ``f`` of sequence ``si`` (a FIFO cache of
        ``cache_frames`` frames)."""
        import cv2

        key = (si, f)
        if key not in self._frame_cache:
            if len(self._frame_cache) >= self._cache_cap:
                self._frame_cache.pop(next(iter(self._frame_cache)))
            info = self.seqs[si][0]
            img = cv2.imread(info.frame_path(f))
            if img is None:
                raise FileNotFoundError(info.frame_path(f))
            self._frame_cache[key] = img
        return self._frame_cache[key]

    def _crop_all(self, wanted: List[Tuple[int, int, np.ndarray,
                                           np.ndarray]]):
        """Fill each ``(si, f, tlwh, dest)`` of ``wanted`` (``dest`` a view
        of one crop slot) with one crop-op call per (sequence, frame)."""
        from busca_tpu_torch.trackers.base import extract_uint8_crops

        groups: Dict[Tuple[int, int], list] = {}
        for si, f, tlwh, dest in wanted:
            groups.setdefault((si, f), []).append((tlwh, dest))
        for (si, f), items in groups.items():
            tlbr = np.array([[b[0], b[1], b[0] + b[2], b[1] + b[3]]
                             for b, _ in items], np.float32)
            crops = extract_uint8_crops(self._frame(si, f), tlbr,
                                        self.spec.crop_hw,
                                        device=self.device)
            for (_, dest), crop in zip(items, crops):
                dest[...] = crop

    def batch(self, rng: np.random.RandomState) -> Dict[str, np.ndarray]:
        spec = self.spec
        l, c = spec.seq_len, spec.num_candidates
        mem_crops, can_crops, mem_boxes, can_boxes, labels = \
            _empty_batch(spec)
        wanted = []
        for i in range(spec.batch):
            si = rng.randint(len(self.seqs))
            info, gt, usable = self.seqs[si]
            tid = list(usable.keys())[rng.randint(len(usable))]
            frames = sorted(usable[tid].keys())
            # anchor: memory = the l track frames ending at `anchor`
            ai = rng.randint(l - 1, len(frames))
            mem_frames = frames[max(0, ai - l + 1): ai + 1]
            while len(mem_frames) < l:  # left-pad by repetition
                mem_frames = [mem_frames[0]] + mem_frames
            for t, f in enumerate(mem_frames):
                box = usable[tid][f]
                wanted.append((si, f, box, mem_crops[i, t]))
                mem_boxes[i, t] = [box[0], box[1],
                                   box[0] + box[2], box[1] + box[3]]
            gap = rng.randint(1, 7)
            target_frame = frames[ai] + gap
            present = target_frame in usable[tid]
            cand_frame = target_frame if target_frame in gt else frames[ai]
            tlwh_all, ids_all = gt.get(cand_frame, (np.zeros((0, 4)),
                                                    np.zeros((0,), int)))
            others = [(bx, idd) for bx, idd in zip(tlwh_all, ids_all)
                      if idd != tid]
            ref = usable[tid][frames[ai]]
            others.sort(key=lambda e: (e[0][0] - ref[0]) ** 2
                        + (e[0][1] - ref[1]) ** 2)
            target_slot = rng.randint(c) if present else -1
            labels[i] = target_slot if present else c  # NON when gone
            oi = 0
            for ci in range(c):
                if ci == target_slot:
                    box = usable[tid][target_frame]
                    wanted.append((si, target_frame, box, can_crops[i, ci]))
                elif oi < len(others):
                    box = others[oi][0]
                    wanted.append((si, cand_frame, box, can_crops[i, ci]))
                    oi += 1
                else:  # not enough distractors: a random far box, no crop
                    box = np.array([ref[0] + rng.uniform(-300, 300),
                                    ref[1] + rng.uniform(-300, 300),
                                    ref[2], ref[3]])
                can_boxes[i, ci] = [box[0], box[1],
                                    box[0] + box[2], box[1] + box[3]]
        self._crop_all(wanted)
        mem_crops, can_crops = _normalize(mem_crops, can_crops)
        return {
            "mem_crops": mem_crops,
            "can_crops": can_crops,
            "mem_boxes": mem_boxes,
            "can_boxes": can_boxes,
            "labels": labels,
        }
