"""Frozen copy of ``busca_tpu_torch/eval/synthetic.py`` at commit c2c24f5:
the renderer the benchmark's traffic generator draws its frames with
(later edits to the program do not change the yardstick).

Synthetic MOT sequences for end-to-end testing and benchmarking (port of
``busca_tpu.eval.synthetic``, numpy only).

Renders moving colored rectangles over a textured background and emits
(frames, ground truth, detections) with controllable detector failures —
the scenario BUSCA exists to fix (a detector dropout window on a still-visible
object).  Serves the role of the reference's golden-number A/B harness
(SURVEY.md §4) without needing the MOT17 dataset on disk.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticObject:
    color: np.ndarray  # BGR uint8
    x0: float
    y0: float
    vx: float
    vy: float
    w: float
    h: float
    # detector dropout window [start, end) — the object stays visible
    dropout: Tuple[int, int] = (0, 0)
    # low-confidence window [start, end): the detector still fires but at
    # ``dip_score`` — drives BYTE's second (low-score) association round
    # (byte_tracker.py:341-361) in composed tests
    score_dip: Tuple[int, int] = (0, 0)
    dip_score: float = 0.3

    def box_at(self, t: int) -> np.ndarray:
        x = self.x0 + self.vx * t
        y = self.y0 + self.vy * t
        return np.array([x, y, self.w, self.h])  # tlwh

    def detected_at(self, t: int) -> bool:
        lo, hi = self.dropout
        return not (lo <= t < hi)

    def score_at(self, t: int, base: float) -> float:
        lo, hi = self.score_dip
        return self.dip_score if lo <= t < hi else base


@dataclasses.dataclass
class SyntheticSequence:
    objects: List[SyntheticObject]
    num_frames: int
    height: int = 256
    width: int = 384
    det_noise: float = 1.0
    det_score: float = 0.9
    seed: int = 0
    # global camera drift in px/frame: the viewport pans over a larger
    # static world, so every frame is a shifted view — the scenario ECC
    # camera-motion compensation exists for (byte_tracker.py:626-650).
    # Object/detection/gt coordinates are all in VIEWPORT space.
    camera_drift: Tuple[float, float] = (0.0, 0.0)

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        offs = [self._world_offset(t) for t in range(self.num_frames)]
        self._x_lo = min(o[0] for o in offs)
        self._y_lo = min(o[1] for o in offs)
        pad_x = max(o[0] for o in offs) - self._x_lo
        pad_y = max(o[1] for o in offs) - self._y_lo
        # static textured background so appearance features are non-trivial
        self._background = rng.randint(
            0, 80, (self.height + pad_y, self.width + pad_x, 3),
            dtype=np.uint8,
        )
        self._rng = np.random.RandomState(self.seed + 1)

    def _world_offset(self, t: int) -> Tuple[int, int]:
        """Viewport origin in world coordinates at frame ``t`` (integer so
        the background texture shifts without resampling)."""
        return (
            int(round(self.camera_drift[0] * t)),
            int(round(self.camera_drift[1] * t)),
        )

    def frame(self, t: int) -> np.ndarray:
        ox, oy = self._world_offset(t)
        ax, ay = ox - self._x_lo, oy - self._y_lo
        img = self._background[
            ay : ay + self.height, ax : ax + self.width
        ].copy()
        for obj in self.objects:
            x, y, w, h = obj.box_at(t)
            x, y = x - ox, y - oy  # world -> viewport
            x1, y1 = int(round(x)), int(round(y))
            x2, y2 = int(round(x + w)), int(round(y + h))
            x1c, x2c = max(x1, 0), min(x2, self.width)
            y1c, y2c = max(y1, 0), min(y2, self.height)
            if x1c < x2c and y1c < y2c:
                patch = np.clip(
                    obj.color
                    + self._rng.randn(y2c - y1c, x2c - x1c, 3) * 6.0,
                    0,
                    255,
                ).astype(np.uint8)
                img[y1c:y2c, x1c:x2c] = patch
        return img

    def detections(self, t: int) -> Tuple[np.ndarray, np.ndarray]:
        """(tlbr [N, 4], scores [N]) with jitter; dropout windows honored."""
        boxes, scores = [], []
        ox, oy = self._world_offset(t)
        shift = np.array([ox, oy, 0.0, 0.0])
        for obj in self.objects:
            if not obj.detected_at(t):
                continue
            tlwh = obj.box_at(t) - shift + self._rng.randn(4) * self.det_noise
            boxes.append(
                [tlwh[0], tlwh[1], tlwh[0] + tlwh[2], tlwh[1] + tlwh[3]]
            )
            scores.append(
                obj.score_at(t, self.det_score)
                + self._rng.uniform(-0.05, 0.05)
            )
        if not boxes:
            return np.zeros((0, 4)), np.zeros(0)
        return np.asarray(boxes, dtype=np.float64), np.asarray(scores)

    def ground_truth(self) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
        """{frame(1-based): (tlwh [N,4], ids [N])} — visible objects only."""
        gt = {}
        for t in range(self.num_frames):
            ox, oy = self._world_offset(t)
            shift = np.array([ox, oy, 0.0, 0.0])
            boxes, ids = [], []
            for oid, obj in enumerate(self.objects, start=1):
                boxes.append(obj.box_at(t) - shift)
                ids.append(oid)
            gt[t + 1] = (np.asarray(boxes), np.asarray(ids, int))
        return gt


def default_dropout_sequence(num_frames: int = 40,
                             seed: int = 0) -> SyntheticSequence:
    """Two well-separated objects; object 1 has a mid-sequence dropout."""
    objs = [
        SyntheticObject(
            color=np.array([40, 200, 60], np.float64),
            x0=30, y0=60, vx=3.0, vy=0.5, w=36, h=72,
            dropout=(18, 26),
        ),
        SyntheticObject(
            color=np.array([210, 60, 180], np.float64),
            x0=280, y0=150, vx=-2.0, vy=-0.8, w=40, h=80,
        ),
    ]
    return SyntheticSequence(objs, num_frames=num_frames, seed=seed)
