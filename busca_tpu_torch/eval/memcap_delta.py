"""Long synthetic streams for the bounded-memory mode (``--mem-cap``):
the stream part of ``busca_tpu.eval.memcap_delta``.

``mem_cap`` (trackers/base.py ``compact_mem_lists``) bounds each track's
appearance-memory store for long-stream serving; the reference grows it for
the track's whole life (byte_tracker.py:150-156).  The streams here keep
their objects in frame for any length and drop them from the detector
periodically, so third-round decisions happen across the whole stream: the
serving soak (tests/test_torch_serve_soak.py) runs on them.  The same seed
gives the same detections and frames as busca_tpu's.

``measure_memcap_delta`` and its CLI train the demo model first
(``train/demo.py``, ported) and run on ``eval/frozen_delta.py``'s helpers,
which wait for ROADMAP.md Queue 1 item 24.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from busca_tpu_torch.eval.synthetic import SyntheticObject, SyntheticSequence


@dataclasses.dataclass
class _LongStreamObject(SyntheticObject):
    """An object that survives arbitrarily long streams: triangle-wave
    (bouncing) motion keeps it in frame, and the detector drops it for
    ``drop_len`` frames every ``drop_period`` (offset-staggered per object)
    so third-round decisions occur across the WHOLE stream."""

    travel: float = 200.0         # one-way travel in px
    drop_period: int = 150
    drop_len: int = 6
    drop_offset: int = 0
    warm: int = 20

    VSPAN = 35.0  # vertical travel kept small: rows must stay in frame

    def box_at(self, t: int) -> np.ndarray:
        span = max(self.travel, 1.0)
        sx = (self.vx * t) % (2 * span)
        sy = (self.vy * t) % (2 * self.VSPAN)
        dx = sx if sx <= span else 2 * span - sx
        dy = sy if sy <= self.VSPAN else 2 * self.VSPAN - sy
        return np.array([self.x0 + dx, self.y0 + dy, self.w, self.h])

    def detected_at(self, t: int) -> bool:
        if t < self.warm:
            return True
        phase = (t - self.drop_offset) % self.drop_period
        return not (0 <= phase < self.drop_len)


def _long_stream_sequence(seed: int, num_frames: int,
                          drop_period: int = 150, drop_len: int = 6):
    """Three bouncing objects on the 256x384 synthetic canvas, each dropped
    by the detector for ``drop_len`` of every ``drop_period`` frames."""
    rng = np.random.RandomState(seed)
    colors = [
        np.array([40, 200, 60], np.float64),
        np.array([210, 60, 180], np.float64),
        np.array([60, 120, 230], np.float64),
    ]
    objs = []
    for i, color in enumerate(colors):
        objs.append(_LongStreamObject(
            color=color,
            x0=float(rng.uniform(10, 60)),
            y0=float(rng.uniform(15 + 55 * i, 30 + 55 * i)),
            vx=float(rng.uniform(1.5, 3.0)),
            vy=float(rng.uniform(0.3, 0.8)),
            w=float(rng.uniform(30, 40)),
            h=float(rng.uniform(45, 55)),
            travel=220.0,
            drop_period=drop_period,
            drop_len=drop_len,
            drop_offset=int(rng.randint(0, drop_period))
                        + (i * drop_period) // 3,
            warm=25,
        ))
    return SyntheticSequence(objs, num_frames=num_frames, seed=seed)
