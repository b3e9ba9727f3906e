"""CenterTrack adapter: the BYTE strategy behind CenterTrack's dict IO
(port of ``busca_tpu.trackers.centertrack``).

The reference replaces CenterTrack's own tracker with the ByteTrack adapter
behind a dict-converting shim (adapters/CenterTrack/src/lib/utils/
tracker.py:7-74): detections arrive as ``{'bbox': tlbr, 'score': s,
'class': c, ...}`` dicts, pedestrians (class 1) are tracked, and the output
is dicts with ``tracking_id`` and ``ct`` (the centre).  CenterTrack runs
mot20-style association (no score fusion, tracker.py:9) with ``new_thresh``
as the fresh-track threshold.  BUSCA's crops read the frame where it lies:
the detector's canvas stays on the card.
"""

from __future__ import annotations

from typing import List

import numpy as np

from busca_tpu_torch.trackers.byte import ByteTracker, ByteTrackerConfig


def dicts_to_arrays(results: List[dict]):
    """CenterTrack dict detections -> ``(boxes_tlbr, scores)`` of the
    pedestrian class (the reference shim's flattening,
    utils/tracker.py:40-50)."""
    ped = [r for r in results if r.get("class", 1) == 1]
    if ped:
        boxes = np.vstack([r["bbox"] for r in ped]).astype(np.float64)
        scores = np.array([r["score"] for r in ped], dtype=np.float64)
    else:
        boxes = np.zeros((0, 4))
        scores = np.zeros(0)
    return boxes, scores


class CenterTrackAdapter:
    """Dict-in, dict-out tracker with CenterTrack's interface."""

    def __init__(
        self,
        config: ByteTrackerConfig,
        assoc_engine=None,
        new_thresh: float = 0.4,
        frame_rate: int = 30,
    ):
        # CenterTrack forces mot20-style matching (tracker.py:9) and its own
        # fresh-track threshold (tracker.py:11)
        config.mot20 = True
        self.new_thresh = new_thresh
        self.frame_rate = frame_rate
        self.tracker = ByteTracker(config, assoc_engine, frame_rate)
        self.tracker.det_thresh = new_thresh
        self.tracks: List[dict] = []

    def reset(self):
        self.tracker = ByteTracker(self.tracker.cfg, self.tracker.engine,
                                   self.frame_rate)
        self.tracker.det_thresh = self.new_thresh
        self.tracks = []

    def cmc_prefetch(self, cur_frame):
        """Forward the lockstep drivers' ECC prefetch to the inner
        ByteTracker, which owns the recipe and the warp hint."""
        return self.tracker.cmc_prefetch(cur_frame)

    def step(
        self,
        results: List[dict],
        frame=None,
        scale: float = 1.0,
    ) -> List[dict]:
        """One frame: dict detections (original coordinates), the frame
        BUSCA crops from (a host array or a tensor on a device, in detector
        coordinates) and its scale -> the output dict tracks."""
        boxes, scores = dicts_to_arrays(results)
        online = self.tracker.update(boxes, scores, scale, frame)
        out = []
        for t in online:
            bbox = t.tlbr
            out.append({
                "score": t.score,
                "bbox": bbox,
                "ct": [(bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2],
                "active": 1 if t.is_activated else 0,
                "tracking_id": t.track_id,
                "class": 1,
            })
        self.tracks = out
        return out
