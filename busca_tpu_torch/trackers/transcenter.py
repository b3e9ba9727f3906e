"""TransCenter adapter: BYTE strategy + track-position feedback for the
query-based detector (port of ``busca_tpu.trackers.transcenter``).

TransCenter's detector is stateful: the tracker's current boxes are fed back
as center priors (``pre_cts``) for the next frame's queries
(adapters/TransCenter/tracking/byte_tracker.py:658-692,
models/transcenter.py:104-127, mot_evaluator.py:158).  This adapter adds
that feedback hook on top of the BYTE strategy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from busca_tpu_torch.trackers.base import joint_tracks
from busca_tpu_torch.trackers.byte import ByteTracker


class TransCenterByteTracker(ByteTracker):
    """ByteTracker with the detector-feedback position export."""

    def get_detector_positions(self) -> Optional[np.ndarray]:
        """Current track boxes (tlbr) for the detector's query priors.

        Mirrors ``get_transcenterdetr_pos`` (byte_tracker.py:658-692) at the
        settings the evaluation uses: tracked and lost tracks, scaled back
        to detector coordinates.  Returns None when there are no tracks,
        which the detector reads as "no priors".
        """
        pool = joint_tracks(self.tracked, self.lost)
        if not pool:
            return None
        return np.asarray([t.tlbr * t.scale for t in pool], dtype=np.float32)


def boxes_to_center_priors(
    boxes_tlbr: Optional[np.ndarray], down_ratio: int = 4
) -> Optional[np.ndarray]:
    """Convert feedback boxes to feature-map center priors (``pre_cts``), the
    detector-side transform (models/transcenter.py:104-127)."""
    if boxes_tlbr is None or len(boxes_tlbr) == 0:
        return None
    centers = (boxes_tlbr[:, :2] + boxes_tlbr[:, 2:]) / 2.0
    return centers / down_ratio
