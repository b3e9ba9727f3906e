"""Prefetching frame loader: JPEG decode overlaps tracking (port of
``busca_tpu.eval.loader``; cv2 is imported where frames are decoded, so the
module imports on a host without it).

The reference decodes frames inline in the eval loop (cv2.imread per frame,
deep_sort_app.py:173-175; torch DataLoader workers in the ByteTrack path,
exps/transcenterdetr_base.py:24 ``num_workers``).  Here a background thread
pool decodes ahead of the consumer so the host-side image IO (~10-20 ms per
1080p JPEG) overlaps the device compute and tracker bookkeeping — the
host-side half of the pipeline (device-side upload prefetch lives in
eval/detector.py ``YoloxDetector.put_frame``).

Order is preserved; backpressure via a bounded queue keeps at most
``prefetch`` decoded frames in memory.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np


class FramePrefetcher:
    """Iterate decoded frames with background decoding.

    Args:
      paths: image file paths in playback order.
      prefetch: max decoded frames buffered ahead.
      num_workers: decoder threads (cv2 releases the GIL during imdecode).
    """

    def __init__(
        self,
        paths: Sequence[str],
        prefetch: int = 4,
        num_workers: int = 2,
    ):
        self.paths = list(paths)
        self.prefetch = max(1, prefetch)
        self.num_workers = max(1, num_workers)

    def __len__(self):
        return len(self.paths)

    def __iter__(self) -> Iterator[Optional[np.ndarray]]:
        import cv2

        n = len(self.paths)
        if n == 0:
            return
        slots: list = [None] * n
        done = [False] * n
        cond = threading.Condition()
        next_to_decode = [0]
        next_to_emit = [0]
        stop = [False]

        def worker():
            while True:
                with cond:
                    while (
                        not stop[0]
                        and (
                            next_to_decode[0] >= n
                            or next_to_decode[0]
                            - next_to_emit[0] >= self.prefetch
                        )
                    ):
                        if next_to_decode[0] >= n:
                            return
                        cond.wait(0.05)
                    if stop[0]:
                        return
                    idx = next_to_decode[0]
                    next_to_decode[0] += 1
                img = cv2.imread(self.paths[idx])
                with cond:
                    slots[idx] = img
                    done[idx] = True
                    cond.notify_all()

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(self.num_workers)
        ]
        for t in threads:
            t.start()
        try:
            for i in range(n):
                with cond:
                    while not done[i]:
                        cond.wait(0.05)
                    img = slots[i]
                    slots[i] = None  # free memory as we go
                    next_to_emit[0] = i + 1
                    cond.notify_all()
                yield img
        finally:
            with cond:
                stop[0] = True
                cond.notify_all()
            for t in threads:
                t.join(timeout=1.0)


def sequence_frames(seq_info, prefetch: int = 4, num_workers: int = 2):
    """Prefetching frame iterator for a MOTChallenge ``SeqInfo``."""
    paths = [
        seq_info.frame_path(f) for f in range(1, seq_info.seq_length + 1)
    ]
    return FramePrefetcher(paths, prefetch, num_workers)
