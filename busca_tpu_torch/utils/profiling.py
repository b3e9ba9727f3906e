"""Tracing and profiling hooks (port of ``busca_tpu.utils.profiling``).

The reference has only wall-clock splits of forward and track time
(mot_evaluator.py:115-117, 177-189; CenterTrack's per-stage timing dict,
detector.py:160-182).  Here:

- :class:`StageTimer`: per-stage wall time, optionally synchronizing the
  card around each stage, for the per-frame breakdown (detect / crop /
  associate / assign / bookkeeping);
- :func:`trace`: ``torch.profiler`` around a block, written as a Chrome
  trace (busca_tpu's is a JAX profiler trace for TensorBoard);
- :func:`log_compile_times`: the port compiles its two kernels with nvcc
  at first use and traces programs with ``torch.export``; this logs each
  with its seconds (busca_tpu logs XLA's compilations).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict


class StageTimer:
    """Accumulates per-stage wall time.

    Example::

        timer = StageTimer(sync=True)
        with timer("reid"):
            feats = model(...)
        print(timer.report())

    ``sync=True`` waits for the current CUDA stream before and after each
    stage, so a stage is charged its device work (on the CPU every op is
    done when it returns, and nothing is waited for).
    """

    def __init__(self, sync: bool = False):
        self.sync = sync
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, stage: str):
        if self.sync:
            self._block()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                self._block()
            self.totals[stage] += time.perf_counter() - t0
            self.counts[stage] += 1

    @staticmethod
    def _block():
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.current_stream().synchronize()

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": self.totals[k],
                "calls": self.counts[k],
                "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1),
            }
            for k in sorted(self.totals)
        }

    def report(self) -> str:
        lines = []
        for k, v in self.summary().items():
            lines.append(
                f"{k:20s} {v['total_s']:8.3f}s total  "
                f"{v['mean_ms']:8.2f}ms/call  x{v['calls']}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the block (the card's kernels too when CUDA
    is available), written as ``<logdir>/trace.json`` (Chrome trace
    format: chrome://tracing or Perfetto)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def log_compile_times(enable: bool = True):
    """Log every nvcc build of a kernel (K1, K2) and every ``torch.export``
    trace with its seconds (the ``busca_tpu_torch.compile`` logger at
    INFO, to stderr unless it has a handler already)."""
    from busca_tpu_torch.ops.cuda_build import COMPILE_LOG

    COMPILE_LOG.setLevel(logging.INFO if enable else logging.WARNING)
    if enable and not COMPILE_LOG.handlers:
        COMPILE_LOG.addHandler(logging.StreamHandler())
