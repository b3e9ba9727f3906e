"""The program's own spans and counters in a traced run: what
``busca_tpu_torch/utils/profiling.py``'s recorder holds, read by the
per-layer metrics of the program's layers (``benchmark/metrics``).

The recorder records while a ``torch.profiler`` session records in the
process, so a traced run's recorder holds the profiled window.  The first
reader drains it and keeps what it drained on the run for the others.  A
program without the recorder gives None, and its readers then find
nothing.  Spans carry ``perf_counter_ns`` times, the clock that
``DeviceTrace.offset_ns`` maps onto the device timeline.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from bmk.tracing import union


class ProgramTrace:
    """The drained spans that lie inside the profiled window, and the
    counters.  A span still open when the window closes is left out of
    the per-span readings, which would read the profiler's stop with it;
    for the idle attribution it counts as open up to the window's end.
    A reading per call or per frame takes only the spans of the calls or
    frames that lie inside the window, so its sum and its count cover the
    same ones."""

    def __init__(self, spans, counts: Dict[str, int], profiled):
        lo, hi = (int(t * 1e9) for t in profiled)
        ended = [s for s in spans if s.t1 is not None]
        self._by_id = {s.id: s for s in ended}
        self.spans = [s for s in ended if lo <= s.t0 and s.t1 <= hi]
        self._inside = {s.id for s in self.spans}
        self._open = union((max(s.t0, lo), min(s.t1, hi)) for s in ended
                           if s.t0 < hi and s.t1 > lo)
        self.counts = dict(counts)
        self._kids = defaultdict(list)
        for s in self.spans:
            if s.parent is not None:
                self._kids[s.parent].append(s)

    def named(self, name: str, unit: Optional[str] = None) -> list:
        """The spans ``name`` in the window; with ``unit``, only those whose
        outermost enclosing ``unit`` span (a call, a frame's first step)
        lies in the window too, or that have none."""
        got = [s for s in self.spans if s.name == name]
        return got if unit is None else [s for s in got
                                         if self._in_unit(s, unit)]

    def _in_unit(self, s, unit: str) -> bool:
        top = None
        while s.parent is not None:
            s = self._by_id.get(s.parent)
            if s is None:
                return False  # an ancestor that never ended
            if s.name == unit:
                top = s
        return top is None or top.id in self._inside

    def host_ms(self, name: str, unit: Optional[str] = None) -> float:
        """The spans ``name``'s host time, summed, in ms."""
        return sum(s.t1 - s.t0 for s in self.named(name, unit)) / 1e6

    def self_ms(self, name: str, unit: Optional[str] = None) -> float:
        """The spans ``name``'s host time less their children's, in ms."""
        total = 0
        for s in self.named(name, unit):
            kids = union((k.t0, k.t1) for k in self._kids[s.id]
                         if k.thread == s.thread)
            total += (s.t1 - s.t0) - sum(
                max(0, min(b, s.t1) - max(a, s.t0)) for a, b in kids)
        return total / 1e6

    def device_ms(self, name: str,
                  unit: Optional[str] = None) -> Optional[float]:
        """The spans ``name``'s device time, summed (None where a span has
        none: no CUDA events).  A span's device time runs from its first to
        its last work on the stream: where its launches outpace nothing
        (a launch-bound block), the gaps between them count too."""
        spans = self.named(name, unit)
        if not spans or any(s.device_ms is None for s in spans):
            return None
        return sum(s.device_ms for s in spans)

    def frames(self) -> int:
        """Frames the trackers took up: each update's first step (a
        deferred update's resumptions carry ``resumed``)."""
        return sum(1 for s in self.named("tracker.update") if not s.attrs)

    def calls(self) -> int:
        """Third-round calls (``associate`` / ``associate_many``)."""
        return len(self.named("assoc.call"))

    def intervals_ns(self) -> List[Tuple[int, int]]:
        """Where any span was open in the window, on the host clock,
        merged."""
        return self._open


_NONE = object()


def program_trace(run) -> Optional[ProgramTrace]:
    """The run's :class:`ProgramTrace`, drained once; None without the
    recorder, or with nothing recorded."""
    got = getattr(run, "_program_trace", _NONE)
    if got is _NONE:
        got = None
        try:
            from busca_tpu_torch.utils.profiling import drain
        except ImportError:
            drain = None
        if drain is not None and run.profiled is not None:
            rec = drain()
            if rec.spans or rec.counts:
                got = ProgramTrace(rec.spans, rec.counts, run.profiled)
        run._program_trace = got
    return got


def per_call(run, value) -> Optional[float]:
    """``value(trace)`` per third-round call, or None; ``value`` reads the
    spans of the calls inside the window (``unit="assoc.call"``)."""
    pt = program_trace(run)
    if pt is None or not pt.calls():
        return None
    v = value(pt)
    return None if v is None else v / pt.calls()


def per_frame(run, value) -> Optional[float]:
    """``value(trace)`` per frame, or None; ``value`` reads the spans of
    the frames inside the window (``unit="tracker.update"``)."""
    pt = program_trace(run)
    if pt is None or not pt.frames():
        return None
    return value(pt) / pt.frames()


def subtract(intervals, cover) -> int:
    """The length of ``intervals`` (merged, sorted) outside ``cover``
    (merged, sorted)."""
    total, j = 0, 0
    for a, b in intervals:
        t = a
        while j < len(cover) and cover[j][1] <= t:
            j += 1
        k = j
        while t < b:
            if k < len(cover) and cover[k][0] < b:
                c0, c1 = cover[k]
                if c0 > t:
                    total += c0 - t
                t = max(t, c1)
                k += 1
            else:
                total += b - t
                t = b
    return total
