"""Readings per detector frame from the program's spans: the spans inside
the calls of ``detector.frame`` (a single-frame detector's ``detect``)
that lie in the profiled window, over the count of those calls.  A
program without such spans gives None, and its readers find nothing."""

from __future__ import annotations

from typing import Callable, Optional

from bmk.program_spans import ProgramTrace, program_trace

UNIT = "detector.frame"


def per_detector_frame(run, value: Callable[[ProgramTrace], Optional[float]]
                       ) -> Optional[float]:
    """``value(trace)`` per ``detector.frame`` call in the window, or None;
    ``value`` reads the spans of those calls (``unit=UNIT``)."""
    pt = program_trace(run)
    frames = len(pt.named(UNIT)) if pt is not None else 0
    if not frames:
        return None
    v = value(pt)
    return None if v is None else v / frames
