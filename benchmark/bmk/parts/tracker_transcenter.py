"""TransCenter's tracker (``tracker.name`` "transcenter"): BYTE with the
track positions exported to the detector every frame.  The export changes
what the detector sees, not the tracker's update, so the reference tracker
that ``track_frames`` drives is BYTE's (``benchref.byte``, through the
``byte`` part); the detector's part makes its sampled calls again with the
positions the program fed back."""

from __future__ import annotations

from bmk.parts import part

_byte = part("tracker", "byte")
reference, start, replay = _byte.reference, _byte.start, _byte.replay
