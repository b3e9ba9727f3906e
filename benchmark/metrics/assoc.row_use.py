"""``assoc.row_use``: the share of the track rows the third round's model
calls launch that hold a track (the program's counters ``assoc.tracks``
over ``assoc.rows``; the rest is bucket padding)."""

from bmk.program_spans import program_trace


def read(run):
    pt = program_trace(run)
    if pt is None or not pt.counts.get("assoc.rows"):
        return None
    return 100.0 * pt.counts.get("assoc.tracks", 0) / pt.counts["assoc.rows"]
