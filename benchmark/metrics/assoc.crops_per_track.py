"""``assoc.crops_per_track``: crops through the third round's ReID
ResNet-50 per track scored (the program's counters ``assoc.crops``, the
memory rows times their length plus the padded unique candidates, over
``assoc.tracks``)."""

from bmk.program_spans import program_trace


def read(run):
    pt = program_trace(run)
    if pt is None or not pt.counts.get("assoc.tracks"):
        return None
    return pt.counts.get("assoc.crops", 0) / pt.counts["assoc.tracks"]
