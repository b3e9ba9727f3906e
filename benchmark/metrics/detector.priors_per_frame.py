"""``detector.priors_per_frame``: the prior centres a feedback detector
renders per frame (the program's counter ``detector.priors``, counted
inside each ``detector.prior`` span, over the spans recorded: a frame the
profiler's stop cuts after its render is counted on both sides)."""

from bmk.program_spans import program_trace


def read(run):
    pt = program_trace(run)
    if pt is None or "detector.priors" not in pt.counts:
        return None
    spans = pt.named("detector.prior")
    return pt.counts["detector.priors"] / len(spans) if spans else None
