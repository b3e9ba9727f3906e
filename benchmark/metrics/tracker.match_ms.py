"""``tracker.match_ms``: the trackers' host time per frame in their
association rounds (the program's ``tracker.match`` spans: distance and
IoU matrices, gating, the assignment; GHOST's appearance distances and its
gated assignment, without its thresholds' update and motion model)."""

from bmk.program_spans import per_frame


def read(run):
    return per_frame(
        run, lambda pt: pt.host_ms("tracker.match", "tracker.update"))
