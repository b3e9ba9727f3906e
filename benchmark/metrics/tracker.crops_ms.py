"""``tracker.crops_ms``: the trackers' host time per frame in their track
memories' crops (the program's ``tracker.crops`` spans: the crop op, K1 on
the card, and the crops' host copy)."""

from bmk.program_spans import per_frame


def read(run):
    return per_frame(
        run, lambda pt: pt.host_ms("tracker.crops", "tracker.update"))
