"""``assoc.decide_ms``: the device time per third-round call of the
decision Transformer over the ReID features (the program's
``assoc.decide`` spans, timed by their CUDA event pair, launch gaps
included as for ``assoc.encode_ms``)."""

from bmk.program_spans import per_call


def read(run):
    return per_call(
        run, lambda pt: pt.device_ms("assoc.decide", "assoc.call"))
