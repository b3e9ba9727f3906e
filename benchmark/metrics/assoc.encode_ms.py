"""``assoc.encode_ms``: the device time per third-round call of the ReID
ResNet-50 over the memory and candidate crops (the program's
``assoc.encode`` spans, timed by their CUDA event pair).  The pair spans
the encode's first to last work on the stream, so where the host launches
slower than the card runs (GHOST's one-track calls) the launch gaps count
too, and the reading rises under the profiler."""

from bmk.program_spans import per_call


def read(run):
    return per_call(
        run, lambda pt: pt.device_ms("assoc.encode", "assoc.call"))
