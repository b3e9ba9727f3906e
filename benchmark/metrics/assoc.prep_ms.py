"""``assoc.prep_ms``: the third round's host preparation per call, the
program's ``assoc.prep`` spans' own time (request prep and dedup grouping,
the padded arrays' staging, their upload) per ``assoc.call``."""

from bmk.program_spans import per_call


def read(run):
    return per_call(
        run, lambda pt: pt.self_ms("assoc.prep", "assoc.call"))
