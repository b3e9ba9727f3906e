"""``assoc.mem_fold``: the share of the memory slots of the third round's
model calls that the ReID ResNet-50 did not encode: the program's counter
``assoc.mem_folded`` over ``assoc.rows`` (bucket padding included) times
the configuration's memory length.  Padding rows encode no memory, and a
request's incomplete memories share one zero crop.  A program without the
counter gives no reading."""

from bmk.program_spans import program_trace


def read(run):
    pt = program_trace(run)
    if (pt is None or not pt.counts.get("assoc.rows")
            or "assoc.mem_folded" not in pt.counts):
        return None
    seq_len = int(run.config["tracker"]["kwargs"]["seq_len"])
    return (100.0 * pt.counts["assoc.mem_folded"]
            / (pt.counts["assoc.rows"] * seq_len))
