"""``device.idle_unattributed``: the share of the device's idle time in the
profiled window during which no program span was open on any thread (the
kernels' union against the program's spans, placed on the device timeline
by the profiler's clock anchor)."""

from bmk.program_spans import program_trace, subtract
from bmk.tracing import union


def read(run):
    pt, dev = program_trace(run), run.device
    if pt is None or dev is None or not dev.kernels \
            or dev.offset_ns is None:
        return None
    lo, hi = (int(t * 1e9) + dev.offset_ns for t in run.profiled)
    busy = union((max(a, lo), min(b, hi)) for _n, a, b, _c in dev.kernels
                 if b > lo and a < hi)
    edges = [lo] + [t for iv in busy for t in iv] + [hi]
    idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    total = sum(b - a for a, b in idle)
    if total <= 0:
        return None
    cover = [(a + dev.offset_ns, b + dev.offset_ns)
             for a, b in pt.intervals_ns()]
    return 100.0 * subtract(idle, cover) / total
