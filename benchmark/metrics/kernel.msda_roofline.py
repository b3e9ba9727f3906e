"""``kernel.msda_roofline``: multi-scale deformable attention's share of
its roofline in the profiled window: the sum over the op's calls of each
call's least time (the larger of its bytes over 3.35 TB/s and its float32
operations over 67 TFLOP/s, from the call's shapes, which the program's
``transcenter.msda`` span carries: ``bmk.msda.msda_least_seconds``) over
the device time of the work launched inside the op (each span's CUDA event
pair, the gaps between its kernels included)."""

from bmk.detector_frames import UNIT
from bmk.msda import SHAPE_KEYS, msda_least_seconds
from bmk.program_spans import program_trace


def read(run):
    pt = program_trace(run)
    spans = pt.named("transcenter.msda", UNIT) if pt is not None else []
    if not spans or any(s.device_ms is None or not s.attrs
                        or not set(SHAPE_KEYS) <= set(s.attrs)
                        for s in spans):
        return None
    seconds = sum(s.device_ms for s in spans) / 1e3
    least = sum(msda_least_seconds(s.attrs) for s in spans)
    return 100.0 * least / seconds if seconds > 0 else None
