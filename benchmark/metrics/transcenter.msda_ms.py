"""``transcenter.msda_ms``: the device time per frame of the decoder's
multi-scale deformable attention calls, two a layer (the program's
``transcenter.msda`` spans, each timed by its CUDA event pair: the op's
first to last work on the stream), over the ``detector.frame`` calls of
the profiled window."""

from bmk.detector_frames import UNIT, per_detector_frame


def read(run):
    return per_detector_frame(
        run, lambda pt: pt.device_ms("transcenter.msda", UNIT))
