"""``transcenter.backbone_ms``: the device time per frame of TransCenter's
PVTv2 over the current and the previous canvas and its input projections
(the program's ``transcenter.backbone`` spans, timed by their CUDA event
pair), over the ``detector.frame`` calls of the profiled window."""

from bmk.detector_frames import UNIT, per_detector_frame


def read(run):
    return per_detector_frame(
        run, lambda pt: pt.device_ms("transcenter.backbone", UNIT))
