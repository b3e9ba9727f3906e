"""``transcenter.decoder_ms``: the device time per frame of TransCenter's
dense queries through its decoder layers and final norm, the MSDA calls
included (the program's ``transcenter.decoder`` spans, timed by their CUDA
event pair), over the ``detector.frame`` calls of the profiled window."""

from bmk.detector_frames import UNIT, per_detector_frame


def read(run):
    return per_detector_frame(
        run, lambda pt: pt.device_ms("transcenter.decoder", UNIT))
