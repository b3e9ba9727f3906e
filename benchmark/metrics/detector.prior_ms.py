"""``detector.prior_ms``: the host time per frame that a feedback
detector spends rendering the tracker's positions into its prior heatmap
and uploading it (the program's ``detector.prior`` spans), over the
``detector.frame`` calls of the profiled window."""

from bmk.detector_frames import UNIT, per_detector_frame


def read(run):
    return per_detector_frame(
        run, lambda pt: pt.host_ms("detector.prior", UNIT))
