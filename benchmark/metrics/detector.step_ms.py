"""``detector.step_ms``: device time per frame of the kernels launched under
the ``bench:detector`` range (``YoloxDetector.detect_batch`` / ``detect``:
letterbox through K1, YOLOX-X, decode, fixed-step NMS) in the profiled
window."""


def read(run):
    if run.device is None:
        return None
    frames = sum(s[4] for s in run.spans_of("detector")
                 if run.in_profiled(s[1]))
    t = run.range_device_seconds("detector")
    return t / frames * 1e3 if frames and t > 0 else None
