"""The random YOLOX's calibration: a frozen copy of
``chip_smoke.py::calibrate_yolox`` at commit c2c24f5, run on the benchmark's
reference detector (``benchref.detector.RefYolox``) so that the weights
both sides load are the benchmark's own.

A random YOLOX's signal dies layer by layer, so the BN statistics are
measured on the cell's first frames and the obj bias is bisected on the
first frame until the count of detections above the tracker's
high-score threshold equals the stream's rendered crowd.
"""

from __future__ import annotations


def calibrate_yolox(det, frames, cal: dict, track_thresh: float,
                    first_dets: int):
    """Calibrate ``det`` on ``frames`` (BN statistics) and its first frame
    (the obj gain and bias); returns the gain and the bias it set."""
    import torch

    det.calibrate_random_weights(frames, 0.0, float(cal["cls_bias"]),
                                 tuple(cal["box_hw"]))
    preds = det.model.head.obj_preds
    weights = [p.weight.detach().clone() for p in preds]
    max_dets = int(round(first_dets * float(cal["max_dets_ratio"])))

    def counts(gain, bias):
        with torch.no_grad():
            for p, w in zip(preds, weights):
                p.weight.copy_(w * gain)
                p.bias.fill_(bias)
        scores = det.detect(frames[0])[1]
        return (int((scores >= track_thresh + 0.1).sum()),
                int((scores >= float(cal["conf"])).sum()))

    for gain in cal["obj_gains"]:
        lo, hi = -100.0, 100.0  # the counts rise with the bias
        for _ in range(int(cal["steps"])):
            mid = (lo + hi) / 2
            if counts(gain, mid)[0] >= first_dets:
                hi = mid
            else:
                lo = mid
        if counts(gain, hi)[1] <= max_dets:
            break
    return gain, hi
