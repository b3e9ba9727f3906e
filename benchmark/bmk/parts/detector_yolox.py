"""The YOLOX detector of a served configuration (``detector.kind`` "yolox"):
its weights, the program's ``YoloxDetector``, its recording wrapper, its
numbers of the check (``det_box_rel``, ``det_score``, ``det_unmatched``)
and its operations."""

from __future__ import annotations

import numpy as np

from bmk.probe import frozen


# ---------------------------------------------------------------- weights --
def reference_model(det_cfg: dict, seed: int, device):
    """The reference YOLOX of the configuration, filled (not calibrated)."""
    import torch

    from benchref.yolox import YOLOX, YoloxConfig
    from bmk.weights import fill_

    cfg = YoloxConfig.size(det_cfg["size"],
                           num_classes=int(det_cfg["num_classes"]),
                           dtype=det_cfg["dtype"])
    with torch.device(device):
        model = YOLOX(cfg)
    return fill_(model, seed, 1,
                 prior_on=("head.obj_preds", "head.cls_preds")).eval()


def calibrate(det, frames, cal: dict, track_thresh: float, first_dets: int):
    """The random YOLOX's calibration, a frozen copy of
    ``chip_smoke.py::calibrate_yolox`` at commit c2c24f5, run on the
    benchmark's reference detector so that the weights both sides load are
    the benchmark's own.

    A random YOLOX's signal dies layer by layer, so the BN statistics are
    measured on ``frames`` and the obj bias is bisected on the first frame
    until the count of detections above the tracker's high-score threshold
    equals the stream's rendered crowd; returns the gain and the bias it
    set."""
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


def _reference(model, d: dict):
    from benchref.detector import RefYolox

    return RefYolox(model, tuple(d["test_size"]), d["conf_thresh"],
                    d["nms_thresh"])


def make_weights(run) -> dict:
    """YOLOX drawn on the device from the configuration's weights seed and
    calibrated on the streams' first frames."""
    from bmk import traffic, weights

    cfg, seed = run.config, int(run.config["weights_seed"])
    d = cfg["detector"]
    model = reference_model(d, seed, run.device)
    ref = _reference(model, d)
    firsts = [s.sequence.frame(0) for s in traffic.streams(run.mix, seed)]
    calibrate(ref, firsts, cfg["calibration"],
              float(cfg["tracker"]["kwargs"]["track_thresh"]),
              int(run.mix["streams"][0]["objects"]))
    state = weights.cpu_state(model)
    del model, ref
    return state


# ---------------------------------------------------------------- program --
def build(config: dict, state: dict, device):
    from busca_tpu_torch.eval.detector import YoloxDetector
    from busca_tpu_torch.models.yolox import YoloxConfig

    d = config["detector"]
    cfg = YoloxConfig.size(d["size"], num_classes=int(d["num_classes"]),
                           dtype=d["dtype"])
    return YoloxDetector(cfg, state_dict=state,
                         test_size=tuple(d["test_size"]),
                         conf_thresh=float(d["conf_thresh"]),
                         nms_thresh=float(d["nms_thresh"]), device=device)


def wrap(det, rec):
    """Span the detector's calls and keep the sampled ones' frames and
    rows (frame pixels)."""
    batch, single = det.detect_batch, det.detect

    def keep(frames, outs):
        if rec.pick("detector"):
            rec.det_calls.append(([np.array(f, copy=True) for f in frames], [
                (o.boxes_tlbr / o.scale, frozen(o.scores)) for o in outs]))

    def detect_batch(frames):
        with rec.span("detector", frames=len(frames)):
            outs = batch(frames)
        rec.forward("detector", len(frames))
        keep(frames, outs)
        return outs

    def detect(frame, **kw):
        with rec.span("detector", frames=1):
            out = single(frame, **kw)
        rec.forward("detector", 1)
        keep([frame], [out])
        return out

    det.detect_batch, det.detect = detect_batch, detect
    return det


# ------------------------------------------------------------------ check --
def _frame_gaps(prog, ref, conf: float):
    """(box gap over box size, score, unmatched rows) of one frame: program
    rows matched greedily to reference rows by IoU >= 0.5, highest scores
    first; rows within 1e-3 of the confidence threshold may go
    unmatched."""
    from benchref.hostmath import iou_matrix

    (pb, ps), (rb, rs) = prog, ref
    box = score = 0.0
    # a box's gap relative to its size: a random regression head's boxes
    # reach thousands of pixels, where float32's last bits are pixels
    size = np.maximum(np.maximum(rb[:, 2] - rb[:, 0], rb[:, 3] - rb[:, 1]),
                      1.0) if len(rb) else np.zeros(0)
    unmatched = 0
    free = np.ones(len(rb), bool)
    if len(pb) and len(rb):
        iou = iou_matrix(pb, rb)
    for i in np.argsort(-ps, kind="stable"):
        j = -1
        if len(rb):
            cand = np.where(free, iou[i], -1.0)
            j = int(np.argmax(cand))
            if cand[j] < 0.5:
                j = -1
        if j < 0:
            unmatched += int(ps[i] >= conf + 1e-3)
            continue
        free[j] = False
        box = max(box, float(np.abs(pb[i] - rb[j]).max() / size[j]))
        score = max(score, abs(float(ps[i] - rs[j])))
    unmatched += int(np.sum(free & (rs >= conf + 1e-3)))
    return box, score, unmatched


def gaps(run):
    """The sampled detector calls, each frame's rows against the reference
    detector on the same frame: the largest box-corner gap over the box's
    larger side, the largest score gap over matched rows, and the rows left
    unmatched; a sample that compared nothing fails."""
    d, limits = run.config["detector"], run.config["limits"]
    model = reference_model(d, 0, run.device)
    model.load_state_dict(run.states["detector"])
    ref = _reference(model, d)
    box = score = 0.0
    unmatched = n = 0
    for frames, outs in run.rec.det_calls:
        for frame, prog in zip(frames, outs):
            b, s, u = _frame_gaps(prog, ref.detect(frame),
                                  float(d["conf_thresh"]))
            box, score, unmatched = max(box, b), max(score, s), unmatched + u
            n += 1
    if not n:
        box = score = unmatched = float("inf")
    return [("det_box_rel", box, limits["det_box_rel"]),
            ("det_score", score, limits["det_score"]),
            ("det_unmatched", float(unmatched), limits["det_unmatched"])]


def flops(config: dict, frames: int):
    """One recorded call's operations: YOLOX on ``frames`` canvases."""
    from bmk.flops import yolox_flops

    d = config["detector"]
    return (yolox_flops(d["size"], int(d["num_classes"]),
                        tuple(d["test_size"])) * frames, d["dtype"])
