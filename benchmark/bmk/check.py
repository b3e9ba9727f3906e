"""How ``correct`` is decided: the timed path's outputs against the plain
reference (``benchmark/benchref``), after the window, with the program's
state freed.

The numbers compared, each against the configuration's limit:

- ``det_box_rel`` / ``det_score`` / ``det_unmatched``: a sample of the
  detector's calls (frames drawn from the seed): each frame's rows against
  the reference detector on the same frame (largest box-corner gap over
  the box's larger side, largest score gap over matched rows, rows left
  unmatched);
- ``crop_gap``: a sample of the trackers' crop calls (K1 on the card)
  against the plain crop of the same frame and boxes;
- ``prob_gap``: a sample of the third rounds, and the largest, each worked
  out again from its requests (the tracks and detections as they stood at
  the call) by the reference engine on the reference BUSCA model: the
  program's probabilities before and after its post-processing against
  the reference's (a request answered with another's rows, or scored on
  the wrong memory, fails here);
- ``feat_rel``: a sample of frames' detection features against the
  reference ReID on the plain crops of the frame at the detections' boxes
  (relative to the largest reference feature);
- ``track_frames``: every stream's replied tracks, frame by frame, against
  the reference tracker driven by the same detections and features, whose
  third round is given the program's own results for the same request
  (ids compared after relabelling by first appearance, boxes exactly): it
  follows the program step by step, and ``prob_gap`` checks the step it
  takes on trust.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from bmk import weights


class PixelFree:
    """The frame as the reference tracker sees it: its shape, no pixels."""

    device = "cpu"

    def __init__(self, shape):
        self.shape = tuple(shape)


class Diverged(Exception):
    pass


class ReplayEngine:
    """The third round of the reference tracker: the program's result for
    the same request (its tracks' and detections' boxes bit for bit; equal
    requests are answered in the order the program made them)."""

    device = "cpu"
    bank = None

    def __init__(self, results: dict):
        self.results = results

    def center_distances(self, tracks, dets):
        from benchref import hostmath

        if len(tracks) == 0 or len(dets) == 0:
            return np.zeros((len(tracks), len(dets)))
        return hostmath.center_distance(np.stack([t.tlbr for t in tracks]),
                                        np.stack([d.tlbr for d in dets]))

    def associate(self, tracks, dets, dists_matrix=None, **_kw):
        from bmk.probe import assoc_key

        queue = self.results.get(assoc_key(tracks, dets))
        if not queue:
            raise Diverged("a third round the program did not make")
        return queue.pop(0)


class ReplayFeatures:
    """The program's ReID outputs, in the order it computed them."""

    def __init__(self, outputs):
        self.outputs = list(outputs)
        self.i = 0

    def __call__(self, crops):
        if self.i >= len(self.outputs):
            raise Diverged("more feature calls than the program made")
        out = self.outputs[self.i]
        self.i += 1
        if len(out) != len(crops):
            raise Diverged("a feature call of another size")
        return out


def filter_output_tracks(online, min_box_area, vertical_thresh):
    """Frozen copy of ``busca_tpu_torch/eval/runner.py::
    filter_output_tracks`` at commit c2c24f5."""
    out = []
    for t in online:
        tlwh = t.tlwh
        vertical = (vertical_thresh is not None and tlwh[3] > 0
                    and tlwh[2] / tlwh[3] > vertical_thresh)
        if tlwh[2] * tlwh[3] > min_box_area and not vertical:
            out.append([int(t.track_id), *map(float, tlwh)])
    return out


def relabel(frames: List[list]) -> List[list]:
    """Ids renumbered by first appearance in the stream."""
    ids: Dict[int, int] = {}
    out = []
    for tracks in frames:
        out.append([[ids.setdefault(int(t[0]), len(ids)), *t[1:]]
                    for t in tracks])
    return out


def _ref_tracker(config: dict):
    """The reference tracker's class and configuration.  An option of the
    program that the reference copy was cut without (its module's ``CUT``)
    is accepted only at a value where it does nothing; any other option it
    does not know is refused."""
    t = config["tracker"]
    crop_hw = tuple(config["busca"]["crop_hw"])

    def build(module, cls):
        known = {f.name for f in dataclasses.fields(cls)}
        for k, v in t["kwargs"].items():
            if k not in known and v not in module.CUT.get(k, ()):
                raise ValueError(f"the reference {t['name']} tracker does "
                                 f"not run {k}={v!r}")
        cfg = cls(**{k: v for k, v in t["kwargs"].items() if k in known})
        cfg.crop_hw = crop_hw
        cfg.use_busca = True
        return cfg

    if t["name"] == "byte":
        from benchref import byte

        return byte.ByteTracker, build(byte, byte.ByteTrackerConfig)
    if t["name"] == "ghost":
        from benchref import ghost

        return ghost.GhostTracker, build(ghost, ghost.GhostConfig)
    raise ValueError(f"no reference tracker {t['name']!r}")


def track_frames(run, win) -> Tuple[int, int]:
    """(frames whose tracks differ from the reference tracker's, frames
    compared) over every stream."""
    from benchref.base import Track

    rec, f = run.rec, run.config["output_filter"]
    cls, cfg = _ref_tracker(run.config)
    replay = ReplayEngine({k: list(v) for k, v in rec.assoc.items()})
    feats = ReplayFeatures(rec.extractor_outputs)
    bad = total = 0
    for name, replies in win.outputs.items():
        inputs = rec.tracker_inputs[name]
        Track.reset_id_counter()
        if cls.__name__ == "GhostTracker":
            trk = cls(cfg, replay, feats)
        else:
            trk = cls(cfg, replay)
        mine = []
        try:
            for k, (boxes, scores, scale, shape) in enumerate(
                    inputs[:len(replies)]):
                frame = PixelFree(shape)
                if cls.__name__ == "GhostTracker":
                    det_feats = (feats(boxes) if len(boxes)
                                 else np.eye(1, 16)[:0])
                    online = trk.update(boxes, scores, det_feats, frame)
                else:
                    online = trk.update(boxes, scores, scale, frame)
                mine.append(filter_output_tracks(
                    online, float(f["min_box_area"]), f["vertical_thresh"]))
        except Diverged as e:
            print(f"reference tracker of {name} stopped at frame {k + 1}: "
                  f"{e}", file=sys.stderr)
        want, got = relabel(replies), relabel(mine)
        first = None
        for k in range(len(want)):
            total += 1
            if k >= len(got) or got[k] != want[k]:
                bad += 1
                first = k if first is None else first
        if first is not None:
            print(f"tracks of {name} differ from frame {first + 1} on",
                  file=sys.stderr)
    return bad, total


# -------------------------------------------------------------- the models --
def _det_gaps(prog, ref, conf: float):
    """(box gap over box size, score, unmatched rows) of one frame: program
    rows matched
    greedily to reference rows by IoU >= 0.5, highest scores first; rows
    within 1e-3 of the confidence threshold may go unmatched."""
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


def detector_gaps(run):
    from benchref.detector import RefYolox

    d = run.config["detector"]
    model = weights.yolox_model(d, 0, run.device)
    model.load_state_dict(run.states["yolox"])
    ref = RefYolox(model, tuple(d["test_size"]), d["conf_thresh"],
                   d["nms_thresh"])
    box = score = 0.0
    unmatched = n = 0
    for frames, outs in run.rec.det_calls:
        for frame, prog in zip(frames, outs):
            b, s, u = _det_gaps(prog, ref.detect(frame),
                                float(d["conf_thresh"]))
            box, score, unmatched = max(box, b), max(score, s), unmatched + u
            n += 1
    return box, score, unmatched, n


def crop_gap(run):
    from benchref.crop import crop_resize_plain

    gap, n = 0.0, 0
    for frame, boxes, crop_hw, out in run.rec.crop_calls:
        f = torch.as_tensor(frame)
        want = crop_resize_plain(f, torch.as_tensor(boxes, device=f.device),
                                 crop_hw, quantize_uint8=True)
        if want.shape != out.shape:
            return float("inf"), n + 1
        if want.numel():
            per_box = (want - out.to(want.device)).abs().flatten(1).amax(1)
            if float(per_box.max()) > 0:
                _crop_witness(f, boxes, crop_hw, out, want, per_box)
            gap = max(gap, float(per_box.max()))
        n += 1
    return gap, n


def _crop_witness(frame, boxes, crop_hw, out, want, per_box):
    """Where a crop differs, what a reader needs to place the fault: the
    frame, the worst box, and the plain crop worked out again on the CPU
    (a second witness beside the one on the frame's device)."""
    from benchref.crop import crop_resize_plain

    k = int(per_box.argmax())
    cpu = crop_resize_plain(frame.cpu(), torch.as_tensor(boxes[k:k + 1]),
                            crop_hw, quantize_uint8=True)[0]
    off = (want[k].cpu() - out[k].cpu()).abs()
    print(f"crop witness: frame {tuple(frame.shape)} {frame.dtype} on "
          f"{frame.device}; {int((per_box > 0).sum())} of {len(boxes)} "
          f"crops differ; worst box {k} {boxes[k].tolist()} by "
          f"{float(per_box[k])} levels over {int((off > 0).sum())} of "
          f"{off.numel()} values; the plain crop on the CPU against the "
          f"card's plain crop {float((cpu - want[k].cpu()).abs().max())}, "
          f"against the program's {float((cpu - out[k].cpu()).abs().max())}",
          file=sys.stderr)


def _busca_ref(run):
    model = weights.busca_model(run.config["busca"], 0, run.device)
    model.load_state_dict(run.states["busca"])
    return model


def _result_gap(got, want) -> float:
    """Largest gap between two third-round answers ``(probs_matrix,
    reliable)``, request by request; inf where their structure differs."""
    if len(got) != len(want):
        return float("inf")
    gap = 0.0
    for (gp, gr), (wp, wr) in zip(got, want):
        if gp is None or wp is None:
            if gp is not None or wp is not None:
                return float("inf")
            continue
        if (np.shape(gp) != np.shape(wp)
                or not np.array_equal(np.asarray(gr, bool),
                                      np.asarray(wr, bool))):
            return float("inf")
        if np.size(gp):
            gap = max(gap, float(np.abs(np.asarray(gp, np.float64)
                                        - wp).max()))
    return gap


def _raw_gap(got, want) -> float:
    """Largest gap between the requests' probabilities before the
    post-processing; inf where their structure differs."""
    if len(got) != len(want):
        return float("inf")
    gap = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            return float("inf")
        if g.size:
            gap = max(gap, float(np.abs(g.astype(np.float64) - w).max()))
    return gap


def prob_gap(run):
    """(largest gap, third rounds compared): each kept third round worked
    out again from its requests by the reference engine."""
    from benchref.engine import ReferenceEngine

    rec = run.rec
    calls = list(rec.assoc_calls)
    if rec.largest_assoc is not None:
        calls.append(rec.largest_assoc)
    if not calls:
        return 0.0, 0
    kw = run.config["tracker"]["kwargs"]
    eng = ReferenceEngine(_busca_ref(run), seq_len=int(kw["seq_len"]),
                          num_candidates=int(kw["num_candidates"]),
                          crop_hw=tuple(run.config["busca"]["crop_hw"]))
    gap = 0.0
    for kind, held, opts, outs, raw in calls:
        eng.raw = []
        if kind == "one":
            ((tracks, dets, kal),) = held
            want = [eng.associate(tracks, dets,
                                  extra_kalman_candidates=kal, **opts)]
        else:
            want = eng.associate_many([(t, d, None, k) for t, d, k in held],
                                      **opts)
        gap = max(gap, _result_gap(outs, want), _raw_gap(raw, eng.raw))
    return gap, len(calls)


@torch.inference_mode()
def feat_rel(run):
    from benchref.busca import INPUT_PIXEL_MEAN_BGR, INPUT_PIXEL_STD_BGR
    from benchref.crop import crop_resize_plain

    if not run.rec.feat_calls:
        return 0.0, 0
    r = run.config["reid"]
    model = weights.reid_model(r, 0, run.device)
    model.load_state_dict(run.states["reid"])
    dev = run.device
    mean = torch.tensor(INPUT_PIXEL_MEAN_BGR.tolist(), device=dev)
    std = torch.tensor(INPUT_PIXEL_STD_BGR.tolist(), device=dev)
    c255 = torch.full((), 255.0, device=dev)
    worst = 0.0
    for frame, boxes, out in run.rec.feat_calls:
        f = torch.as_tensor(frame).to(dev)
        crops = crop_resize_plain(
            f, torch.as_tensor(boxes, dtype=torch.float32, device=dev),
            tuple(r["crop_hw"]), quantize_uint8=True)
        x = ((crops / c255 - mean) / std).flip(-1)
        want = model(x, output_option="plain")[1].float().cpu().numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        worst = max(worst, float(np.abs(out - want).max()) / scale)
    return worst, len(run.rec.feat_calls)


def compare(run, win) -> List[Tuple[str, float, float]]:
    """Every number compared, with its limit, for this cell."""
    limits = run.config["limits"]
    out = []
    if "detector" in run.config:
        box, score, unmatched, n = detector_gaps(run)
        if not n:  # a sample that compared nothing fails
            box = score = unmatched = float("inf")
        out += [("det_box_rel", box, limits["det_box_rel"]),
                ("det_score", score, limits["det_score"]),
                ("det_unmatched", float(unmatched), limits["det_unmatched"])]
    gap, n = crop_gap(run)
    out.append(("crop_gap", gap if n else float("inf"), limits["crop_gap"]))
    gap, n = prob_gap(run)
    print(f"third rounds worked out again from their requests: {n}",
          file=sys.stderr)
    out.append(("prob_gap", gap, limits["prob_gap"]))
    if "reid" in run.config:
        rel, n = feat_rel(run)
        out.append(("feat_rel", rel if n else float("inf"),
                    limits["feat_rel"]))
    bad, total = track_frames(run, win)
    out.append(("track_frames", float(bad) if total else float("inf"),
                limits["track_frames"]))
    return out
