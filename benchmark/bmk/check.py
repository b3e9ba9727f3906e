"""How ``correct`` is decided: the timed path's outputs against the plain
reference (``benchmark/benchref``), after the window, with the program's
state freed.

The numbers compared, each against the configuration's limit (a
detector's and an extractor's come from their parts, ``bmk/parts.py``):

- the detector's, for YOLOX ``det_box_rel`` / ``det_score`` /
  ``det_unmatched``: a sample of the detector's calls (frames drawn from
  the seed): each frame's rows against the reference detector on the same
  frame (largest box-corner gap over the box's larger side, largest score
  gap over matched rows, rows left unmatched);
- ``crop_gap``: a sample of the trackers' crop calls (K1 on the card)
  against the plain crop of the same frame and boxes;
- ``prob_gap``: a sample of the third rounds, and the largest, each worked
  out again from its requests (the tracks and detections as they stood at
  the call) by the reference engine on the reference BUSCA model: the
  program's probabilities before and after its post-processing against
  the reference's (a request answered with another's rows, or scored on
  the wrong memory, fails here);
- the extractor's, for the ReID ``feat_rel``: a sample of frames'
  detection features against the reference ReID on the plain crops of the
  frame at the detections' boxes (relative to the largest reference
  feature);
- ``track_frames``: every stream's replied tracks, frame by frame, against
  the reference tracker (the tracker's part) driven by the same detections and features, whose
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

from bmk import parts, weights


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


def reference_config(config: dict, module, cls):
    """A tracker part's reference configuration: ``cls`` (a dataclass of the
    reference copy ``module``) from the configuration's tracker options.
    An option of the program that the reference copy was cut without (its
    module's ``CUT``) is accepted only at a value where it does nothing;
    any other option it does not know is refused."""
    t = config["tracker"]
    known = {f.name for f in dataclasses.fields(cls)}
    for k, v in t["kwargs"].items():
        if k not in known and v not in module.CUT.get(k, ()):
            raise ValueError(f"the reference {t['name']} tracker does "
                             f"not run {k}={v!r}")
    cfg = cls(**{k: v for k, v in t["kwargs"].items() if k in known})
    cfg.crop_hw = tuple(config["busca"]["crop_hw"])
    cfg.use_busca = True
    return cfg


def _ref_tracker(config: dict):
    """The reference tracker's class and configuration, from the
    configuration's tracker part."""
    return parts.of(config, "tracker").reference(config)


def track_frames(run, win) -> Tuple[int, int]:
    """(frames whose tracks differ from the reference tracker's, frames
    compared) over every stream."""
    from benchref.base import Track

    rec, f = run.rec, run.config["output_filter"]
    tracker = parts.of(run.config, "tracker")
    cls, cfg = _ref_tracker(run.config)
    replay = ReplayEngine({k: list(v) for k, v in rec.assoc.items()})
    feats = ReplayFeatures(rec.extractor_outputs)
    bad = total = 0
    for name, replies in win.outputs.items():
        inputs = rec.tracker_inputs[name]
        Track.reset_id_counter()
        trk = tracker.start(cls, cfg, replay, feats)
        mine = []
        try:
            for k, (boxes, scores, scale, shape) in enumerate(
                    inputs[:len(replies)]):
                online = tracker.replay(
                    trk, (boxes, scores, scale, PixelFree(shape)), feats)
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


# ---------------------------------------------------- crops and third rounds --
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


def compare(run, win) -> List[Tuple[str, float, float]]:
    """Every number compared, with its limit, for this cell: the
    detector's, crops, third rounds, the extractor's, tracks."""
    limits = run.config["limits"]
    detector = parts.of(run.config, "detector")
    extractor = parts.of(run.config, "extractor")
    out = detector.gaps(run) if detector is not None else []
    gap, n = crop_gap(run)
    out.append(("crop_gap", gap if n else float("inf"), limits["crop_gap"]))
    gap, n = prob_gap(run)
    print(f"third rounds worked out again from their requests: {n}",
          file=sys.stderr)
    out.append(("prob_gap", gap, limits["prob_gap"]))
    if extractor is not None:
        out += extractor.gaps(run)
    bad, total = track_frames(run, win)
    out.append(("track_frames", float(bad) if total else float("inf"),
                limits["track_frames"]))
    return out
