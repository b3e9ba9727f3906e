"""The TransCenter detector of a served configuration (``detector.kind``
"transcenter"): its weights, the program's ``TransCenterDetector`` built
by ``build_transcenter_detector`` at the configuration's dataset and
sampling, its recording wrapper, its numbers of the check
(``det_box_rel``, ``det_score``, ``det_unmatched`` against
``benchref/transcenter.py``) and its operations.

The detector takes the tracker's positions back every frame, so a sampled
call is kept with what the reference needs to make it again: the frame,
the previous canvas the program held and the positions it was given."""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

from bmk.probe import frozen

WEIGHTS_KEY = 4  # the draw key of ``weights.fill_`` (1-3 are taken)
# the configuration's model keys, which the program's preset must have
MODEL_KEYS = ("dims", "heads", "depths", "mlp_ratios", "sr_ratios",
              "hidden_dim", "num_decoder_layers", "dec_n_points", "dec_heads",
              "down_ratio", "num_classes", "K", "clip", "reid_dim", "dtype",
              "sampling")


def reference_config(d: dict):
    from benchref.transcenter import TransCenterConfig

    return TransCenterConfig(**{
        f.name: tuple(d[f.name]) if isinstance(d[f.name], list)
        else d[f.name] for f in dataclasses.fields(TransCenterConfig)})


def reference_detector(d: dict, device, state=None):
    """The reference detector of the configuration's ``detector`` group,
    holding ``state`` (filled from nothing where it is None)."""
    import torch

    from benchref.transcenter import RefTransCenter, TransCenterDETR

    with torch.device(device):
        model = TransCenterDETR(reference_config(d)).eval()
    if state is not None:
        model.load_state_dict(state)
    return RefTransCenter(model, tuple(d["test_size"]), d["out_thresh"])


# ---------------------------------------------------------------- weights --
def offset_grid(heads: int, levels: int, points: int):
    """Deformable DETR's offset bias: head h along its own direction
    (angle 2 pi h / heads, scaled to a unit max-norm), point p at p + 1
    level pixels along it."""
    import torch

    theta = torch.arange(heads, dtype=torch.float32) * (2 * math.pi / heads)
    g = torch.stack([theta.cos(), theta.sin()], -1)
    g = g / g.abs().max(-1, keepdim=True).values
    g = g[:, None, None, :].repeat(1, levels, points, 1)
    steps = torch.arange(1, points + 1, dtype=torch.float32)
    return (g * steps[None, None, :, None]).reshape(-1)


def draw(model, seed: int, cal: dict):
    """The weights drawn from ``seed``: ``weights.fill_``'s (lecun-normal
    matrices, unit norm scales, zero biases and level embeddings), then
    the deformable attention's offsets, zero in a flax-style init (all nine
    points on the query's own pixel): Deformable DETR's grid for the
    biases and ``offset_kernel_gain / sqrt(fan_in)`` for the kernels."""
    import torch

    from bmk.weights import fill_

    fill_(model, seed, WEIGHTS_KEY)
    cfg = model.config
    grid = offset_grid(cfg.dec_heads, 4, cfg.dec_n_points)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".offsets.bias"):
                p.copy_(grid.to(p.device))
            elif name.endswith(".offsets.weight"):
                p.mul_(float(cal["offset_kernel_gain"]))
    return model


def calibrate(ref, frame, cal: dict, track_thresh: float, crowd: int,
              box_scale: float):
    """The random detector's head on the stream's first frame (no priors,
    the frame as its own previous frame): ``wh_out.bias`` set to the
    crowd's mean box (``cal["box_hw"]`` frame pixels at 1080 rows, times
    ``box_scale``) in output-plane units, then ``hm_out.bias`` bisected
    until the count of detections above the tracker's high-score threshold
    + 0.1 equals the rendered crowd.  Returns the bias and its count."""
    import torch

    model = ref.model
    canvas, r = ref.canvas(frame)
    down = model.config.down_ratio
    box_h, box_w = (float(v) * box_scale for v in cal["box_hw"])
    with torch.no_grad():
        model.wh_out.bias.copy_(torch.tensor(
            [box_w * r / down, box_h * r / down]))
        model.hm_out.bias.zero_()
    maps = ref.maps(canvas, canvas, None)

    def count(bias):
        _, scores = ref.postprocess(dict(maps, hm=maps["hm"] + bias))
        return int((scores >= track_thresh + 0.1).sum())

    lo, hi = -100.0, 100.0  # the count rises with the bias
    for _ in range(int(cal["steps"])):
        mid = (lo + hi) / 2
        if count(mid) >= crowd:
            hi = mid
        else:
            lo = mid
    with torch.no_grad():
        model.hm_out.bias.fill_(hi)
    return hi, count(hi)


def make_weights(run) -> dict:
    """TransCenter drawn on the device from the configuration's weights
    seed and calibrated on the stream's first frame."""
    import sys

    from bmk import traffic, weights

    cfg, seed = run.config, int(run.config["weights_seed"])
    d = cfg["detector"]
    ref = reference_detector(d, run.device)
    draw(ref.model, seed, cfg["calibration"])
    (stream, *_) = traffic.streams(run.mix, seed)
    bias, n = calibrate(ref, stream.sequence.frame(0), cfg["calibration"],
                        float(cfg["tracker"]["kwargs"]["track_thresh"]),
                        int(run.mix["streams"][0]["objects"]),
                        stream.sequence.height / 1080.0)
    print(f"calibration: hm bias {bias:.6f}, {n} detections above the "
          f"high-score threshold + 0.1 on the first frame", file=sys.stderr)
    return weights.cpu_state(ref.model)


# ---------------------------------------------------------------- program --
def build(config: dict, state: dict, device):
    """The program's detector, ``build_transcenter_detector`` at the
    configuration's dataset preset and sampling; the preset must have the
    configuration's widths."""
    from busca_tpu_torch.eval.detector import build_transcenter_detector

    d = config["detector"]
    det = build_transcenter_detector(
        dataset=d["dataset"], sampling=d["sampling"],
        test_size=tuple(d["test_size"]), out_thresh=float(d["out_thresh"]),
        device=device)
    got = dataclasses.asdict(det.config)
    for k in MODEL_KEYS:
        want = tuple(d[k]) if isinstance(d[k], list) else d[k]
        have = tuple(got[k]) if isinstance(got[k], (list, tuple)) else got[k]
        if have != want:
            raise ValueError(f"the program's TransCenter {k} is {have!r}, "
                             f"the configuration states {want!r}")
    det.model.load_state_dict(state)
    return det


def wrap(det, rec):
    """Span the detector's calls and keep the sampled ones' frames, the
    previous canvas the program held (None on a stream's first frame),
    the positions it was given, and its rows (frame pixels)."""
    single = det.detect

    def detect(frame, current_pos=None):
        keep = rec.pick("detector")
        pre = det.state_dict()["pre_canvas"] if keep else None
        with rec.span("detector", frames=1):
            out = single(frame, current_pos=current_pos)
        rec.forward("detector", 1)
        if keep:
            rec.det_calls.append((
                np.array(frame, copy=True), pre,
                None if current_pos is None else np.array(current_pos,
                                                          copy=True),
                (out.boxes_tlbr / out.scale, frozen(out.scores))))
        return out

    det.detect = detect
    return det


# ------------------------------------------------------------------ check --
def gaps(run):
    """The sampled calls made again by the reference detector (the same
    frame, previous canvas and positions): each call's rows against the
    reference's, matched as YOLOX's are (``detector_yolox._frame_gaps``:
    the box-corner gap over the box's larger side, the score gap over
    matched rows, rows left unmatched away from the score threshold); a
    sample that compared nothing fails."""
    from bmk.parts import part

    d, limits = run.config["detector"], run.config["limits"]
    ref = reference_detector(d, run.device, run.states["detector"])
    frame_gaps = part("detector", "yolox")._frame_gaps
    box = score = 0.0
    unmatched = n = 0
    for frame, pre, pos, prog in run.rec.det_calls:
        b, s, u = frame_gaps(prog, ref.detect(frame, pre, pos),
                             float(d["out_thresh"]))
        box, score, unmatched = max(box, b), max(score, s), unmatched + u
        n += 1
    if not n:
        box = score = unmatched = float("inf")
    return [("det_box_rel", box, limits["det_box_rel"]),
            ("det_score", score, limits["det_score"]),
            ("det_unmatched", float(unmatched), limits["det_unmatched"])]


# ------------------------------------------------------------- operations --
@functools.lru_cache(maxsize=None)
def forward_operations(d_items: tuple) -> int:
    """One forward's operations: the reference model on meta tensors under
    ``FlopCounterMode`` (the two PVTv2-b2 passes, the projections, the
    decoder's linears and the heads; two operations a multiply-add) plus
    the MSDA calls' arithmetic (``bmk.msda``), which ``grid_sample`` does
    not report."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from benchref.transcenter import TransCenterDETR
    from bmk.msda import msda_operations, pyramid

    d = dict(d_items)
    cfg = reference_config(d)
    th, tw = d["test_size"]
    down = cfg.down_ratio
    with torch.device("meta"):
        model = TransCenterDETR(cfg).eval()
        x = torch.empty(1, th, tw, 3)
        hm = torch.empty(1, th // down, tw // down, 1)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(x, x, hm)
    levels = pyramid((th, tw))
    h4, w4 = levels[0]
    msda = msda_operations(1, h4 * w4, sum(h * w for h, w in levels),
                           cfg.dec_heads, len(levels), cfg.dec_n_points,
                           cfg.hidden_dim // cfg.dec_heads)
    return int(fc.get_total_flops()) + 2 * cfg.num_decoder_layers * msda


def flops(config: dict, frames: int):
    """One recorded call's operations: TransCenter on ``frames`` frames
    (each a current and a previous canvas), in the detector's dtype."""
    d = config["detector"]
    items = tuple((k, tuple(v) if isinstance(v, list) else v)
                  for k, v in sorted(d.items()))
    return forward_operations(items) * frames, d["dtype"]
