"""Quantifying the frozen-stats ReID deviation (``reid_stats='frozen'``;
port of ``busca_tpu.eval.frozen_delta``).

The frozen-stats serving mode (PARITY.md "Frozen-stats ReID") replaces the
reference's batch-stat BN domain adaptation (busca/network.py:554-556) with
the checkpoint's stored running statistics so features become cacheable
across frames, at the price of a real accuracy deviation.  This module
measures how much of one, on the synthetic benchmarks:

- **decision-flip rate**: every third-round association is scored by BOTH
  engines at identical inputs (the tracker state is driven by the
  reference-exact batch mode); flips = rows whose argmax candidate differs,
  plus rows whose rescue verdict (Kalman column > ``busca_thresh``) differs.
- **metric delta**: the dropout-rescue benchmark tracked end-to-end in each
  mode (MOTA / HOTA / IDF1 / FN / ID-switch deltas).

Running statistics for the demo-trained model come from
:func:`calibrate_batch_stats`: the exact population statistics of a
calibration crop set, pooled per BN while the net runs in batch-stat mode
(``models/reid.py::collect_bn_calibration``) — the same quantity a torch
training run accumulates as its BN running averages (converted ``.pth``
checkpoints carry these directly).

CLI (on the card unless ``--device cpu``)::

    python -m busca_tpu_torch.eval.frozen_delta [--shift both] [--device cpu]
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Iterable, Sequence

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Running-statistics calibration
# ---------------------------------------------------------------------------

def calibrate_batch_stats(model, crop_batches: Iterable, load: bool = False
                          ) -> Dict[str, torch.Tensor]:
    """Estimate frozen-mode running BN statistics from calibration crops.

    Args:
      model: a :class:`~busca_tpu_torch.models.busca.BuscaModel`, in either
        BN mode.  A copy of its ReID runs with batch statistics, so the
        model itself is not changed unless ``load``.
      crop_batches: iterable of *prepped* crops ``[N, H, W, 3]`` float32 in
        model-input space (GHOST-normalized, RGB), numpy or tensors — e.g.
        the training distribution.  Statistics are pooled exactly across
        all batches (float64 sums of each BN's count, sum and sum of
        squares, busca_tpu's ``bn_calib`` aggregates).
      load: also copy the statistics into ``model``'s BN buffers.

    Returns:
      ``{"reid_encoder.model.<bn>.running_mean"/"running_var": float32
      tensor}`` on the model's device: the buffers busca_tpu's
      ``batch_stats`` tree holds (``mean = sum_x / n``, ``var = max(sum_x2
      / n - mean^2, 0)``).
    """
    from busca_tpu_torch.models.reid import BatchNorm, collect_bn_calibration

    reid = copy.deepcopy(model.reid_encoder.model)
    for m in reid.modules():
        if isinstance(m, BatchNorm):
            m.use_batch_stats = True
    device = next(reid.parameters()).device
    with collect_bn_calibration(reid) as calib, torch.inference_mode():
        for batch in crop_batches:
            if not isinstance(batch, torch.Tensor):
                batch = torch.from_numpy(np.asarray(batch, np.float32))
            reid(batch.to(device, torch.float32))
    if not any(calib.values()):
        raise ValueError("calibrate_batch_stats needs at least one batch")
    stats = {}
    for name, entries in calib.items():
        n, sum_x, sum_x2 = (sum(e[k] for e in entries) for k in range(3))
        mean = sum_x / n
        var = torch.clamp(sum_x2 / n - mean * mean, min=0.0)
        key = f"reid_encoder.model.{name}."
        stats[key + "running_mean"] = mean.to(device, torch.float32)
        stats[key + "running_var"] = var.to(device, torch.float32)
    if load:
        buffers = dict(model.named_buffers())
        if set(stats) - set(buffers):
            raise RuntimeError("calibrated statistics do not match the "
                               "model's BN buffers")
        with torch.no_grad():
            for k, v in stats.items():
                buffers[k].copy_(v)
    return stats


def frozen_model(config, model):
    """A frozen-BN twin of ``model``: ``config`` with
    ``reid_use_batch_stats=False``, ``model``'s parameters and buffers
    copied, on its device, in eval mode.  ``model`` is not changed."""
    from busca_tpu_torch.models.busca import BuscaModel

    twin = BuscaModel(dataclasses.replace(config, reid_use_batch_stats=False))
    twin.load_state_dict(model.state_dict())
    return twin.to(next(model.parameters()).device).eval()


# ---------------------------------------------------------------------------
# Dual-engine decision recorder
# ---------------------------------------------------------------------------

class DualEngine:
    """Score every association through BOTH engines at identical inputs.

    The tracker's state is driven by the *batch* (reference-exact) result;
    the frozen result is only compared, so flip counts measure the deviation
    at identical tracker states: the decision-flip rate.  Drop-in for ``AssociationEngine`` where trackers use it
    (``associate`` + ``center_distances``).
    """

    def __init__(self, batch_engine, frozen_engine, rescue_thresh: float = 0.5):
        self.batch = batch_engine
        self.frozen = frozen_engine
        self.rescue_thresh = float(rescue_thresh)
        self.stats = {
            "calls": 0,
            "rows": 0,                 # reliable decision rows compared
            "argmax_flips": 0,         # rows whose winning candidate differs
            "rescue_rows": 0,          # rows with a Kalman column
            "rescue_flips": 0,         # rows whose rescue verdict differs
            "rescues_batch": 0,
            "rescues_frozen": 0,
        }

    @property
    def device(self):
        """The device the trackers put frames on (the batch engine's)."""
        return self.batch.device

    # trackers fetch either name (trackers/base.py::run_third_round)
    def center_distances(self, tracks, dets):
        return self.batch.center_distances(tracks, dets)

    _center_distances = center_distances

    def associate(self, tracks, dets, dists_matrix=None, **kw):
        pb, rb = self.batch.associate(tracks, dets, dists_matrix, **kw)
        pf, rf = self.frozen.associate(tracks, dets, dists_matrix, **kw)
        if pb is None or pf is None:
            return pb, rb
        self.stats["calls"] += 1
        n_dets = len(dets)
        s = self.stats
        for i in range(pb.shape[0]):
            if not rb[i]:
                continue
            s["rows"] += 1
            # decision columns a tracker actually consumes for row i: the
            # detection columns plus the row's OWN Kalman column — other
            # tracks' Kalman columns (n_dets + k, k != i) never feed a
            # decision, so a noise swap there must not count as a flip
            kal_col = n_dets + i
            cols = list(range(n_dets))
            if kal_col < pb.shape[1]:
                cols.append(kal_col)
            if cols and int(np.argmax(pb[i, cols])) != int(
                np.argmax(pf[i, cols])
            ):
                s["argmax_flips"] += 1
            if kal_col < pb.shape[1]:
                s["rescue_rows"] += 1
                wb = pb[i, kal_col] > self.rescue_thresh
                wf = pf[i, kal_col] > self.rescue_thresh
                s["rescues_batch"] += int(wb)
                s["rescues_frozen"] += int(wf)
                s["rescue_flips"] += int(wb != wf)
        return pb, rb

    def summary(self) -> Dict[str, float]:
        s = dict(self.stats)
        s["argmax_flip_rate"] = (
            s["argmax_flips"] / s["rows"] if s["rows"] else 0.0
        )
        s["rescue_flip_rate"] = (
            s["rescue_flips"] / s["rescue_rows"] if s["rescue_rows"] else 0.0
        )
        return s


# ---------------------------------------------------------------------------
# The measurement harness
# ---------------------------------------------------------------------------

def _random_dropout_sequence(seed: int, num_frames: int,
                             n_drop: int = 1, drop_len: int = 6,
                             warm: int = 10):
    """A randomized multi-object sequence with staggered dropout windows.

    ``n_drop`` objects each get one ``drop_len``-frame detector dropout,
    staggered after ``warm`` frames (the memory warm-up: a track needs
    ``seq_len`` admissions before its third-round rows count as reliable).
    More windows = more third-round decisions per sequence, which the
    domain-shift measurement needs to reach its sample-size target."""
    from busca_tpu_torch.eval.synthetic import (
        SyntheticObject,
        SyntheticSequence,
    )

    rng = np.random.RandomState(seed)
    colors = [
        np.array([40, 200, 60], np.float64),
        np.array([210, 60, 180], np.float64),
        np.array([60, 120, 230], np.float64),
    ]
    n_drop = min(n_drop, len(colors))
    span = max(num_frames - warm - drop_len - 4, 1)
    objs = []
    for i, color in enumerate(colors):
        x0 = float(rng.uniform(20, 300))
        y0 = float(rng.uniform(40, 160))
        vx = float(rng.uniform(-3, 3))
        vy = float(rng.uniform(-1, 1))
        w = float(rng.uniform(30, 45))
        h = float(rng.uniform(60, 90))
        drop = (0, 0)
        if i < n_drop:
            lo = warm + (i * span) // max(n_drop, 1)
            hi = warm + ((i + 1) * span) // max(n_drop, 1)
            start = int(rng.randint(lo, max(hi, lo + 1)))
            drop = (start, min(start + drop_len, num_frames - 4))
        objs.append(SyntheticObject(color=color, x0=x0, y0=y0, vx=vx, vy=vy,
                                    w=w, h=h, dropout=drop))
    return SyntheticSequence(objs, num_frames=num_frames, seed=seed)


def shift_transform(kind: str):
    """Deterministic photometric domain shifts for the calibrate-on-A /
    deploy-on-B arm (the caveat the PARITY.md frozen-mode decision rule
    hedges on: batch-stat BN adapts to the deployment distribution per
    batch, network.py:554-556; frozen stats cannot).  Deterministic so the
    mode delta is not confounded with transform noise."""
    if kind in (None, "none"):
        return None
    if kind == "dim":
        # low light: contrast 0.65, brightness -40, blue-shifted gains
        gains = np.array([1.10, 0.75, 0.60], np.float32)  # BGR

        def f(frame):
            x = frame.astype(np.float32)
            x = (x - 128.0) * 0.65 + 128.0 - 40.0
            x = x * gains
            return np.clip(x, 0, 255).astype(np.uint8)

        return f
    if kind == "glare":
        # overexposure: contrast 0.8, brightness +70, warm gains
        gains = np.array([0.85, 1.05, 1.20], np.float32)

        def f(frame):
            x = frame.astype(np.float32)
            x = (x - 128.0) * 0.8 + 128.0 + 70.0
            x = x * gains
            return np.clip(x, 0, 255).astype(np.uint8)

        return f
    raise ValueError(f"unknown shift {kind!r}")


def _track_sequence(seq, engine, *, seq_len, num_candidates, crop_hw,
                    frames=None, dets=None, mem_cap=None,
                    use_broader_memory=False):
    from busca_tpu_torch.eval.metrics import evaluate_hota
    from busca_tpu_torch.eval.runner import (
        evaluate_sequence,
        results_to_pred,
        run_sequence,
    )
    from busca_tpu_torch.trackers.byte import ByteTracker, ByteTrackerConfig

    cfg = ByteTrackerConfig(
        use_busca=engine is not None, seq_len=seq_len,
        num_candidates=num_candidates, crop_hw=crop_hw,
        # default False: the demo model is trained on consecutive mems.
        # The mem-cap length sweep turns it ON for its archive arm — the
        # broader sampler is the one consumer that actually reads the
        # compacted archive (network.py:262-271), so the capped-vs-
        # unbounded delta only exists in that regime.
        use_broader_memory=use_broader_memory,
        mem_cap=mem_cap,
    )
    from busca_tpu_torch.trackers.base import Track

    # fresh ids per run: mode/cap arms over the same realization must mint
    # identical ids until their behavior actually diverges, or row-level
    # comparisons (memcap_delta.pred_divergence) flag every frame
    Track.reset_id_counter()
    tracker = ByteTracker(cfg, assoc_engine=engine)
    n = seq.num_frames
    # frames/dets draw from the sequence's STATEFUL noise rng — callers
    # comparing modes must precompute them once and share, or each run
    # would see a different jitter realization and the mode delta would
    # be confounded by input noise.
    if dets is None:
        dets = [seq.detections(t) for t in range(n)]
    if frames is None:
        frames = [seq.frame(t) for t in range(n)]
    res = run_sequence(tracker, iter(frames), dets)
    gt = seq.ground_truth()
    m = evaluate_sequence(res, gt)
    pred = results_to_pred(res)
    h = evaluate_hota(gt, pred)
    out = {"mota": m.mota, "idf1": m.idf1, "hota": h["hota"],
           "fn": m.num_misses, "ids": m.num_switches, "pred": pred}
    if mem_cap is not None:
        # realized compaction state (memcap_delta's length sweep reports
        # it): how far the archive stride doubled and how many admissions
        # each surviving memory represents
        all_tracks = tracker.tracked + tracker.lost + tracker.removed
        if all_tracks:
            out["max_stride"] = int(max(t._mem_stride for t in all_tracks))
            out["max_mem_len"] = int(
                max(len(t.images_mem) for t in all_tracks))
            out["max_admissions"] = int(
                max(t._mem_clock for t in all_tracks))
    return out


def measure_frozen_delta(
    steps: int = 60,
    train_batch: int = 12,
    seed: int = 3,
    num_frames: int = 40,
    seq_seeds: Sequence[int] = (0, 1, 2),
    calib_batches: int = 8,
    cfg=None,
    model=None,
    seq_len: int = 3,
    num_candidates: int = 2,
    frame_transform=None,
    n_drop: int = 1,
    drop_len: int = 6,
    device="cuda",
) -> dict:
    """Run the full frozen-vs-batch deviation measurement on ``device``.

    Trains the demo model (or takes ``cfg``/``model``, a batch-BN
    :class:`BuscaModel`), calibrates frozen running statistics on the
    training distribution into a frozen twin of it, then for each synthetic
    dropout sequence runs: base (no BUSCA), batch mode (with the dual
    recorder scoring frozen in parallel), and frozen mode end-to-end.

    ``frame_transform`` is the DOMAIN-SHIFT arm: a deterministic
    photometric transform applied to the tracked frames only — calibration
    stays on the training distribution, so frozen statistics are stale for
    the deployment domain while batch-stat BN re-adapts per batch (the
    reference's whole rationale, network.py:554-556).
    """
    from busca_tpu_torch.assoc.engine import AssociationEngine
    from busca_tpu_torch.train.data import EpisodeSpec, synthetic_batch
    from busca_tpu_torch.train.demo import train_demo_model
    from busca_tpu_torch.trackers.byte import ByteTrackerConfig

    crop_hw = (64, 32)
    train_metrics = {}
    if cfg is None or model is None:
        cfg, model, train_metrics = train_demo_model(
            steps=steps, batch=train_batch, seed=seed,
            seq_len=seq_len, num_candidates=num_candidates, crop_hw=crop_hw,
            device=device,
        )

    spec = EpisodeSpec(batch=16, seq_len=seq_len,
                       num_candidates=num_candidates, crop_hw=crop_hw)
    rng = np.random.RandomState(seed + 100)
    h, w = crop_hw
    batches = []
    for _ in range(calib_batches):
        b = synthetic_batch(rng, spec)
        batches.append(np.concatenate([
            b["mem_crops"].reshape(-1, h, w, 3),
            b["can_crops"].reshape(-1, h, w, 3),
        ]))
    frozen = frozen_model(cfg, model)
    calibrate_batch_stats(frozen, batches, load=True)

    eng_kw = dict(seq_len=seq_len, num_candidates=num_candidates,
                  crop_hw=crop_hw, buckets=(1, 2, 4))
    eng_batch = AssociationEngine(cfg, model, **eng_kw)
    eng_frozen = AssociationEngine(cfg, frozen, reid_stats="frozen",
                                   **eng_kw)
    dual = DualEngine(eng_batch, eng_frozen,
                      rescue_thresh=ByteTrackerConfig.busca_thresh)

    per_seq = {"base": [], "batch": [], "frozen": []}
    for s in seq_seeds:
        seq = _random_dropout_sequence(int(s), num_frames,
                                       n_drop=n_drop, drop_len=drop_len,
                                       warm=max(10, seq_len + 4))
        # one noise realization shared by all three modes: frames and dets
        # come from a stateful rng, so re-generating per run would confound
        # the mode delta with detection/appearance jitter variance
        frames = [seq.frame(t) for t in range(num_frames)]
        dets = [seq.detections(t) for t in range(num_frames)]
        if frame_transform is not None:
            frames = [frame_transform(f) for f in frames]
        seq_kw = dict(seq_len=seq_len, num_candidates=num_candidates,
                      crop_hw=crop_hw, frames=frames, dets=dets)
        per_seq["base"].append(_track_sequence(seq, None, **seq_kw))
        # batch-mode run, with the frozen engine scored at identical inputs
        per_seq["batch"].append(_track_sequence(seq, dual, **seq_kw))
        per_seq["frozen"].append(_track_sequence(seq, eng_frozen, **seq_kw))

    def agg(rows):
        keys = ("mota", "idf1", "hota", "fn", "ids")
        return {k: float(np.mean([r[k] for r in rows])) for k in keys}

    metrics = {tag: agg(rows) for tag, rows in per_seq.items()}
    delta = {
        k: metrics["frozen"][k] - metrics["batch"][k]
        for k in ("mota", "idf1", "hota", "fn", "ids")
    }
    return {
        "train": train_metrics,
        "flip": dual.summary(),
        "metrics": metrics,
        "per_sequence": per_seq,
        "delta": delta,
    }


def _report(tag_name, out):
    f = out["flip"]
    print(f"== arm: {tag_name} ==")
    print(
        f"decisions: {f['rows']} rows over {f['calls']} calls | "
        f"argmax flips {f['argmax_flips']} ({f['argmax_flip_rate']:.1%}) | "
        f"rescue flips {f['rescue_flips']}/{f['rescue_rows']} "
        f"({f['rescue_flip_rate']:.1%}) | "
        f"rescues batch={f['rescues_batch']} frozen={f['rescues_frozen']}"
    )
    for tag in ("base", "batch", "frozen"):
        m = out["metrics"][tag]
        print(
            f"{tag:6s} MOTA={m['mota']:.3f} IDF1={m['idf1']:.3f} "
            f"HOTA={m['hota']:.3f} FN={m['fn']:.1f} IDs={m['ids']:.1f}"
        )
    d = out["delta"]
    print(
        f"frozen-batch delta: MOTA {d['mota']:+.4f} IDF1 {d['idf1']:+.4f} "
        f"HOTA {d['hota']:+.4f} FN {d['fn']:+.1f} IDs {d['ids']:+.1f}"
    )


def main(argv=None):
    """``python -m busca_tpu_torch.eval.frozen_delta`` — frozen-vs-batch
    deviation, in-domain and (``--shift``) under a calibrate-on-A /
    deploy-on-B photometric domain shift."""
    import argparse
    import json

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--seq-len", type=int, default=3,
                   help="memory length (3 = the cheap setting; 11 = the "
                        "production config)")
    p.add_argument("--num-candidates", type=int, default=2)
    p.add_argument("--frames", type=int, default=40)
    p.add_argument("--seeds", type=int, default=3,
                   help="number of synthetic sequences per arm")
    p.add_argument("--n-drop", type=int, default=1,
                   help="dropout windows per sequence (decision volume)")
    p.add_argument("--drop-len", type=int, default=6)
    p.add_argument("--steps", type=int, default=60,
                   help="demo-model training steps")
    p.add_argument("--train-batch", type=int, default=12)
    p.add_argument("--shift", default="none",
                   choices=("none", "dim", "glare", "both"),
                   help="also run the domain-shift arm(s): calibrate on the "
                        "training distribution, track on the transformed "
                        "frames")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from busca_tpu_torch.train.demo import train_demo_model
    from busca_tpu_torch.utils.device import set_card_precision

    set_card_precision()
    # ONE trained model shared by all arms: the arms differ only in the
    # deployment-domain transform (calibration re-runs per arm on the same
    # un-shifted training distribution, so every arm gets the same
    # statistics)
    cfg, model, train_metrics = train_demo_model(
        steps=args.steps, batch=args.train_batch, seed=3,
        seq_len=args.seq_len, num_candidates=args.num_candidates,
        crop_hw=(64, 32), device=args.device,
    )
    print(f"train: {train_metrics}")

    kw = dict(
        num_frames=args.frames, seq_seeds=tuple(range(args.seeds)),
        cfg=cfg, model=model, seq_len=args.seq_len,
        num_candidates=args.num_candidates, n_drop=args.n_drop,
        drop_len=args.drop_len, device=args.device,
    )
    arms = ["none"]
    if args.shift == "both":
        arms += ["dim", "glare"]
    elif args.shift != "none":
        arms += [args.shift]
    record = {}
    for arm in arms:
        out = measure_frozen_delta(
            frame_transform=shift_transform(arm), **kw
        )
        name = "in-domain" if arm == "none" else f"shift:{arm}"
        _report(name, out)
        record[name] = {"flip": out["flip"], "metrics": out["metrics"],
                        "delta": out["delta"]}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
