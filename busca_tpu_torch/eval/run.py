"""CLI: run a tracker (optionally + BUSCA) and report metrics (port of
``busca_tpu.eval.run``).

Trackers (``--tracker``): ``byte``, ``transcenter`` (BYTE with the
detector-feedback export), ``centertrack`` (BYTE behind CenterTrack's dict
IO), ``strongsort``, ``deepsort`` (StrongSORT with its upgrades off, the
reference's vanilla DeepSORT alternate), ``ghost``, and the reference
evaluator's ``sort`` and ``motdt`` alternates.

Modes:
- ``--synthetic``: the built-in dropout sequence; base vs BUSCA A/B.
- ``--mot-dir DIR ...``: MOTChallenge sequence directories (``seqinfo.ini``,
  ``img1/*.jpg``, optional ``gt/gt.txt``), one of three ways:
  - with ``--detector``: the live detector-in-the-loop path (reference
    mot_evaluator.py:131-235): YOLOX (tiny, s, m, l, x) or TransCenter per
    frame, NMS on the device, the tracker fed with the detections and the
    device canvas; or CenterTrack (``--tracker centertrack``, DLA-34,
    MobileNetV2 or tiny by ``--centertrack-arch``, its DCN by
    ``--centertrack-sampling``) with the tracker's dict tracks fed back as
    its prior heatmap; ``--detector-artifact DIR`` runs an exported YOLOX
    step (``serve/export.py``) in place of ``--detector``;
  - ``--tracker strongsort --npy-det DIR``: StrongSORT's cached artifacts
    (deep_sort_app.py): detections with features from ``<seq>.npy``, the
    ``--min-confidence`` filter, optional ``--ecc-json`` camera warps;
  - otherwise the cached-detection path: the sequence's ``det/det.txt``.

  ``--lockstep`` runs the sequences frame by frame in step, each frame's
  BUSCA third rounds served by one grouped association: with a YOLOX
  ``--detector``, one batch step per frame of each same-resolution group;
  also over ``det/det.txt`` and ``--npy-det``.  ``--det-ap`` prints the
  COCO detection-AP table of a live YOLOX or TransCenter detector's raw
  outputs against the sequences' gt.

  StrongSORT, DeepSORT, GHOST and MOTDT take ReID features from a
  ``--reid-ckpt`` extractor run on each detection's crop (without one, a
  distinct placeholder per detection).  MOTChallenge result txts go under
  ``--output-dir``, optionally linked (``--aflink NPZ``, or ``--aflink
  synthetic``: a link model trained on synthetic trajectories first) and
  smoothed (``--gsi``); per-sequence CLEAR (and ``--hota``) against the
  gt, and the accumulated CLEAR as JSON.  The per-video BYTE threshold
  table applies unless ``--ignore-custom-byte-thresholds``.  Frames are
  decoded with cv2, so this mode runs where cv2 is installed.

Example::

    python -m busca_tpu_torch.eval.run --synthetic --use-busca
    python -m busca_tpu_torch.eval.run --mot-dir MOT17-05-FRCNN \\
        --detector yolox-x --detector-ckpt bytetrack_x_mot17.pth.tar \\
        --use-busca
    python -m busca_tpu_torch.eval.run --mot-dir MOT20-01 \\
        --tracker strongsort --npy-det npy/ --ecc-json ecc.json \\
        --use-busca --aflink aflink.npz --gsi
    python -m busca_tpu_torch.eval.run --mot-dir seq --detector yolox-tiny \\
        --test-h 128 --test-w 224 --device cpu
    python -m busca_tpu_torch.eval.run --mot-dir MOT17-05 \\
        --detector centertrack --tracker centertrack --use-busca
    python -m busca_tpu_torch.eval.run --mot-dir MOT17-02 MOT17-04 \\
        --detector yolox-x --use-busca --lockstep

Without ``--busca-config`` the model is ``BuscaConfig()`` (ResNet-50,
d=512, 4 layers, 4 heads, ff 1024); without ``--busca-ckpt`` its weights are
random, drawn from ``--seed``; without ``--detector-ckpt`` so are the
detector's.  ``--busca-dtype`` (default ``bfloat16``, as busca_tpu's CLI)
is BUSCA's compute dtype; ``float32`` is the parity mode.
``--reid-stats frozen|auto`` runs BUSCA's ReID on the checkpoint's running
BN statistics with features cached across frames (busca_tpu's opt-in
serving deviation; ``batch``, the reference's, is the default).  The detectors
take their dtype from their configs only, as in busca_tpu.  On the card the
CLI turns TF32 off and keeps bf16 products' reductions in float32
(:func:`~busca_tpu_torch.utils.device.set_card_precision`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Optional

import numpy as np
import torch


def build_engine(config: Optional[str] = None, ckpt: Optional[str] = None,
                 device="cuda", crop_hw=(384, 128),
                 bank_slots: Optional[int] = None, seed: int = 0,
                 dtype: Optional[str] = None, reid_stats: str = "batch"):
    """An :class:`~busca_tpu_torch.assoc.engine.AssociationEngine` on
    ``device``.

    Args:
      config: a reference BUSCA YAML, or None for ``BuscaConfig()`` defaults.
      ckpt: ``.npz`` (flattened flax variables) or reference ``.pth``
        weights; None = random weights from ``torch.Generator`` seeded with
        ``seed``.
      device: ``"cuda"`` (default; raises without CUDA) or ``"cpu"``.
      bank_slots: device crop-bank capacity; None = 4096 on CUDA (~600 MB
        at 384x128), 256 on the CPU; 0 disables banking.
      dtype: overrides the config's compute dtype ("float32" or
        "bfloat16"), as busca_tpu's ``build_engine``; the CLI passes its
        ``--busca-dtype``.  The weights stay float32.
      reid_stats: ``"batch"`` (the reference's batch-statistics BN, the
        default), ``"frozen"`` or ``"auto"`` (the stored running statistics
        and the engine's feature bank; an opt-in deviation, PARITY.md
        "Frozen-stats ReID").  The frozen modes build the model with
        ``reid_use_batch_stats=False`` and take its running statistics from
        the checkpoint (an ``.npz``'s ``batch_stats``, a reference
        ``.pth``'s ``running_mean``/``running_var``); the feature bank
        replaces the crop bank, so they have none.
    Returns:
      ``(engine, tracker_kwargs)``.
    """
    from busca_tpu_torch.assoc.bank import DeviceCropBank
    from busca_tpu_torch.assoc.engine import AssociationEngine
    from busca_tpu_torch.models.busca import BuscaConfig, BuscaModel
    from busca_tpu_torch.models.convert import load_checkpoint
    from busca_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if config is not None:
        from busca_tpu_torch.config.options import load_tracker_bundle

        _, busca_cfg, tracker_kwargs = load_tracker_bundle(config)
    else:
        busca_cfg, tracker_kwargs = BuscaConfig(), {}
    if dtype is not None:  # busca_tpu/eval/run.py:76-77
        busca_cfg = dataclasses.replace(busca_cfg, dtype=dtype)
    frozen = reid_stats in ("frozen", "auto")
    if frozen:  # busca_tpu/eval/run.py:78-81
        busca_cfg = dataclasses.replace(busca_cfg, reid_use_batch_stats=False)
    model = BuscaModel(busca_cfg)
    model.init_weights(torch.Generator().manual_seed(seed))
    if ckpt:
        load_checkpoint(model, ckpt)
    model = model.to(dev).eval()
    if bank_slots is None:
        bank_slots = 4096 if dev.type == "cuda" else 256
    bank = None
    if bank_slots and not frozen:
        bank = DeviceCropBank(crop_hw, bank_slots, dev)
    engine = AssociationEngine(
        busca_cfg, model,
        seq_len=tracker_kwargs.get("seq_len", 11),
        num_candidates=tracker_kwargs.get("num_candidates", 5),
        crop_hw=crop_hw, bank=bank, reid_stats=reid_stats,
    )
    return engine, tracker_kwargs


# trackers that store per-track appearance-crop memory and take a memory
# cap (trackers/base.py compact_mem_lists)
MEM_CAP_TRACKERS = ("byte", "bytetrack", "centertrack", "transcenter",
                    "strongsort", "deepsort", "ghost")


def make_tracker(name: str, tracker_kwargs: dict, engine, crop_hw=(384, 128),
                 feature_extractor=None):
    """A tracker for ``name``: ``byte`` (``bytetrack``), ``transcenter``
    (BYTE with the detector-feedback export), ``centertrack`` (BYTE behind
    CenterTrack's dict IO), ``strongsort``, ``deepsort`` (StrongSORT with
    the vanilla DeepSORT defaults), ``ghost``, ``sort`` or ``motdt``.  Keys
    of ``tracker_kwargs`` that the tracker's config does not know are
    ignored.  ``feature_extractor`` gives GHOST fresh features for its
    Kalman candidates (GHOST src/tracker.py:684-708); busca_tpu's
    ``make_tracker`` takes none, so its GHOST reuses the tracks' features
    there."""
    if (tracker_kwargs.get("mem_cap") is not None
            and name not in MEM_CAP_TRACKERS):
        raise ValueError(f"--mem-cap only applies to trackers that store "
                         f"appearance memory {MEM_CAP_TRACKERS}; --tracker "
                         f"{name} keeps no crop memory")

    def config(cls, **defaults):
        known = {f.name for f in dataclasses.fields(cls)}
        kw = dict(defaults)
        kw.update({k: v for k, v in tracker_kwargs.items() if k in known})
        cfg = cls(**kw)
        if "crop_hw" in known:
            cfg.crop_hw = crop_hw
        return cfg

    if name == "motdt":
        from busca_tpu_torch.trackers.motdt import MotdtConfig, MotdtTracker

        # the reference's evaluate_motdt alternate:
        # OnlineTracker(min_cls_score=track_thresh) (mot_evaluator.py:553)
        cfg = config(MotdtConfig)
        if "track_thresh" in tracker_kwargs:
            cfg.min_cls_score = tracker_kwargs["track_thresh"]
        return MotdtTracker(cfg)
    if name == "sort":
        from busca_tpu_torch.trackers.sort import SortConfig, SortTracker

        # the reference's evaluate_sort alternate: Sort(track_thresh)
        # (mot_evaluator.py:307-308,322-323); SORT has no BUSCA hook
        cfg = config(SortConfig)
        if "track_thresh" in tracker_kwargs:
            cfg.det_thresh = tracker_kwargs["track_thresh"]
        return SortTracker(cfg)
    if name in ("byte", "bytetrack", "transcenter", "centertrack"):
        from busca_tpu_torch.trackers.byte import ByteTracker, ByteTrackerConfig
        from busca_tpu_torch.trackers.centertrack import CenterTrackAdapter
        from busca_tpu_torch.trackers.transcenter import (
            TransCenterByteTracker,
        )

        cfg = config(ByteTrackerConfig)
        cfg.use_busca = engine is not None and tracker_kwargs.get(
            "use_busca", True)
        if name == "centertrack":
            return CenterTrackAdapter(cfg, engine)
        if name == "transcenter":
            return TransCenterByteTracker(cfg, engine)
        return ByteTracker(cfg, engine)
    if name in ("strongsort", "deepsort"):
        from busca_tpu_torch.trackers.strongsort import (
            StrongSortConfig,
            StrongSortTracker,
        )

        # deepsort: the reference's evaluate_deepsort alternate, vanilla
        # DeepSORT (busca_tpu/eval/run.py:198-207): cascade matching, a
        # feature gallery, plain Kalman; explicit kwargs still win
        vanilla = dict(nsa=False, ema=False, mc=False, woc=False,
                       max_cosine_distance=0.2, nn_budget=100)
        cfg = config(StrongSortConfig,
                     **(vanilla if name == "deepsort" else {}))
        cfg.use_busca = engine is not None
        return StrongSortTracker(cfg, engine)
    if name == "ghost":
        from busca_tpu_torch.trackers.ghost import GhostConfig, GhostTracker

        cfg = config(GhostConfig)
        cfg.use_busca = engine is not None
        return GhostTracker(cfg, engine, feature_extractor)
    raise ValueError(f"unknown tracker: {name}")


class FeatureShim:
    """Adapt the feature-consuming trackers (StrongSORT, DeepSORT, GHOST,
    MOTDT) to the runner's ``update(boxes, scores, scale, frame)``
    protocol.

    Features come from a
    :class:`~busca_tpu_torch.eval.features.ReidFeatureExtractor` when given
    (the reference GHOST path, base_tracker.py:116): the frame goes to the
    extractor's device once, the detections are cropped there (kernel K1 on
    the card) and the crops go into the network without a host copy; the
    tracker gets the frame on the device and cuts its BUSCA crops from it.
    Without an extractor each detection gets a distinct placeholder
    feature (synthetic and smoke runs), as in busca_tpu.
    """

    def __init__(self, trk, feature_extractor=None, crop_hw=(384, 128),
                 call_predict=False):
        self.trk = trk
        self.feat_fn = feature_extractor
        self.crop_hw = crop_hw
        self.call_predict = call_predict

    def _features(self, boxes, scale, frame):
        n = len(boxes)
        if self.feat_fn is not None and frame is not None and n:
            from busca_tpu_torch.trackers.base import device_crops

            crops = device_crops(frame, np.asarray(boxes) * scale,
                                 self.crop_hw, frame.device)
            return self.feat_fn(crops)
        return np.eye(max(n, 1), 16)[:n]

    def _prepare(self, boxes, scale, frame):
        """The frame on the extractor's device, the predict step, and the
        detections' features."""
        if self.feat_fn is not None and frame is not None:
            frame = torch.as_tensor(frame).to(self.feat_fn.device)
        if self.call_predict:
            self.trk.predict()
        return self._features(boxes, scale, frame), frame

    def update(self, boxes, scores, scale, frame):
        feats, frame = self._prepare(boxes, scale, frame)
        return self.trk.update(boxes, scores, feats, frame)

    def cmc_prefetch(self, cur_frame):
        """Forward the lockstep drivers' ECC prefetch to the wrapped
        tracker, which owns the recipe and the warp hint."""
        inner = getattr(self.trk, "cmc_prefetch", None)
        return inner(cur_frame) if inner is not None else None

    def update_deferred(self, boxes, scores, scale, frame):
        """The wrapped tracker's deferred mode (the lockstep drivers' batched
        third round); a tracker without one runs its plain update inside a
        generator that yields nothing."""
        if not hasattr(self.trk, "update_deferred"):
            def gen():
                return self.update(boxes, scores, scale, frame)
                yield  # a generator that returns at once

            return gen()
        feats, frame = self._prepare(boxes, scale, frame)
        return self.trk.update_deferred(boxes, scores, feats, frame)


class CenterTrackShim:
    """Adapt the dict-IO :class:`~busca_tpu_torch.trackers.centertrack.
    CenterTrackAdapter` to the runner's ``update(boxes, scores, scale,
    frame)`` protocol."""

    def __init__(self, trk):
        self.trk = trk

    def get_detector_positions(self):
        """The adapter's current dict tracks, for the stateful detector's
        prior heatmap (the serving loop's feedback hook; detector.py:143-156
        hands the tracker's tracks to the detector the same way)."""
        return self.trk.tracks

    def cmc_prefetch(self, cur_frame):
        """Forward the lockstep drivers' ECC prefetch to the adapter."""
        return self.trk.cmc_prefetch(cur_frame)

    def update(self, boxes, scores, scale, frame):
        dicts = [{"bbox": b, "score": s, "class": 1}
                 for b, s in zip(boxes, scores)]
        return [_DictTrack(d) for d in self.trk.step(dicts, frame, scale)]


class _DictTrack:
    """A dict track seen as a runner track (``tlwh``, ``track_id``,
    ``score``)."""

    def __init__(self, d: dict):
        b = d["bbox"]
        self.tlwh = np.array([b[0], b[1], b[2] - b[0], b[3] - b[1]])
        self.track_id = d["tracking_id"]
        self.score = d["score"]


def shim_for_runner(name: str, tracker, feature_extractor=None,
                    crop_hw=(384, 128)):
    """Wrap a tracker for the runner protocol where its native IO differs:
    StrongSORT and DeepSORT take features and are predicted before each
    update; GHOST and MOTDT take features; CenterTrack's adapter takes
    dicts."""
    if name in ("strongsort", "deepsort"):
        return FeatureShim(tracker, feature_extractor, crop_hw,
                           call_predict=True)
    if name in ("ghost", "motdt"):
        return FeatureShim(tracker, feature_extractor, crop_hw)
    if name == "centertrack":
        return CenterTrackShim(tracker)
    return tracker


def run_synthetic(args, engine, tracker_kwargs, seq=None) -> dict:
    """Base vs BUSCA A/B on the synthetic dropout sequence (or ``seq``).
    ``args`` needs ``tracker``, ``num_frames`` and ``crop_hw``.  StrongSORT,
    DeepSORT, GHOST and MOTDT get a placeholder feature per detection, as in
    busca_tpu."""
    from busca_tpu_torch.eval.metrics import evaluate_hota
    from busca_tpu_torch.eval.runner import (
        evaluate_sequence,
        results_to_pred,
        run_sequence,
    )
    from busca_tpu_torch.eval.synthetic import default_dropout_sequence

    if seq is None:
        seq = default_dropout_sequence(args.num_frames)
    dets = [seq.detections(t) for t in range(seq.num_frames)]
    gt = seq.ground_truth()
    out = {}
    variants = [("base", None)]
    if engine is not None:
        variants.append(("busca", engine))
    for tag, eng in variants:
        tracker = shim_for_runner(
            args.tracker,
            make_tracker(args.tracker, tracker_kwargs, eng, args.crop_hw),
            crop_hw=args.crop_hw)
        frames = (seq.frame(t) for t in range(seq.num_frames))
        res = run_sequence(tracker, frames, dets, name="synthetic")
        m = evaluate_sequence(res, gt)
        h = evaluate_hota(gt, results_to_pred(res))
        out[tag] = {
            "mota": m.mota,
            "idf1": m.idf1,
            "hota": h["hota"],
            "ids": m.num_switches,
            "fp": m.num_false_positives,
            "fn": m.num_misses,
            "fps": res.fps,
        }
    return out


def load_aflink(path: str, device="cuda"):
    """The AFLink link model from a ``.npz`` of busca_tpu ``AFLinkModel``
    parameters (``save_params_npz``), on ``device``."""
    from busca_tpu_torch.models.aflink import AFLinkModel
    from busca_tpu_torch.models.checkpoint import load_params_npz
    from busca_tpu_torch.models.convert import aflink_state_dict_from_flax
    from busca_tpu_torch.utils.device import resolve_device

    model = AFLinkModel()
    model.load_state_dict(aflink_state_dict_from_flax(load_params_npz(path)))
    return model.to(resolve_device(device)).eval()


def postprocess_result(res, out_path, link_model=None, gsi=False):
    """AFLink (``link_model``) and GSI over the written result rows, in the
    reference's order (strong_sort.py:29-46: link first, then smooth);
    rewrites the txt and returns an updated SequenceResult."""
    from busca_tpu_torch.eval import mot
    from busca_tpu_torch.eval.runner import SequenceResult
    from busca_tpu_torch.trackers.postprocess import (
        aflink,
        gaussian_smoothed_interpolation,
    )

    rows = mot.read_mot_file(out_path)
    if rows.size == 0:
        return res
    if link_model is not None:
        rows = aflink(rows, model=link_model)
    if gsi:
        rows = gaussian_smoothed_interpolation(rows)
    by_frame = {}
    for r in rows:
        by_frame.setdefault(int(r[0]), []).append(r)
    results = []
    for f in sorted(by_frame):
        rs = np.asarray(by_frame[f])
        results.append(
            (f, list(rs[:, 2:6]), rs[:, 1].astype(int).tolist(),
             rs[:, 6].tolist() if rs.shape[1] > 6 else [1.0] * len(rs))
        )
    mot.write_results(out_path, results)
    return SequenceResult(res.name, res.num_frames, results,
                          res.track_time_s)


# flags of busca_tpu's CLI whose code is not ported yet, and the ROADMAP.md
# Queue 1 item that ports it
LATER_FLAGS = {
    "online_visualization": 25,
}


def build_detector(args):
    """The live detector of ``--detector``: a YOLOX size, TransCenter or
    CenterTrack."""
    from busca_tpu_torch.eval.detector import (
        build_centertrack_detector,
        build_transcenter_detector,
        build_yolox_detector,
    )

    test_size = (args.test_h, args.test_w)
    if args.detector == "centertrack":
        return build_centertrack_detector(
            arch=args.centertrack_arch, sampling=args.centertrack_sampling,
            ckpt=args.detector_ckpt, test_size=test_size,
            out_thresh=args.det_conf, device=args.device, seed=args.seed)
    if args.detector == "transcenter":
        return build_transcenter_detector(
            dataset=args.detector_dataset, ckpt=args.detector_ckpt,
            test_size=test_size, out_thresh=args.det_conf,
            device=args.device, seed=args.seed)
    return build_yolox_detector(
        size=args.detector.split("-")[-1], ckpt=args.detector_ckpt,
        test_size=test_size, conf_thresh=args.det_conf,
        nms_thresh=args.det_nms, device=args.device, seed=args.seed)


def seq_tracker_kwargs(args, tracker_kwargs: dict, name: str) -> dict:
    """A sequence's tracker kwargs: the per-video BYTE threshold table
    (mot_evaluator.py:141-164) for the BYTE family, GHOST's per-sequence
    camera-motion gate (tracking_utils.py:209) when its ECC is on."""
    from busca_tpu_torch.eval.presets import (
        custom_byte_thresholds,
        ghost_is_moving,
    )

    seq_kwargs = dict(tracker_kwargs)
    if args.tracker in ("byte", "centertrack", "transcenter"):
        seq_kwargs.update(custom_byte_thresholds(
            name, seq_kwargs.get("track_thresh", 0.6),
            seq_kwargs.get("track_buffer", 30),
            ignore=args.ignore_custom_byte_thresholds))
    elif args.tracker == "ghost" and seq_kwargs.get("motion_compensation"):
        seq_kwargs["is_moving"] = ghost_is_moving(name)
    return seq_kwargs


def run_mot(args, detector, engine, tracker_kwargs, feature_extractor=None,
            link_model=None) -> dict:
    """Each ``--mot-dir`` sequence through the live detector, StrongSORT's
    cached artifacts (``--npy-det``) or its ``det/det.txt``: results file
    (linked and smoothed when asked), per-sequence CLEAR (+ HOTA with
    ``--hota``) where a gt exists, and the accumulated CLEAR printed as
    JSON.  Returns ``{name: MotMetrics}``."""
    import itertools

    from busca_tpu_torch.eval import mot
    from busca_tpu_torch.eval.runner import run_mot_sequence

    eval_inputs = {}
    det_ap_dets, det_ap_gts = {}, {}
    for seq_dir in args.mot_dir:
        name = os.path.basename(seq_dir.rstrip("/"))
        tracker = make_tracker(
            args.tracker, seq_tracker_kwargs(args, tracker_kwargs, name),
            engine, args.crop_hw, feature_extractor)
        out_path = os.path.join(args.output_dir, f"{name}.txt")
        if args.tracker == "strongsort" and args.npy_det:
            from busca_tpu_torch.eval.strongsort_io import (
                load_ecc_warps,
                run_cached_sequence,
            )

            det_file = args.npy_det
            if os.path.isdir(det_file):
                det_file = os.path.join(det_file, f"{name}.npy")
            ecc = None
            if args.ecc_json:
                ecc = load_ecc_warps(args.ecc_json).get(name)
            res = run_cached_sequence(
                seq_dir, det_file, tracker,
                min_confidence=args.min_confidence, ecc_warps=ecc,
                output_file=out_path, max_frames=args.max_frames)
        elif detector is not None:
            from busca_tpu_torch.eval.detector import (
                track_frames_centertrack,
                track_frames_with_detector,
            )
            from busca_tpu_torch.eval.loader import sequence_frames

            if hasattr(detector, "reset"):
                detector.reset()  # per video (mot_evaluator.py:148-150)
            info = mot.load_seqinfo(seq_dir)
            frames = iter(sequence_frames(info))
            if args.max_frames:
                frames = itertools.islice(frames, args.max_frames)
            if args.detector == "centertrack":
                res = track_frames_centertrack(detector, tracker, frames,
                                               name=info.name)
            else:
                seq_det_log = [] if args.det_ap else None
                res = track_frames_with_detector(
                    detector, shim_for_runner(args.tracker, tracker,
                                              feature_extractor,
                                              args.crop_hw),
                    frames, name=info.name, det_log=seq_det_log)
                for fid, boxes, scores in seq_det_log or ():
                    det_ap_dets[(name, fid)] = (boxes, scores)
            mot.write_results(out_path, res.results)
        else:
            res = run_mot_sequence(
                seq_dir, shim_for_runner(args.tracker, tracker,
                                         feature_extractor, args.crop_hw),
                output_path=out_path, max_frames=args.max_frames)
        report_sequence(args, seq_dir, res, out_path, link_model,
                        eval_inputs)
        if args.det_ap and name in eval_inputs:
            for fid, (tlwh, _ids) in eval_inputs[name][0].items():
                tlbr = tlwh.copy()
                tlbr[:, 2:] += tlbr[:, :2]
                det_ap_gts[(name, fid)] = tlbr
    per_seq = evaluate_all(args, eval_inputs)
    if det_ap_dets:
        # the COCO detection table over the raw detector outputs, pooled
        # across sequences (mot_evaluator.py:659-711)
        from busca_tpu_torch.eval.detection import (
            coco_eval_full,
            format_coco_table,
        )

        print(format_coco_table(coco_eval_full(det_ap_dets, det_ap_gts)))
    return per_seq


def report_sequence(args, seq_dir, res, out_path, link_model, eval_inputs,
                    note=""):
    """A sequence's written results linked and smoothed when asked, its
    line printed, and its gt and predictions added to ``eval_inputs``
    (``--hota`` prints its HOTA)."""
    from busca_tpu_torch.eval import mot
    from busca_tpu_torch.eval.metrics import evaluate_hota
    from busca_tpu_torch.eval.runner import results_to_pred

    name = os.path.basename(seq_dir.rstrip("/"))
    if args.gsi or link_model is not None:
        res = postprocess_result(res, out_path, link_model, args.gsi)
    stage = ""
    if res.stage_times:
        stage = " (" + ", ".join(
            f"{k.rstrip('_s')} {v / max(res.num_frames, 1) * 1e3:.1f} "
            "ms/frame" for k, v in res.stage_times.items()) + ")"
    print(f"{name}: {res.num_frames} frames @ {res.fps:.1f} fps{stage}"
          f"{note}")
    gt_path = os.path.join(seq_dir, "gt", "gt.txt")
    if os.path.exists(gt_path):
        gt = mot.read_gt(gt_path)
        pred = results_to_pred(res)
        eval_inputs[name] = (gt, pred)
        if args.hota:
            h = evaluate_hota(gt, pred)
            print("  " + "  ".join(
                f"{label} {h[label.lower()] * 100:.3f}"
                for label in ("HOTA", "DetA", "AssA", "DetRe", "DetPr",
                              "AssRe", "AssPr", "LocA")))


def evaluate_all(args, eval_inputs) -> dict:
    """Per-sequence CLEAR over a process pool with ``--eval-workers`` > 1
    (the TrackEval USE_PARALLEL role), the accumulated CLEAR printed as
    JSON.  Returns ``{name: MotMetrics}``."""
    from busca_tpu_torch.eval.runner import (
        evaluate_sequences_parallel,
        global_metrics,
    )

    per_seq = {}
    if eval_inputs:
        per_seq = evaluate_sequences_parallel(
            eval_inputs, num_workers=args.eval_workers)
        print(json.dumps(global_metrics(per_seq).as_dict(), indent=2))
    return per_seq


def run_lockstep(args, detector, engine, tracker_kwargs,
                 feature_extractor=None, link_model=None) -> dict:
    """``--lockstep``: the ``--mot-dir`` sequences frame by frame in step,
    every frame's BUSCA third rounds served by one grouped association.
    Three ways, as busca_tpu's CLI: StrongSORT's ``--npy-det`` artifacts
    (``run_cached_sequences_lockstep``), the sequences' ``det/det.txt``
    (``run_mot_sequences_lockstep``), or a live YOLOX detector over each
    group of same-resolution sequences, one batch step per lockstep frame
    (``track_sequences_lockstep``).  Results, metrics and the printout as
    :func:`run_mot`."""
    import collections

    from busca_tpu_torch.eval import mot

    dirs = list(args.mot_dir)
    names = [os.path.basename(d.rstrip("/")) for d in dirs]
    notes = {d: "" for d in dirs}
    if args.tracker == "strongsort" and args.npy_det:
        from busca_tpu_torch.eval.strongsort_io import (
            load_ecc_warps,
            run_cached_sequences_lockstep,
        )

        ecc_all = load_ecc_warps(args.ecc_json) if args.ecc_json else None
        specs = []
        for d, name in zip(dirs, names):
            det_file = args.npy_det
            if os.path.isdir(det_file):
                det_file = os.path.join(det_file, f"{name}.npy")
            specs.append((d, det_file,
                          ecc_all.get(name) if ecc_all else None))
        trackers = [make_tracker("strongsort", tracker_kwargs, engine,
                                 args.crop_hw) for _ in specs]
        results = run_cached_sequences_lockstep(
            specs, trackers, min_confidence=args.min_confidence,
            max_frames=args.max_frames)
    elif detector is None:
        from busca_tpu_torch.eval.runner import run_mot_sequences_lockstep

        trackers = [shim_for_runner(
            args.tracker,
            make_tracker(args.tracker,
                         seq_tracker_kwargs(args, tracker_kwargs, name),
                         engine, args.crop_hw, feature_extractor),
            feature_extractor, args.crop_hw) for name in names]
        results = run_mot_sequences_lockstep(dirs, trackers,
                                             max_frames=args.max_frames)
    else:
        import itertools

        from busca_tpu_torch.eval.detector import track_sequences_lockstep
        from busca_tpu_torch.eval.loader import sequence_frames

        infos = {d: mot.load_seqinfo(d) for d in dirs}
        groups = collections.defaultdict(list)
        for d in dirs:
            groups[(infos[d].im_height, infos[d].im_width)].append(d)
        by_dir = {}
        for (h, w), group in groups.items():
            trackers, frame_iters = [], []
            for d in group:
                info = infos[d]
                trackers.append(shim_for_runner(
                    args.tracker,
                    make_tracker(args.tracker,
                                 seq_tracker_kwargs(args, tracker_kwargs,
                                                    info.name),
                                 engine, args.crop_hw, feature_extractor),
                    feature_extractor, args.crop_hw))
                frames = iter(sequence_frames(info))
                if args.max_frames:
                    frames = itertools.islice(frames, args.max_frames)
                frame_iters.append(frames)
            outs = track_sequences_lockstep(
                detector, trackers, frame_iters,
                names=[infos[d].name for d in group])
            for d, res in zip(group, outs):
                by_dir[d] = res
                notes[d] = f" (lockstep group of {len(group)} at {h}x{w})"
        results = [by_dir[d] for d in dirs]
    eval_inputs = {}
    for d, name, res in zip(dirs, names, results):
        out_path = os.path.join(args.output_dir, f"{name}.txt")
        mot.write_results(out_path, res.results)
        report_sequence(args, d, res, out_path, link_model, eval_inputs,
                        notes[d])
    return evaluate_all(args, eval_inputs)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--tracker", default="byte",
                        choices=["byte", "strongsort", "deepsort", "ghost",
                                 "transcenter", "sort", "motdt",
                                 "centertrack"])
    parser.add_argument("--use-busca", action="store_true")
    parser.add_argument("--busca-config", default=None,
                        help="BUSCA YAML (reference configs load unchanged);"
                             " default: BuscaConfig()")
    parser.add_argument("--busca-ckpt", default=None,
                        help=".npz or reference .pth weights; default: "
                             "random weights from --seed")
    parser.add_argument("--busca-dtype", default="bfloat16",
                        choices=["bfloat16", "float32"],
                        help="BUSCA compute dtype: bfloat16 (the production "
                             "default, as busca_tpu's) or float32 (parity "
                             "mode); the weights stay float32")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--crop-bank-slots", type=int, default=None)
    parser.add_argument("--reid-stats", choices=("batch", "frozen", "auto"),
                        default="batch",
                        help="BUSCA's ReID BN mode: batch (the reference's "
                             "batch statistics, the default); frozen (the "
                             "checkpoint's running statistics, features "
                             "cached across frames in a device bank: an "
                             "opt-in deviation); auto (frozen numerics, one "
                             "fused forward for the smallest calls)")
    parser.add_argument("--mem-cap", type=int, default=None,
                        help="bound each track's appearance memory to this "
                             "many entries (a dense recent tail and an "
                             "even-stride archive; default: unbounded, the "
                             "reference's semantics); byte-family, "
                             "strongsort, deepsort and ghost trackers")
    parser.add_argument("--lockstep", action="store_true",
                        help="run the --mot-dir sequences frame by frame in "
                             "step: one batch step of a yolox --detector "
                             "per frame of each same-resolution group, and "
                             "one grouped association for every sequence's "
                             "BUSCA third round (also over det.txt and "
                             "--npy-det)")
    parser.add_argument("--lockstep-dp", type=int, default=0,
                        help="shard the lockstep batch over this many "
                             "devices; refused when non-zero")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--num-frames", type=int, default=40)
    parser.add_argument("--crop-h", type=int, default=384)
    parser.add_argument("--crop-w", type=int, default=128)
    from busca_tpu_torch.trackers.cmc import parse_scale
    parser.add_argument("--cmc-scale", type=parse_scale, default=1.0)
    parser.add_argument("--ghost-motion-compensation", action="store_true",
                        help="GHOST's ECC ego-motion compensation of the "
                             "stored track positions on moving-camera "
                             "sequences (base_tracker.py:599-633)")
    parser.add_argument("--mot-dir", nargs="*", default=[],
                        help="MOTChallenge sequence directories")
    parser.add_argument("--output-dir", default="results")
    parser.add_argument("--detector", default=None,
                        choices=["yolox-tiny", "yolox-s", "yolox-m",
                                 "yolox-l", "yolox-x", "transcenter",
                                 "centertrack"],
                        help="the live detector run per frame; without it "
                             "--mot-dir reads det/det.txt (or --npy-det)")
    parser.add_argument("--detector-artifact", default=None,
                        help="a serve.export artifact directory to run "
                             "instead of building the detector (the "
                             "reference's --trt engine-file flow, "
                             "tools/track.py:83,215-224); --lockstep takes a "
                             "--batches family")
    parser.add_argument("--detector-ckpt", default=None,
                        help="official YOLOX .pth, published CenterTrack "
                             "DLA-34 .pth, or busca_tpu .npz (TransCenter: "
                             ".npz only); default: random weights from "
                             "--seed")
    parser.add_argument("--detector-dataset", default="mot17",
                        choices=["mot17", "mot20"],
                        help="TransCenter per-dataset preset")
    parser.add_argument("--centertrack-sampling", default="deformable",
                        choices=("deformable", "windowed", "local"),
                        help="CenterTrack's decoder DCN: exact DCNv2 "
                             "(published checkpoints), windowed dense "
                             "shifts (gather-free; exact wherever "
                             "|offset| <= 3), or offsets pinned to the tap "
                             "grid (from-scratch training)")
    parser.add_argument("--centertrack-arch", default="dla34",
                        choices=("dla34", "tiny", "mobilenet"),
                        help="CenterTrack backbone: dla34 (published "
                             "checkpoints), mobilenet (the adapter's "
                             "alternate backbone), tiny (smoke size)")
    parser.add_argument("--test-h", type=int, default=800)
    parser.add_argument("--test-w", type=int, default=1440)
    parser.add_argument("--det-conf", type=float, default=0.01,
                        help="exp.test_conf (BYTE consumes low-conf dets); "
                             "CenterTrack's and TransCenter's out_thresh")
    parser.add_argument("--det-nms", type=float, default=0.7,
                        help="exp.nmsthre")
    parser.add_argument("--det-ap", action="store_true",
                        help="print the 12-number COCO detection-AP table of "
                             "the raw detector output vs MOT gt "
                             "(mot_evaluator.py:659-711)")
    parser.add_argument("--max-frames", type=int, default=None,
                        help="cap frames per sequence")
    parser.add_argument("--hota", action="store_true",
                        help="also print per-sequence HOTA and its parts")
    parser.add_argument("--ignore-custom-byte-thresholds",
                        action="store_true",
                        help="disable the per-video BYTE threshold table")
    # StrongSORT's cached artifacts (deep_sort_app.py:50-52, opts.py:142-143)
    parser.add_argument("--npy-det", default=None,
                        help="precomputed detections + features: a .npy "
                             "file, or a directory holding <seq>.npy")
    parser.add_argument("--ecc-json", default=None,
                        help="per-video per-frame ECC warp matrices (JSON)")
    parser.add_argument("--min-confidence", type=float, default=0.6)
    parser.add_argument("--reid-ckpt", default=None,
                        help="GHOST ReID checkpoint (busca_tpu .npz or "
                             "model_feats.pth) for live per-detection "
                             "features (strongsort, deepsort, ghost)")
    parser.add_argument("--eval-workers", type=int, default=1,
                        help="process-pool workers for the per-sequence "
                             "metrics")
    # offline post-processing (strong_sort.py:29-46)
    parser.add_argument("--gsi", action="store_true",
                        help="Gaussian-smoothed interpolation of the output "
                             "trajectories")
    parser.add_argument("--aflink", default=None, metavar="NPZ",
                        help="appearance-free tracklet linking with the link "
                             "model of a busca_tpu AFLink params .npz, or "
                             "'synthetic' to train one on synthetic "
                             "trajectories first")
    for flag in LATER_FLAGS:
        parser.add_argument("--" + flag.replace("_", "-"), default=None,
                            nargs="?", const=True)
    args = parser.parse_args(argv)
    args.crop_hw = (args.crop_h, args.crop_w)
    for flag, item in LATER_FLAGS.items():
        if getattr(args, flag):
            parser.error(f"--{flag.replace('_', '-')} is not ported yet "
                         f"(ROADMAP.md Queue 1 item {item})")
    if args.detector == "centertrack" and args.tracker != "centertrack":
        parser.error("--detector centertrack needs --tracker centertrack "
                     "(dict IO)")
    if args.detector_artifact and args.detector:
        parser.error("--detector-artifact replaces --detector")
    if args.lockstep_dp:
        parser.error("--lockstep-dp (the lockstep batch sharded over "
                     "devices) is not ported yet (ROADMAP.md Queue 1 item "
                     "23)")
    if args.mem_cap is not None:
        if args.tracker not in MEM_CAP_TRACKERS:
            parser.error(f"--mem-cap only applies to trackers that store "
                         f"appearance memory {MEM_CAP_TRACKERS}; --tracker "
                         f"{args.tracker} keeps no crop memory")
    if args.lockstep:
        npy = args.tracker == "strongsort" and args.npy_det
        live = args.detector_artifact or args.detector not in (
            None, "transcenter", "centertrack")
        cached = args.detector is None and args.tracker in (
            "byte", "sort", "ghost", "strongsort", "deepsort", "motdt")
        if not (npy or cached or live):
            parser.error("--lockstep needs a yolox --detector, --tracker "
                         "strongsort --npy-det, or a cached-detection "
                         "byte/sort/ghost/strongsort/deepsort/motdt run")

    from busca_tpu_torch.utils.device import set_card_precision

    set_card_precision()
    engine, tracker_kwargs = None, {}
    if args.use_busca:
        engine, tracker_kwargs = build_engine(
            args.busca_config, args.busca_ckpt, args.device, args.crop_hw,
            bank_slots=args.crop_bank_slots, seed=args.seed,
            dtype=args.busca_dtype, reid_stats=args.reid_stats,
        )
        tracker_kwargs["use_busca"] = True
    if args.cmc_scale != 1.0:
        tracker_kwargs["cmc_scale"] = args.cmc_scale
    if args.ghost_motion_compensation:
        tracker_kwargs["motion_compensation"] = True
    if args.mem_cap is not None:
        tracker_kwargs["mem_cap"] = args.mem_cap
    if args.synthetic:
        out = run_synthetic(args, engine, tracker_kwargs)
        print(json.dumps(out, indent=2))
        return out
    if args.mot_dir:
        detector = None
        try:
            if args.detector_artifact:
                from busca_tpu_torch.serve.export import artifact_kind
                from busca_tpu_torch.serve.server import (
                    load_artifact_detector,
                )

                if args.lockstep and artifact_kind(args.detector_artifact) \
                        != "yolox_detector_batch_steps":
                    parser.error("--lockstep with --detector-artifact needs "
                                 "a --batches artifact family (python -m "
                                 "busca_tpu_torch.serve.export --batches 1 2 "
                                 "4 8)")
                detector = load_artifact_detector(args.detector_artifact,
                                                  args.device)
            elif args.detector:
                detector = build_detector(args)
        except ValueError as e:
            parser.error(str(e))
        feature_extractor = link_model = None
        if args.reid_ckpt:
            from busca_tpu_torch.eval.features import ReidFeatureExtractor

            feature_extractor = ReidFeatureExtractor.from_checkpoint(
                args.reid_ckpt, crop_hw=args.crop_hw, device=args.device)
        if args.aflink == "synthetic":
            from busca_tpu_torch.models.aflink import train_aflink_synthetic

            link_model, acc = train_aflink_synthetic(steps=200,
                                                     device=args.device)
            print(f"aflink: synthetic-trained link model (acc {acc:.2f})")
        elif args.aflink:
            link_model = load_aflink(args.aflink, args.device)
        if args.det_ap and (args.lockstep or args.npy_det
                            or (args.detector in (None, "centertrack")
                                and not args.detector_artifact)):
            print("WARNING: --det-ap only applies to the per-sequence "
                  "yolox/transcenter live-detector path; no detection-AP "
                  "table will be produced for this mode", file=sys.stderr)
        run = run_lockstep if args.lockstep else run_mot
        return run(args, detector, engine, tracker_kwargs,
                   feature_extractor, link_model)
    parser.error("pick a mode: --synthetic or --mot-dir")


if __name__ == "__main__":
    main()
