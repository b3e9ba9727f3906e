"""CLI: run the BYTE tracker (optionally + BUSCA) and report metrics (port
of ``busca_tpu.eval.run``).

Modes:
- ``--synthetic``: the built-in dropout sequence; base vs BUSCA A/B.
- ``--mot-dir DIR ... --detector yolox-x``: the live detector-in-the-loop
  path (reference mot_evaluator.py:131-235) over MOTChallenge sequence
  directories (``seqinfo.ini``, ``img1/*.jpg``, optional ``gt/gt.txt``):
  YOLOX (tiny, s, m, l, x) or TransCenter per frame, NMS on the device, the
  tracker fed with the detections and the device canvas; MOTChallenge
  result txts under ``--output-dir``, per-sequence CLEAR (and ``--hota``)
  against the gt, and the accumulated CLEAR as JSON.  The per-video BYTE
  threshold table applies unless ``--ignore-custom-byte-thresholds``.
  Frames are decoded with cv2, so this mode runs where cv2 is installed.

Example::

    python -m busca_tpu_torch.eval.run --synthetic --use-busca
    python -m busca_tpu_torch.eval.run --mot-dir MOT17-05-FRCNN \\
        --detector yolox-x --detector-ckpt bytetrack_x_mot17.pth.tar \\
        --use-busca
    python -m busca_tpu_torch.eval.run --mot-dir seq --detector yolox-tiny \\
        --test-h 128 --test-w 224 --device cpu

Without ``--busca-config`` the model is ``BuscaConfig()`` (ResNet-50,
d=512, 4 layers, 4 heads, ff 1024); without ``--busca-ckpt`` its weights are
random, drawn from ``--seed``; without ``--detector-ckpt`` so are the
detector's.  ``--busca-dtype`` (default ``bfloat16``, as busca_tpu's CLI)
is BUSCA's compute dtype; ``float32`` is the parity mode.  The detectors
take their dtype from their configs only, as in busca_tpu.  On the card the
CLI turns TF32 off and keeps bf16 products' reductions in float32
(:func:`~busca_tpu_torch.utils.device.set_card_precision`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional

import torch


def build_engine(config: Optional[str] = None, ckpt: Optional[str] = None,
                 device="cuda", crop_hw=(384, 128),
                 bank_slots: Optional[int] = None, seed: int = 0,
                 dtype: Optional[str] = None):
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
    model = BuscaModel(busca_cfg)
    model.init_weights(torch.Generator().manual_seed(seed))
    if ckpt:
        load_checkpoint(model, ckpt)
    model = model.to(dev).eval()
    if bank_slots is None:
        bank_slots = 4096 if dev.type == "cuda" else 256
    bank = DeviceCropBank(crop_hw, bank_slots, dev) if bank_slots else None
    engine = AssociationEngine(
        busca_cfg, model,
        seq_len=tracker_kwargs.get("seq_len", 11),
        num_candidates=tracker_kwargs.get("num_candidates", 5),
        crop_hw=crop_hw, bank=bank,
    )
    return engine, tracker_kwargs


def make_tracker(name: str, tracker_kwargs: dict, engine, crop_hw=(384, 128)):
    """A tracker for ``name``: ``byte`` (``bytetrack``) or ``transcenter``
    (BYTE with the detector-feedback export)."""
    if name not in ("byte", "bytetrack", "transcenter"):
        raise ValueError(f"tracker {name!r} is not ported yet (ROADMAP.md "
                         "Queue 1, slices 4-5)")
    from busca_tpu_torch.trackers.byte import ByteTracker, ByteTrackerConfig
    from busca_tpu_torch.trackers.transcenter import TransCenterByteTracker

    known = {f.name for f in dataclasses.fields(ByteTrackerConfig)}
    cfg = ByteTrackerConfig(
        **{k: v for k, v in tracker_kwargs.items() if k in known}
    )
    cfg.crop_hw = crop_hw
    cfg.use_busca = engine is not None and tracker_kwargs.get("use_busca",
                                                              True)
    if name == "transcenter":
        return TransCenterByteTracker(cfg, engine)
    return ByteTracker(cfg, engine)


def run_synthetic(args, engine, tracker_kwargs, seq=None) -> dict:
    """Base vs BUSCA A/B on the synthetic dropout sequence (or ``seq``).
    ``args`` needs ``tracker``, ``num_frames`` and ``crop_hw``."""
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
        tracker = make_tracker(args.tracker, tracker_kwargs, eng,
                               args.crop_hw)
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


# flags of busca_tpu's CLI whose code is not ported yet, and the ROADMAP.md
# Queue 1 item that ports it
LATER_FLAGS = {
    "lockstep": 21,
    "detector_artifact": 20,
    "gsi": 15,
    "aflink": 15,
    "det_ap": 24,
}


def build_detector(args):
    """The live detector of ``--detector``: a YOLOX size or TransCenter."""
    from busca_tpu_torch.eval.detector import (
        build_transcenter_detector,
        build_yolox_detector,
    )

    test_size = (args.test_h, args.test_w)
    if args.detector == "transcenter":
        return build_transcenter_detector(
            dataset=args.detector_dataset, ckpt=args.detector_ckpt,
            test_size=test_size, out_thresh=args.det_conf,
            device=args.device, seed=args.seed)
    return build_yolox_detector(
        size=args.detector.split("-")[-1], ckpt=args.detector_ckpt,
        test_size=test_size, conf_thresh=args.det_conf,
        nms_thresh=args.det_nms, device=args.device, seed=args.seed)


def run_mot_detector(args, detector, engine, tracker_kwargs) -> dict:
    """The live detector over each ``--mot-dir`` sequence: results file,
    per-sequence CLEAR (+ HOTA with ``--hota``) where a gt exists, and the
    accumulated CLEAR printed as JSON.  Returns ``{name: MotMetrics}``."""
    import itertools
    import os

    from busca_tpu_torch.eval import mot
    from busca_tpu_torch.eval.detector import track_frames_with_detector
    from busca_tpu_torch.eval.loader import sequence_frames
    from busca_tpu_torch.eval.metrics import (
        accumulate,
        evaluate_clear,
        evaluate_hota,
    )
    from busca_tpu_torch.eval.presets import custom_byte_thresholds
    from busca_tpu_torch.eval.runner import results_to_pred

    per_seq = {}
    for seq_dir in args.mot_dir:
        name = os.path.basename(seq_dir.rstrip("/"))
        # the per-video BYTE threshold table (mot_evaluator.py:141-164)
        seq_kwargs = dict(tracker_kwargs)
        seq_kwargs.update(custom_byte_thresholds(
            name, seq_kwargs.get("track_thresh", 0.6),
            seq_kwargs.get("track_buffer", 30),
            ignore=args.ignore_custom_byte_thresholds))
        tracker = make_tracker(args.tracker, seq_kwargs, engine,
                               args.crop_hw)
        if hasattr(detector, "reset"):
            detector.reset()  # per video (mot_evaluator.py:148-150)
        info = mot.load_seqinfo(seq_dir)
        frames = iter(sequence_frames(info))
        if args.max_frames:
            frames = itertools.islice(frames, args.max_frames)
        res = track_frames_with_detector(detector, tracker, frames,
                                         name=info.name)
        mot.write_results(os.path.join(args.output_dir, f"{name}.txt"),
                          res.results)
        stage = ", ".join(
            f"{k.rstrip('_s')} {v / max(res.num_frames, 1) * 1e3:.1f} "
            "ms/frame" for k, v in res.stage_times.items())
        print(f"{name}: {res.num_frames} frames @ {res.fps:.1f} fps "
              f"({stage})")
        gt_path = os.path.join(seq_dir, "gt", "gt.txt")
        if os.path.exists(gt_path):
            gt = mot.read_gt(gt_path)
            pred = results_to_pred(res)
            per_seq[name] = evaluate_clear(gt, pred)
            if args.hota:
                h = evaluate_hota(gt, pred)
                print("  " + "  ".join(
                    f"{label} {h[label.lower()] * 100:.3f}"
                    for label in ("HOTA", "DetA", "AssA", "DetRe", "DetPr",
                                  "AssRe", "AssPr", "LocA")))
    if per_seq:
        print(json.dumps(accumulate(per_seq).as_dict(), indent=2))
    return per_seq


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--tracker", default="byte",
                        choices=["byte", "transcenter"])
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
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--num-frames", type=int, default=40)
    parser.add_argument("--crop-h", type=int, default=384)
    parser.add_argument("--crop-w", type=int, default=128)
    from busca_tpu_torch.trackers.cmc import parse_scale
    parser.add_argument("--cmc-scale", type=parse_scale, default=1.0)
    parser.add_argument("--mot-dir", nargs="*", default=[],
                        help="MOTChallenge sequence directories")
    parser.add_argument("--output-dir", default="results")
    parser.add_argument("--detector", default=None,
                        choices=["yolox-tiny", "yolox-s", "yolox-m",
                                 "yolox-l", "yolox-x", "transcenter",
                                 "centertrack"],
                        help="the live detector run per frame")
    parser.add_argument("--detector-ckpt", default=None,
                        help="official YOLOX .pth or busca_tpu .npz "
                             "(TransCenter: .npz only); default: random "
                             "weights from --seed")
    parser.add_argument("--detector-dataset", default="mot17",
                        choices=["mot17", "mot20"],
                        help="TransCenter per-dataset preset")
    parser.add_argument("--test-h", type=int, default=800)
    parser.add_argument("--test-w", type=int, default=1440)
    parser.add_argument("--det-conf", type=float, default=0.01,
                        help="exp.test_conf (BYTE consumes low-conf dets)")
    parser.add_argument("--det-nms", type=float, default=0.7,
                        help="exp.nmsthre")
    parser.add_argument("--max-frames", type=int, default=None,
                        help="cap frames per sequence")
    parser.add_argument("--hota", action="store_true",
                        help="also print per-sequence HOTA and its parts")
    parser.add_argument("--ignore-custom-byte-thresholds",
                        action="store_true",
                        help="disable the per-video BYTE threshold table")
    for flag in LATER_FLAGS:
        opt = "--" + flag.replace("_", "-")
        if flag == "aflink":
            parser.add_argument(opt, default=None)
        else:
            parser.add_argument(opt, default=None, nargs="?", const=True)
    args = parser.parse_args(argv)
    args.crop_hw = (args.crop_h, args.crop_w)
    for flag, item in LATER_FLAGS.items():
        if getattr(args, flag):
            parser.error(f"--{flag.replace('_', '-')} is not ported yet "
                         f"(ROADMAP.md Queue 1 item {item})")
    if args.detector == "centertrack":
        parser.error("--detector centertrack is not ported yet (ROADMAP.md "
                     "Queue 1 item 18)")

    from busca_tpu_torch.utils.device import set_card_precision

    set_card_precision()
    engine, tracker_kwargs = None, {}
    if args.use_busca:
        engine, tracker_kwargs = build_engine(
            args.busca_config, args.busca_ckpt, args.device, args.crop_hw,
            bank_slots=args.crop_bank_slots, seed=args.seed,
            dtype=args.busca_dtype,
        )
        tracker_kwargs["use_busca"] = True
    if args.cmc_scale != 1.0:
        tracker_kwargs["cmc_scale"] = args.cmc_scale

    if args.synthetic:
        out = run_synthetic(args, engine, tracker_kwargs)
        print(json.dumps(out, indent=2))
        return out
    if args.mot_dir:
        if not args.detector:
            parser.error("--mot-dir needs a live --detector; the cached "
                         "det/det.txt path is not ported yet (ROADMAP.md "
                         "Queue 1 item 9)")
        try:
            detector = build_detector(args)
        except ValueError as e:
            parser.error(str(e))
        return run_mot_detector(args, detector, engine, tracker_kwargs)
    parser.error("pick a mode: --synthetic or --mot-dir")


if __name__ == "__main__":
    main()
