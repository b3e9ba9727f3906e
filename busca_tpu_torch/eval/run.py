"""CLI: run the BYTE tracker (optionally + BUSCA) on the synthetic dropout
sequence and report the A/B metrics (port of the ``--synthetic`` mode of
``busca_tpu.eval.run``).

Example::

    python -m busca_tpu_torch.eval.run --synthetic --use-busca
    python -m busca_tpu_torch.eval.run --synthetic --use-busca --device cpu

Without ``--busca-config`` the model is ``BuscaConfig()`` (ResNet-50,
d=512, 4 layers, 4 heads, ff 1024); without ``--busca-ckpt`` its weights are
random, drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional

import torch


def build_engine(config: Optional[str] = None, ckpt: Optional[str] = None,
                 device="cuda", crop_hw=(384, 128),
                 bank_slots: Optional[int] = None, seed: int = 0):
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
        busca_cfg = dataclasses.replace(busca_cfg, dtype="float32")
    else:
        busca_cfg, tracker_kwargs = BuscaConfig(), {}
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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--tracker", default="byte", choices=["byte"])
    parser.add_argument("--use-busca", action="store_true")
    parser.add_argument("--busca-config", default=None,
                        help="BUSCA YAML (reference configs load unchanged);"
                             " default: BuscaConfig()")
    parser.add_argument("--busca-ckpt", default=None,
                        help=".npz or reference .pth weights; default: "
                             "random weights from --seed")
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
    args = parser.parse_args(argv)
    args.crop_hw = (args.crop_h, args.crop_w)

    engine, tracker_kwargs = None, {}
    if args.use_busca:
        engine, tracker_kwargs = build_engine(
            args.busca_config, args.busca_ckpt, args.device, args.crop_hw,
            bank_slots=args.crop_bank_slots, seed=args.seed,
        )
        tracker_kwargs["use_busca"] = True
    if args.cmc_scale != 1.0:
        tracker_kwargs["cmc_scale"] = args.cmc_scale

    if args.synthetic:
        out = run_synthetic(args, engine, tracker_kwargs)
        print(json.dumps(out, indent=2))
        return out
    parser.error("pick a mode: --synthetic (--mot-dir is not ported yet)")


if __name__ == "__main__":
    main()
