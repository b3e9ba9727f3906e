"""Full-loop demonstration: train BUSCA, deploy it, rescue tracks (port of
``busca_tpu.train.demo``).

Trains a small decision model on synthetic multi-choice episodes until it
learns appearance + motion matching, builds an
:class:`~busca_tpu_torch.assoc.engine.AssociationEngine` from the trained
model, and runs the BYTE strategy over a synthetic sequence with a detector
dropout window: the track must survive on the strength of the learned
model.  This closes the loop train -> engine -> tracker -> metrics.

    python -m busca_tpu_torch.train.demo [--device cpu]

It runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def train_demo_model(
    steps: int = 120,
    batch: int = 16,
    seq_len: int = 3,
    num_candidates: int = 2,
    crop_hw: Tuple[int, int] = (64, 32),
    lr: float = 3e-4,
    seed: int = 0,
    log_every: int = 0,
    mem_stride_max: int = 1,
    device="cuda",
):
    """Train a tiny BuscaModel on synthetic episodes on ``device``, with
    optax's ``adamw(lr)`` (weight decay 1e-4, no clip, no schedule).

    Returns ``(config, model, final_metrics)``; the model is left in eval
    mode."""
    from busca_tpu_torch.models.busca import BuscaConfig, BuscaModel
    from busca_tpu_torch.train.data import EpisodeSpec, synthetic_batch
    from busca_tpu_torch.train.trainer import (
        make_optimizer,
        make_train_step,
        step_generator,
    )
    from busca_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg = BuscaConfig(num_layer=1, reid_num_classes=5,
                      reid_layers=(1, 1, 1, 1), dropout_p=0.0)
    spec = EpisodeSpec(batch=batch, seq_len=seq_len,
                       num_candidates=num_candidates, crop_hw=crop_hw,
                       mem_stride_max=mem_stride_max)
    rng = np.random.RandomState(seed)
    synthetic_batch(rng, spec)  # busca_tpu initializes on this batch
    model = BuscaModel(cfg)
    model.init_weights(torch.Generator().manual_seed(seed))
    model.to(dev)
    step = make_train_step(model, make_optimizer(model.parameters(), lr,
                                                 grad_clip=None))
    metrics = {}
    acc_hist = []
    for i in range(steps):
        metrics = step(synthetic_batch(rng, spec),
                       step_generator(seed + 1, i, dev))
        acc_hist.append(float(metrics["accuracy"]))
        if log_every and i % log_every == 0:
            print(f"step {i}: loss {float(metrics['loss']):.3f} "
                  f"acc {acc_hist[-1]:.2f}", flush=True)
    model.eval()
    return cfg, model, {
        "loss": float(metrics["loss"]),
        "accuracy": float(np.mean(acc_hist[-10:])),
    }


def rescue_sequence(num_frames: int = 26):
    """The demo's two-object sequence; the first object drops out of the
    detections in frames 12-17."""
    from busca_tpu_torch.eval.synthetic import (
        SyntheticObject,
        SyntheticSequence,
    )

    objs = [
        SyntheticObject(color=np.array([40, 200, 60], np.float64),
                        x0=40, y0=60, vx=3.0, vy=0.5, w=36, h=72,
                        dropout=(12, 18)),
        SyntheticObject(color=np.array([210, 60, 180], np.float64),
                        x0=280, y0=150, vx=-2.0, vy=-0.8, w=40, h=80),
    ]
    return SyntheticSequence(objs, num_frames=num_frames)


def run_trained_rescue(cfg, model, seq_len: int = 3,
                       num_candidates: int = 2,
                       crop_hw: Tuple[int, int] = (64, 32),
                       num_frames: int = 26) -> Dict[str, dict]:
    """Base vs trained-BUSCA BYTE tracking over the dropout sequence, on
    the model's device.  Each entry has ``mota``, ``idf1``, ``hota``,
    ``fn``, ``ids`` and the raw ``results``."""
    from busca_tpu_torch.assoc.engine import AssociationEngine
    from busca_tpu_torch.eval.metrics import evaluate_hota
    from busca_tpu_torch.eval.runner import (
        evaluate_sequence,
        results_to_pred,
        run_sequence,
    )
    from busca_tpu_torch.trackers.byte import ByteTracker, ByteTrackerConfig

    seq = rescue_sequence(num_frames)
    dets = [seq.detections(t) for t in range(num_frames)]
    gt = seq.ground_truth()
    engine = AssociationEngine(cfg, model, seq_len=seq_len,
                               num_candidates=num_candidates,
                               crop_hw=crop_hw, buckets=(1, 2, 4))
    out = {}
    for tag, eng in (("base", None), ("busca", engine)):
        tracker = ByteTracker(ByteTrackerConfig(
            use_busca=eng is not None, seq_len=seq_len,
            num_candidates=num_candidates, crop_hw=crop_hw,
            # the demo model was trained on consecutive-frame memories, so
            # the broader-memory subsampling is off (a reference knob too)
            use_broader_memory=False,
        ), assoc_engine=eng)
        res = run_sequence(tracker, (seq.frame(t) for t in range(num_frames)),
                           dets)
        m = evaluate_sequence(res, gt)
        h = evaluate_hota(gt, results_to_pred(res))
        out[tag] = {"mota": m.mota, "idf1": m.idf1, "hota": h["hota"],
                    "fn": m.num_misses, "ids": m.num_switches,
                    "results": res.results}
    return out


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        from busca_tpu_torch.utils.device import set_card_precision

        set_card_precision()
    print("training the decision model on synthetic episodes...")
    cfg, model, metrics = train_demo_model(log_every=20, device=args.device)
    print(f"trained: {metrics}")
    print("tracking the dropout sequence (base vs trained BUSCA)...")
    out = run_trained_rescue(cfg, model)
    for tag, m in out.items():
        print(f"{tag:6s} MOTA={m['mota']:.3f} IDF1={m['idf1']:.3f} "
              f"HOTA={m['hota']:.3f} FN={m['fn']} IDs={m['ids']}")
    return out


if __name__ == "__main__":
    main()
