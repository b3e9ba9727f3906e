"""Quantifying the bounded-memory deviation (``--mem-cap``; port of
``busca_tpu.eval.memcap_delta``).

``mem_cap`` (trackers/base.py ``compact_mem_lists``) bounds each track's
appearance-memory store for long-stream serving; the reference grows it for
the track's whole life (byte_tracker.py:150-156).  Once a track outlives
the cap its memory is an even-stride subsample of the admitted history, so
third-round decisions can differ.  :func:`measure_memcap_delta` measures how
much, as ``eval/frozen_delta.py`` bounds the frozen-stats mode: the
demo-trained decision model tracked end-to-end over synthetic dropout
sequences long enough that tracks outlive the cap, unbounded vs capped,
with one shared noise realization per sequence (MOTA / IDF1 / HOTA / FN /
ID-switch deltas, and the first differing output row).

The long streams keep their objects in frame for any length and drop them
from the detector periodically, so third-round decisions happen across the
whole stream; the serving soak (tests/test_torch_serve_soak.py) runs on
them too.  The same seed gives the same detections and frames as
busca_tpu's.

CLI (on the card unless ``--device cpu``)::

    python -m busca_tpu_torch.eval.memcap_delta [--long --broader]
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np

from busca_tpu_torch.eval.synthetic import SyntheticObject, SyntheticSequence


@dataclasses.dataclass
class _LongStreamObject(SyntheticObject):
    """An object that survives arbitrarily long streams: triangle-wave
    (bouncing) motion keeps it in frame, and the detector drops it for
    ``drop_len`` frames every ``drop_period`` (offset-staggered per object)
    so third-round decisions occur across the WHOLE stream."""

    travel: float = 200.0         # one-way travel in px
    drop_period: int = 150
    drop_len: int = 6
    drop_offset: int = 0
    warm: int = 20

    VSPAN = 35.0  # vertical travel kept small: rows must stay in frame

    def box_at(self, t: int) -> np.ndarray:
        span = max(self.travel, 1.0)
        sx = (self.vx * t) % (2 * span)
        sy = (self.vy * t) % (2 * self.VSPAN)
        dx = sx if sx <= span else 2 * span - sx
        dy = sy if sy <= self.VSPAN else 2 * self.VSPAN - sy
        return np.array([self.x0 + dx, self.y0 + dy, self.w, self.h])

    def detected_at(self, t: int) -> bool:
        if t < self.warm:
            return True
        phase = (t - self.drop_offset) % self.drop_period
        return not (0 <= phase < self.drop_len)


def _long_stream_sequence(seed: int, num_frames: int,
                          drop_period: int = 150, drop_len: int = 6):
    """Three bouncing objects on the 256x384 synthetic canvas, each dropped
    by the detector for ``drop_len`` of every ``drop_period`` frames."""
    rng = np.random.RandomState(seed)
    colors = [
        np.array([40, 200, 60], np.float64),
        np.array([210, 60, 180], np.float64),
        np.array([60, 120, 230], np.float64),
    ]
    objs = []
    for i, color in enumerate(colors):
        objs.append(_LongStreamObject(
            color=color,
            x0=float(rng.uniform(10, 60)),
            y0=float(rng.uniform(15 + 55 * i, 30 + 55 * i)),
            vx=float(rng.uniform(1.5, 3.0)),
            vy=float(rng.uniform(0.3, 0.8)),
            w=float(rng.uniform(30, 40)),
            h=float(rng.uniform(45, 55)),
            travel=220.0,
            drop_period=drop_period,
            drop_len=drop_len,
            drop_offset=int(rng.randint(0, drop_period))
                        + (i * drop_period) // 3,
            warm=25,
        ))
    return SyntheticSequence(objs, num_frames=num_frames, seed=seed)


def measure_memcap_delta(
    caps: Sequence[int] = (8, 16),
    steps: int = 60,
    train_batch: int = 12,
    seed: int = 3,
    num_frames: int = 120,
    seq_seeds: Sequence[int] = (0, 1, 2),
    cfg=None,
    model=None,
    seq_len: int = 3,
    num_candidates: int = 2,
    long_stream: bool = False,
    drop_period: int = 150,
    drop_len: int = 6,
    use_broader_memory: bool = False,
    device="cuda",
) -> dict:
    """Run the unbounded-vs-capped deviation measurement on ``device``.

    Trains the demo model (or takes ``cfg``/``model``), then for each
    synthetic dropout sequence runs the BUSCA-attached tracker unbounded
    and once per cap, all on one shared frame/detection realization.
    ``num_frames`` must comfortably exceed every cap (tracks must outlive
    the cap for the deviation to exist at all; with 120 frames a cap of 8
    compacts each surviving track's memory ~4 times).
    """
    from busca_tpu_torch.assoc.engine import AssociationEngine
    from busca_tpu_torch.eval.frozen_delta import (
        _random_dropout_sequence,
        _track_sequence,
    )
    from busca_tpu_torch.train.demo import train_demo_model

    crop_hw = (64, 32)
    train_metrics = {}
    if cfg is None or model is None:
        cfg, model, train_metrics = train_demo_model(
            steps=steps, batch=train_batch, seed=seed,
            seq_len=seq_len, num_candidates=num_candidates, crop_hw=crop_hw,
            # broader-memory runs consume even-stride-subsampled memories;
            # the stride augmentation keeps them in-distribution
            mem_stride_max=4 if use_broader_memory else 1,
            device=device,
        )

    engine = AssociationEngine(
        cfg, model, seq_len=seq_len,
        num_candidates=num_candidates, crop_hw=crop_hw, buckets=(1, 2, 4),
    )

    tags = ["unbounded"] + [f"cap{c}" for c in caps]
    per_seq: Dict[str, list] = {t: [] for t in tags}
    for s in seq_seeds:
        if long_stream:
            # bouncing objects + periodic staggered dropouts: decisions
            # across the whole stream, tracks alive the whole stream —
            # the 2k-10k-frame regime where the archive stride has doubled
            # many times
            seq = _long_stream_sequence(int(s), num_frames,
                                        drop_period=drop_period,
                                        drop_len=drop_len)
        else:
            seq = _random_dropout_sequence(int(s), num_frames)
        # one noise realization shared by every mode (frozen_delta.py:321)
        frames = [seq.frame(t) for t in range(num_frames)]
        dets = [seq.detections(t) for t in range(num_frames)]
        kw = dict(seq_len=seq_len, num_candidates=num_candidates,
                  crop_hw=crop_hw, frames=frames, dets=dets,
                  use_broader_memory=use_broader_memory)
        per_seq["unbounded"].append(_track_sequence(seq, engine, **kw))
        for c in caps:
            per_seq[f"cap{c}"].append(
                _track_sequence(seq, engine, mem_cap=int(c), **kw)
            )

    def agg(rows):
        keys = ("mota", "idf1", "hota", "fn", "ids")
        out = {k: float(np.mean([r[k] for r in rows])) for k in keys}
        for k in ("max_stride", "max_mem_len", "max_admissions"):
            if any(k in r for r in rows):
                out[k] = int(max(r.get(k, 0) for r in rows))
        return out

    def pred_divergence(pred_a, pred_b, num_frames):
        """Output-ROW-level comparison (metrics can coincide while rows
        differ): first frame whose (ids, boxes) differ + differing-frame
        count.  Boxes compared with ``np.allclose``'s rtol 1e-5 + atol
        1e-3, busca_tpu's comparison (not 1e-3 px: the relative term adds
        up to ~0.02 px at 1080p coordinates)."""
        first, n_diff = None, 0
        # prediction dicts are keyed 1..num_frames (runner.py:114,231)
        for f in range(1, num_frames + 1):
            a, b = pred_a.get(f), pred_b.get(f)
            same = (a is None) == (b is None)
            if same and a is not None:
                ia, ib = np.argsort(a[1]), np.argsort(b[1])
                same = (
                    a[1].shape == b[1].shape
                    and np.array_equal(a[1][ia], b[1][ib])
                    and np.allclose(a[0][ia], b[0][ib], atol=1e-3)
                )
            if not same:
                n_diff += 1
                if first is None:
                    first = f
        return first, n_diff

    metrics = {tag: agg(rows) for tag, rows in per_seq.items()}
    divergence = {}
    for c in caps:
        firsts, diffs = [], []
        for ru, rc in zip(per_seq["unbounded"], per_seq[f"cap{c}"]):
            first, n_diff = pred_divergence(
                ru["pred"], rc["pred"], num_frames)
            firsts.append(first)
            diffs.append(n_diff)
        real = [f for f in firsts if f is not None]
        divergence[f"cap{c}"] = {
            "first_diff_frame": min(real) if real else None,
            "diff_frames_total": int(np.sum(diffs)),
            "per_seed_first": firsts,
        }
    deltas = {
        f"cap{c}": {
            k: metrics[f"cap{c}"][k] - metrics["unbounded"][k]
            for k in ("mota", "idf1", "hota", "fn", "ids")
        }
        for c in caps
    }
    return {
        "train": train_metrics,
        "num_frames": num_frames,
        "caps": list(caps),
        "metrics": metrics,
        "per_sequence": per_seq,
        "delta": deltas,
        "divergence": divergence,
    }


def main(argv=None):
    """``python -m busca_tpu_torch.eval.memcap_delta`` — unbounded-vs-capped
    deviation; ``--long`` runs the length-sweep regime (bouncing objects,
    periodic dropouts, strides reported)."""
    import argparse

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--caps", type=int, nargs="*", default=None,
                   help="absolute caps; default 8,16 (or ~2.7x/5x/10x "
                        "seq_len with --long)")
    p.add_argument("--seq-len", type=int, default=3)
    p.add_argument("--num-candidates", type=int, default=2)
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--long", action="store_true",
                   help="long-stream regime: periodic dropouts across the "
                        "whole stream")
    p.add_argument("--drop-period", type=int, default=150)
    p.add_argument("--broader", action="store_true",
                   help="use_broader_memory=True: the even-stride sampler "
                        "over the WHOLE history — the one memory consumer "
                        "that reads the compacted archive (the dense tail "
                        "makes the default last-seq_len sampler exactly "
                        "cap-invariant)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from busca_tpu_torch.utils.device import set_card_precision

    set_card_precision()

    caps = args.caps
    if caps is None:
        caps = ([int(args.seq_len * 2.7), args.seq_len * 5,
                 args.seq_len * 10] if args.long else [8, 16])
    out = measure_memcap_delta(
        caps=caps, num_frames=args.frames,
        seq_seeds=tuple(range(args.seeds)), steps=args.steps,
        seq_len=args.seq_len, num_candidates=args.num_candidates,
        long_stream=args.long, drop_period=args.drop_period,
        use_broader_memory=args.broader, device=args.device,
    )
    print(f"train: {out['train']}")
    for tag, m in out["metrics"].items():
        extra = ""
        if "max_stride" in m:
            extra = (f"  stride={m['max_stride']} "
                     f"mem={m['max_mem_len']}/{m['max_admissions']}adm")
        print(
            f"{tag:10s} MOTA={m['mota']:.3f} IDF1={m['idf1']:.3f} "
            f"HOTA={m['hota']:.3f} FN={m['fn']:.1f} IDs={m['ids']:.1f}"
            + extra
        )
    for tag, d in out["delta"].items():
        dv = out["divergence"][tag]
        print(
            f"{tag}-unbounded delta: MOTA {d['mota']:+.4f} "
            f"IDF1 {d['idf1']:+.4f} HOTA {d['hota']:+.4f} "
            f"FN {d['fn']:+.1f} IDs {d['ids']:+.1f} | rows: "
            f"{dv['diff_frames_total']} differing frames, first at "
            f"{dv['first_diff_frame']}"
        )
    import json
    print(json.dumps({"metrics": out["metrics"], "delta": out["delta"],
                      "divergence": out["divergence"],
                      "num_frames": out["num_frames"]}))
    return out


if __name__ == "__main__":
    main()
