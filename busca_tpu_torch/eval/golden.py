"""Golden-number regression harness: StrongSORT(+BUSCA) on MOT17-val (port
of ``busca_tpu.eval.golden``).

One command that reproduces the reference's published acceptance table
(README.md:126-131: MOTA 76.795 / HOTA 69.392 / IDF1 82.272 / IDs 219 for
StrongSORT+BUSCA; 76.174 / 69.289 / 81.864 / 234 for the baseline) and
prints the parity diff — runnable the day the external artifacts land, and
a clean SKIP until then (weights and MOT17 data are downloads the reference
does not vendor, README.md:69-78).

Usage::

    python -m busca_tpu_torch.eval.golden \
        --mot-root /data/MOT17/train \
        --npy-dir /data/strongsort_dets \
        [--ecc-json /data/MOT17_ECC_val.json] \
        [--busca-config config/StrongSORT/MOT17/config_strongsort_mot17.yml \
         --busca-ckpt model_busca.pth] [--device cpu]

Artifacts expected (the reference's own inputs, deep_sort_app.py:50-52):
``<mot-root>/<seq>/`` MOTChallenge dirs with gt, ``<npy-dir>/<seq>.npy``
precomputed detections+features, optional ECC warp JSON, optional converted
BUSCA weights for the +BUSCA variant.  BUSCA runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# the reference's MOT17 val split (adapters/StrongSORT/opts.py:11-20)
MOT17_VAL_SEQUENCES = [
    "MOT17-02-FRCNN",
    "MOT17-04-FRCNN",
    "MOT17-05-FRCNN",
    "MOT17-09-FRCNN",
    "MOT17-10-FRCNN",
    "MOT17-11-FRCNN",
    "MOT17-13-FRCNN",
]


def check_artifacts(mot_root: str, npy_dir: str, sequences=None) -> list:
    """Missing-artifact report; empty list == runnable."""
    missing = []
    for seq in sequences or MOT17_VAL_SEQUENCES:
        seq_dir = os.path.join(mot_root, seq)
        if not os.path.isdir(os.path.join(seq_dir, "img1")):
            missing.append(f"{seq_dir}/img1")
        if not os.path.exists(os.path.join(seq_dir, "gt", "gt.txt")):
            missing.append(f"{seq_dir}/gt/gt.txt")
        if not os.path.exists(os.path.join(npy_dir, f"{seq}.npy")):
            missing.append(os.path.join(npy_dir, f"{seq}.npy"))
    return missing


def run_golden(args) -> dict:
    from busca_tpu_torch.eval import mot
    from busca_tpu_torch.eval.metrics import evaluate_hota
    from busca_tpu_torch.eval.presets import GOLDEN_MOT17_VAL, golden_diff
    from busca_tpu_torch.eval.runner import global_metrics, results_to_pred
    from busca_tpu_torch.eval.run import build_engine, make_tracker
    from busca_tpu_torch.eval.strongsort_io import (
        load_ecc_warps,
        run_cached_sequence,
    )

    sequences = args.sequences or MOT17_VAL_SEQUENCES
    engine, tracker_kwargs = None, {}
    variant = "strongsort"
    if args.busca_config:
        engine, tracker_kwargs = build_engine(
            args.busca_config, args.busca_ckpt,
            device=getattr(args, "device", "cuda"),
        )
        tracker_kwargs["use_busca"] = True
        variant = "strongsort_busca"

    ecc_all = load_ecc_warps(args.ecc_json) if args.ecc_json else None
    per_seq = {}
    hota_acc = []
    seq_results = {}
    if getattr(args, "lockstep", False):
        # frame-synchronized multi-sequence run: every sequence's BUSCA
        # third round batches into one association call (numerics identical
        # to standalone runs — per-request BN groups)
        from busca_tpu_torch.eval import mot as _mot
        from busca_tpu_torch.eval.strongsort_io import (
            run_cached_sequences_lockstep,
        )

        specs = [
            (
                os.path.join(args.mot_root, seq),
                os.path.join(args.npy_dir, f"{seq}.npy"),
                ecc_all.get(seq) if ecc_all else None,
            )
            for seq in sequences
        ]
        trackers = [
            make_tracker("strongsort", tracker_kwargs, engine)
            for _ in sequences
        ]
        for seq, res in zip(
            sequences,
            run_cached_sequences_lockstep(
                specs, trackers, min_confidence=args.min_confidence,
                max_frames=args.max_frames,
            ),
        ):
            _mot.write_results(
                os.path.join(args.output_dir, f"{seq}.txt"), res.results
            )
            seq_results[seq] = res
    for seq in sequences:
        seq_dir = os.path.join(args.mot_root, seq)
        if seq in seq_results:
            res = seq_results[seq]
        else:
            tracker = make_tracker("strongsort", tracker_kwargs, engine)
            res = run_cached_sequence(
                seq_dir,
                os.path.join(args.npy_dir, f"{seq}.npy"),
                tracker,
                min_confidence=args.min_confidence,
                ecc_warps=ecc_all.get(seq) if ecc_all else None,
                output_file=os.path.join(args.output_dir, f"{seq}.txt"),
                max_frames=args.max_frames,
            )
        gt = mot.read_gt(os.path.join(seq_dir, "gt", "gt.txt"))
        pred = results_to_pred(res)
        from busca_tpu_torch.eval.metrics import evaluate_clear

        per_seq[seq] = evaluate_clear(gt, pred)
        h = evaluate_hota(gt, pred)
        hota_acc.append((h["hota"], per_seq[seq].num_gt))
        print(f"{seq}: {res.num_frames} frames @ {res.fps:.1f} fps  "
              f"MOTA {per_seq[seq].mota * 100:.3f}")

    agg = global_metrics(per_seq)
    # NOTE: TrackEval accumulates HOTA's match counts globally across
    # sequences; the gt-weighted mean of per-sequence HOTA used here is a
    # close approximation (exact when per-sequence alphas behave similarly),
    # adequate for the parity diff this harness reports.
    hota = (
        sum(h * w for h, w in hota_acc) / sum(w for _, w in hota_acc)
        if hota_acc
        else 0.0
    )
    measured = {
        "mota": agg.mota * 100,
        "hota": hota * 100,
        "idf1": agg.idf1 * 100,
        "ids": agg.num_switches,
    }
    report = golden_diff(measured, variant)
    print(json.dumps({"variant": variant, "measured": measured,
                      "golden": GOLDEN_MOT17_VAL[variant],
                      "diff": report}, indent=2))
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--mot-root", required=True,
                        help="directory holding MOT17-XX-FRCNN sequence dirs")
    parser.add_argument("--npy-dir", required=True,
                        help="directory holding <seq>.npy dets+features")
    parser.add_argument("--ecc-json", default=None)
    parser.add_argument("--busca-config", default=None)
    parser.add_argument("--busca-ckpt", default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--min-confidence", type=float, default=0.6)
    parser.add_argument("--output-dir", default="results/golden")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--lockstep", action="store_true",
                        help="frame-synchronized multi-sequence run "
                             "with batched BUSCA third rounds")
    parser.add_argument("--sequences", nargs="*", default=None,
                        help="override the MOT17-val list (for smoke runs)")
    args = parser.parse_args(argv)

    missing = check_artifacts(args.mot_root, args.npy_dir, args.sequences)
    if missing:
        print("SKIP: golden run needs external artifacts not present "
              "(README.md:69-78 downloads). Missing:")
        for m in missing[:20]:
            print("  -", m)
        return None
    os.makedirs(args.output_dir, exist_ok=True)
    return run_golden(args)


if __name__ == "__main__":
    sys.exit(0 if main() is not None or True else 1)
