"""BDD100k output conversion — MOTChallenge result txts -> BDD json (port
of ``busca_tpu.eval.bdd``, host numpy).

Rebuilds the GHOST manager's ``MOT2BDD``/``MOT2BDDTest`` converters
(adapters/GHOST/src/manager.py:217-305): per sequence, the MOT rows are
grouped by frame into ``{"name": "<seq>-<frame:07d>.jpg", "labels": [...]}``
dicts with ``box2d`` corners and the BDD category names; categories outside
the evaluated set are dropped.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

# manager.py:276-278 (1-based label ids -> BDD category names)
BDD_NAME_MAPPING: Dict[int, str] = {
    1: "pedestrian",
    2: "rider",
    3: "car",
    4: "truck",
    5: "bus",
    6: "train",
    7: "motorcycle",
    8: "bicycle",
}


def mot_rows_to_bdd(
    seq_name: str,
    rows: np.ndarray,
    classes: Optional[Dict[int, str]] = None,
    classes_for_eval: Optional[Sequence[str]] = None,
) -> List[dict]:
    """Convert MOT rows ``[frame, id, left, top, w, h, conf, ?, label, vis]``
    (label column optional — missing/-1 labels map to pedestrian) to the BDD
    frame-dict list (manager.py:231-253)."""
    classes = classes or BDD_NAME_MAPPING
    rows = np.asarray(rows, dtype=np.float64)
    if rows.size == 0:
        return []
    if rows.ndim == 1:
        rows = rows[None]
    out = []
    for frame in np.unique(rows[:, 0]).astype(int):
        frame_rows = rows[rows[:, 0].astype(int) == frame]
        labels_list = []
        for r in frame_rows:
            label = int(r[8]) if rows.shape[1] > 8 and r[8] > 0 else 1
            category = classes.get(label)
            if category is None:
                continue
            if classes_for_eval is not None and category not in classes_for_eval:
                continue
            labels_list.append(
                {
                    "id": int(r[1]),
                    "category": category,
                    "box2d": {
                        "x1": float(r[2]),
                        "y1": float(r[3]),
                        "x2": float(r[2] + r[4]),
                        "y2": float(r[3] + r[5]),
                    },
                }
            )
        out.append(
            {"name": f"{seq_name}-{frame:07d}.jpg", "labels": labels_list}
        )
    return out


def convert_results_dir(
    results_dir: str,
    out_dir: Optional[str] = None,
    classes: Optional[Dict[int, str]] = None,
    classes_for_eval: Optional[Sequence[str]] = None,
) -> List[str]:
    """Convert every MOT ``<seq>.txt`` in a results directory to
    ``<seq>.json`` in BDD format (manager.py:218-259).  Returns the written
    paths."""
    out_dir = out_dir or results_dir
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for fname in sorted(os.listdir(results_dir)):
        if not fname.endswith(".txt"):
            continue
        seq = fname[:-4]
        path = os.path.join(results_dir, fname)
        rows = np.loadtxt(path, delimiter=",", ndmin=2) if os.path.getsize(
            path
        ) else np.zeros((0, 10))
        bdd = mot_rows_to_bdd(seq, rows, classes, classes_for_eval)
        out_path = os.path.join(out_dir, seq + ".json")
        with open(out_path, "w") as f:
            json.dump(bdd, f)
        written.append(out_path)
    return written


def read_bdd_json(
    path_or_list,
    classes_for_eval: Optional[Sequence[str]] = None,
    video: Optional[str] = None,
    skip_crowd: bool = True,
) -> Dict[int, tuple]:
    """BDD frame-dict json -> the ``{frame: (tlwh [N,4], ids [N])}`` input
    the CLEAR/IDF1/HOTA metrics consume (the role of the GHOST BDD TrackEval
    invocation, manager.py:205-215 — its module lives in the absent
    submodule, so the evaluation runs through the port's own metric stack).

    Frame index comes from ``frameIndex`` when present (official BDD MOT
    labels, 0-based -> 1-based) else parsed from the ``name`` suffix.
    ``crowd``-attributed boxes are ignore regions in the official protocol
    and are skipped from the returned set (the simplification here: they do
    not also suppress overlapping predictions).  A list spanning several
    ``videoName``s needs an explicit ``video`` selection — frame indices
    restart per video, so pooling them would silently overwrite frames.
    """
    import re

    if isinstance(path_or_list, (str, os.PathLike)):
        with open(path_or_list) as f:
            frames = json.load(f)
    else:
        frames = path_or_list
    frames = _select_video(frames, video)
    by_cat = _bucket_bdd_frames(frames, classes_for_eval, skip_crowd,
                                split_categories=False)
    return by_cat.get(None, {})


def _select_video(frames, video):
    """Restrict BDD frame dicts to one videoName (frame indices restart
    per video, so pooling would silently overwrite frames)."""
    videos = {fd.get("videoName") for fd in frames if "videoName" in fd}
    if video is not None:
        return [fd for fd in frames if fd.get("videoName") == video]
    if len(videos) > 1:
        raise ValueError(
            f"labels span {len(videos)} videos ({sorted(videos)[:4]}...); "
            "pass video=<name> to select one"
        )
    return frames


def _bucket_bdd_frames(
    frames,
    classes_for_eval: Optional[Sequence[str]],
    skip_crowd: bool,
    split_categories: bool,
) -> Dict[Optional[str], Dict[int, tuple]]:
    """One pass over BDD frame dicts -> per-category (or pooled, key None)
    ``{frame: (tlwh, ids)}`` maps.  Shared by read_bdd_json and evaluate_bdd
    so the per-category mMOTA loop parses every frame dict exactly once."""
    import re

    acc: Dict[Optional[str], Dict[int, tuple]] = {}
    for fd in frames:
        if "frameIndex" in fd:
            frame = int(fd["frameIndex"]) + 1
        else:
            m = re.search(r"(\d+)\.\w+$", fd.get("name", ""))
            if not m:
                continue
            frame = int(m.group(1))
        per_key: Dict[Optional[str], tuple] = {}
        for lab in fd.get("labels", []):
            cat = lab.get("category")
            if classes_for_eval is not None and cat not in classes_for_eval:
                continue
            if skip_crowd and lab.get("attributes", {}).get("crowd"):
                continue
            b = lab.get("box2d")
            if b is None:
                continue
            key = cat if split_categories else None
            tlwhs, ids = per_key.setdefault(key, ([], []))
            tlwhs.append(
                [b["x1"], b["y1"], b["x2"] - b["x1"], b["y2"] - b["y1"]]
            )
            ids.append(int(lab["id"]))
        for key, (tlwhs, ids) in per_key.items():
            if ids:
                acc.setdefault(key, {})[frame] = (
                    np.asarray(tlwhs, np.float64),
                    np.asarray(ids, int),
                )
    return acc


def evaluate_bdd(
    gt_json,
    pred_json,
    classes_for_eval: Optional[Sequence[str]] = None,
    video: Optional[str] = None,
):
    """Per-category CLEAR metrics of a BDD prediction json vs a BDD gt json.

    The BDD MOT protocol evaluates each category independently (mMOTA =
    mean over categories); pooling classes would credit cross-category
    matches.  Returns ``{category: MotMetrics, ..., "mMOTA": float,
    "mIDF1": float}`` over the categories present in the gt (optionally
    restricted by ``classes_for_eval``).
    """
    from busca_tpu_torch.eval.metrics import evaluate_clear

    if isinstance(gt_json, (str, os.PathLike)):
        with open(gt_json) as f:
            gt_json = json.load(f)
    if isinstance(pred_json, (str, os.PathLike)):
        with open(pred_json) as f:
            pred_json = json.load(f)

    # single parse of each json; labels bucketed per category in one pass
    gt_by_cat = _bucket_bdd_frames(
        _select_video(gt_json, video), classes_for_eval,
        skip_crowd=True, split_categories=True,
    )
    pred_by_cat = _bucket_bdd_frames(
        _select_video(pred_json, video), classes_for_eval,
        skip_crowd=True, split_categories=True,
    )
    out = {}
    motas, idf1s = [], []
    for cat in sorted(c for c in gt_by_cat if c):
        gt = gt_by_cat[cat]
        pred = {
            f: (tlwh, ids, np.ones(len(ids)))
            for f, (tlwh, ids) in pred_by_cat.get(cat, {}).items()
        }
        m = evaluate_clear(gt, pred)
        out[cat] = m
        motas.append(m.mota)
        idf1s.append(m.idf1)
    out["mMOTA"] = float(np.mean(motas)) if motas else 0.0
    out["mIDF1"] = float(np.mean(idf1s)) if idf1s else 0.0
    return out
