"""Per-sequence tracker presets, as data (port of the BYTE-threshold part
of ``busca_tpu.eval.presets``).

The reference hard-codes per-video BYTE thresholds inside its eval loop
(adapters/ByteTrack/yolox/evaluators/mot_evaluator.py:141-164), and GHOST
gates its ego-motion compensation per sequence
(adapters/GHOST/src/tracking_utils.py:209-221).  Both are copied here as
data for the eval CLI.  The published MOT17-val golden table is here for
``eval/golden.py``.
"""

from __future__ import annotations

from typing import Dict, Optional

# mot_evaluator.py:146-150 — per-video track_buffer overrides
_CUSTOM_TRACK_BUFFER = {
    "MOT17-05-FRCNN": 14,
    "MOT17-06-FRCNN": 14,
    "MOT17-13-FRCNN": 25,
    "MOT17-14-FRCNN": 25,
}

# mot_evaluator.py:152-163 — per-video track_thresh overrides
_CUSTOM_TRACK_THRESH = {
    "MOT17-01-FRCNN": 0.65,
    "MOT17-06-FRCNN": 0.65,
    "MOT17-12-FRCNN": 0.7,
    "MOT17-14-FRCNN": 0.67,
    "MOT20-06": 0.3,
    "MOT20-08": 0.3,
}


def ghost_is_moving(seq_name: str) -> bool:
    """Whether a sequence's camera moves (GHOST's per-sequence ego-motion
    gate, adapters/GHOST/src/tracking_utils.py:209-221): MOT17/MOT20
    sequences 13/11/10/05/14/12/07/06 are moving, 09/04/02/08/03/01 static,
    DanceTrack static, everything else (unknown datasets) moving."""
    name = seq_name.lower()
    if "mot" not in name and "dance" not in name:
        return True
    if "dance" in name:
        return False
    parts = seq_name.split("-")
    if len(parts) >= 2:
        num = parts[1]
        if num in ("13", "11", "10", "05", "14", "12", "07", "06"):
            return True
        if num in ("09", "04", "02", "08", "03", "01"):
            return False
    return True


def custom_byte_thresholds(
    video_name: str,
    base_track_thresh: float,
    base_track_buffer: int = 30,
    ignore: bool = False,
) -> Dict[str, float]:
    """The reference's per-sequence BYTE threshold table.

    Matches mot_evaluator.py:141-164: sequences not in the table (and all
    sequences when ``ignore`` is set, the ``ignore_custom_byte_thresholds``
    flag) use the base values.  Video names follow MOTChallenge directory
    naming (e.g. ``MOT17-05-FRCNN``); bare ``MOT17-05`` also matches.
    """
    if ignore:
        return {"track_thresh": base_track_thresh, "track_buffer": 30}
    names = [video_name]
    if video_name.startswith("MOT17") and not video_name.endswith("-FRCNN"):
        names.append(video_name + "-FRCNN")
    buf = base_track_buffer if base_track_buffer != 30 else 30
    thresh = base_track_thresh
    for n in names:
        if n in _CUSTOM_TRACK_BUFFER:
            buf = _CUSTOM_TRACK_BUFFER[n]
        if n in _CUSTOM_TRACK_THRESH:
            thresh = _CUSTOM_TRACK_THRESH[n]
    return {"track_thresh": thresh, "track_buffer": buf}


# README.md:126-131 — the published MOT17-val StrongSORT golden table
# (BoT + ECC + NSA + EMA + MC + woC, seq_len 11, 5 candidates, thresh 0.5).
GOLDEN_MOT17_VAL = {
    "strongsort": {"mota": 76.174, "hota": 69.289, "idf1": 81.864, "ids": 234},
    "strongsort_busca": {
        "mota": 76.795,
        "hota": 69.392,
        "idf1": 82.272,
        "ids": 219,
    },
}


def golden_diff(
    measured: Dict[str, float],
    variant: str = "strongsort_busca",
    table: Optional[Dict[str, Dict[str, float]]] = None,
) -> Dict[str, Dict[str, float]]:
    """Measured metrics vs the golden table -> {metric: {want, got, diff}}.

    ``measured`` uses the same keys (mota/hota/idf1 as percentages, ids as a
    count).  The report is data; callers decide tolerances.
    """
    table = table or GOLDEN_MOT17_VAL
    want = table[variant]
    report = {}
    for k, v in want.items():
        got = measured.get(k)
        report[k] = {
            "want": v,
            "got": got,
            "diff": None if got is None else round(got - v, 3),
        }
    return report
