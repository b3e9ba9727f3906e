"""MOTChallenge dataset IO: results writer, gt/det readers, seqinfo (port
of ``busca_tpu.eval.mot``).

Formats follow the MOTChallenge convention used by the reference writers
(adapters/ByteTrack/yolox/evaluators/mot_evaluator.py:30-53,
adapters/GHOST/src/base_tracker.py:156-189):

results line: ``frame,id,x,y,w,h,score,-1,-1,-1`` (1-based frame ids, tlwh)
gt line     : ``frame,id,x,y,w,h,conf,class,visibility``
det line    : ``frame,-1,x,y,w,h,score,-1,-1,-1``
"""

from __future__ import annotations

import configparser
import dataclasses
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class SeqInfo:
    name: str
    img_dir: str
    frame_rate: int
    seq_length: int
    im_width: int
    im_height: int
    im_ext: str = ".jpg"

    def frame_path(self, frame_id: int) -> str:
        return os.path.join(self.img_dir, f"{frame_id:06d}{self.im_ext}")


def load_seqinfo(seq_dir: str) -> SeqInfo:
    """Parse ``seqinfo.ini`` of a MOTChallenge sequence directory."""
    ini = os.path.join(seq_dir, "seqinfo.ini")
    cp = configparser.ConfigParser()
    cp.read(ini)
    s = cp["Sequence"]
    return SeqInfo(
        name=s.get("name", os.path.basename(seq_dir)),
        img_dir=os.path.join(seq_dir, s.get("imDir", "img1")),
        frame_rate=int(s.get("frameRate", 30)),
        seq_length=int(s.get("seqLength", 0)),
        im_width=int(s.get("imWidth", 1920)),
        im_height=int(s.get("imHeight", 1080)),
        im_ext=s.get("imExt", ".jpg"),
    )


def write_results(
    path: str,
    results: Sequence[Tuple[int, Sequence[np.ndarray], Sequence[int], Sequence[float]]],
):
    """Write tracker output.

    Args:
      results: iterable of (frame_id, tlwhs, track_ids, scores).
    """
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for frame_id, tlwhs, ids, scores in results:
            for tlwh, tid, score in zip(tlwhs, ids, scores):
                x, y, w, h = tlwh
                f.write(
                    f"{frame_id},{tid},{x:.2f},{y:.2f},{w:.2f},{h:.2f},"
                    f"{score:.2f},-1,-1,-1\n"
                )


def read_mot_file(path: str) -> np.ndarray:
    """Read any comma-separated MOT file to a float array [N, >=7]."""
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        return np.zeros((0, 10))
    return np.atleast_2d(np.loadtxt(path, delimiter=","))


def read_results(path: str) -> Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Tracker results -> {frame: (tlwh [N,4], ids [N], scores [N])}."""
    data = read_mot_file(path)
    out: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
    if data.size == 0:
        return out
    for frame in np.unique(data[:, 0]).astype(int):
        rows = data[data[:, 0] == frame]
        out[frame] = (
            rows[:, 2:6].copy(),
            rows[:, 1].astype(int),
            rows[:, 6].copy(),
        )
    return out


def read_gt(
    path: str,
    min_visibility: float = -1.0,
    pedestrian_classes: Sequence[int] = (1,),
    zero_based: bool = False,
) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """MOT ground truth -> {frame: (tlwh [N,4], ids [N])}.

    Keeps only `considered` rows (conf field != 0) whose class is a
    pedestrian class, above the visibility floor — the standard MOT17/MOT20
    evaluation filter.  ``zero_based`` shifts the 1-based MOTChallenge pixel
    coordinates like the GHOST parser (MOT17_parser.py:72-73,105-106); the
    ByteTrack-family paths keep raw coordinates.
    """
    data = read_mot_file(path)
    if zero_based and data.size:
        data = data.copy()
        data[:, 2:4] -= 1.0
    out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    if data.size == 0:
        return out
    keep = data[:, 6] != 0
    if data.shape[1] > 7:
        keep &= np.isin(data[:, 7].astype(int), pedestrian_classes)
    if data.shape[1] > 8 and min_visibility >= 0:
        keep &= data[:, 8] >= min_visibility
    data = data[keep]
    for frame in np.unique(data[:, 0]).astype(int):
        rows = data[data[:, 0] == frame]
        out[frame] = (rows[:, 2:6].copy(), rows[:, 1].astype(int))
    return out


def read_detections(
    path: str, zero_based: bool = False
) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Detection file -> {frame: (tlbr [N,4], scores [N])}.

    ``zero_based``: the GHOST parser's 1-based -> 0-based shift
    (MOT17_parser.py:105-106).
    """
    data = read_mot_file(path)
    if zero_based and data.size:
        data = data.copy()
        data[:, 2:4] -= 1.0
    out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    if data.size == 0:
        return out
    for frame in np.unique(data[:, 0]).astype(int):
        rows = data[data[:, 0] == frame]
        tlwh = rows[:, 2:6]
        tlbr = tlwh.copy()
        tlbr[:, 2:] += tlbr[:, :2]
        out[frame] = (tlbr, rows[:, 6].copy())
    return out
