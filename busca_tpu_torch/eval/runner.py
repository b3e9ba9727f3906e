"""Sequence runner and evaluation harness (port of ``busca_tpu.eval.runner``
in one process): drive one tracker over a sequence, filter its output like
the reference MOT evaluator, evaluate it, the cached-detection MOTChallenge
mode (``det/det.txt``) alone or over several sequences in lockstep, the
base-vs-BUSCA A/B, and metric aggregation over sequences.

Not here: the multi-process sharding and tally allgather (ROADMAP.md item
23) and the visualization (item 25).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from busca_tpu_torch.eval import metrics as metrics_lib
from busca_tpu_torch.eval import mot


@dataclasses.dataclass
class SequenceResult:
    name: str
    num_frames: int
    results: List[Tuple[int, list, list, list]]
    track_time_s: float
    # optional per-stage wall times (the reference's inference/track split,
    # mot_evaluator.py:671-682), e.g. {"detector_s": ..., "tracker_s": ...}
    stage_times: Optional[Dict[str, float]] = None

    @property
    def fps(self) -> float:
        return self.num_frames / self.track_time_s if self.track_time_s else 0.0


def filter_output_tracks(online, min_box_area=100.0, vertical_thresh=1.6):
    """The reference MOT evaluator's output filter (mot_evaluator.py:216-221):
    drop tiny boxes and "vertical" boxes (w/h > thresh; None skips it).
    Returns (tlwhs, ids, confs)."""
    tlwhs, ids, confs = [], [], []
    for t in online:
        tlwh = t.tlwh
        vertical = (
            vertical_thresh is not None
            and tlwh[3] > 0
            and tlwh[2] / tlwh[3] > vertical_thresh
        )
        if tlwh[2] * tlwh[3] > min_box_area and not vertical:
            tlwhs.append(tlwh)
            ids.append(t.track_id)
            confs.append(t.score)
    return tlwhs, ids, confs


def run_sequence(
    tracker,
    frames: Iterable[Optional[np.ndarray]],
    detections: Sequence[Tuple[np.ndarray, np.ndarray]],
    name: str = "seq",
    scale: float = 1.0,
    min_box_area: float = 100.0,
    vertical_thresh: Optional[float] = 1.6,
) -> SequenceResult:
    """Drive one tracker instance over a sequence.

    Args:
      tracker: object with ``update(bboxes_tlbr, scores, scale, frame)``.
      frames: per-frame images (uint8 BGR) or None (cached detections).
      detections: per-frame (tlbr [N, 4], scores [N]).
    """
    results = []
    t0 = time.perf_counter()
    for idx, (frame, (boxes, scores)) in enumerate(zip(frames, detections)):
        online = tracker.update(boxes, scores, scale, frame)
        tlwhs, ids, confs = filter_output_tracks(
            online, min_box_area, vertical_thresh
        )
        results.append((idx + 1, tlwhs, ids, confs))
    dt = time.perf_counter() - t0
    return SequenceResult(name, len(results), results, dt)


def run_mot_sequences_lockstep(
    seq_dirs,
    trackers,
    det_paths=None,
    min_box_area: float = 100.0,
    vertical_thresh: Optional[float] = 1.6,
    max_frames: Optional[int] = None,
) -> List[SequenceResult]:
    """Several cached-detection MOTChallenge sequences frame by frame in
    step, every sequence's BUSCA third round served by one grouped
    association per frame (trackers with ``update_deferred``; per-request BN
    groups keep each sequence's numbers equal to its own run).  The
    cached-detection path is busca_tpu's canonical slice (BASELINE.json
    config 1); this is its multi-sequence throughput mode.  Frames are
    decoded with cv2, and only for the trackers that read pixels."""
    import cv2

    from busca_tpu_torch.trackers.base import service_deferred_updates

    infos = [mot.load_seqinfo(d) for d in seq_dirs]
    det_paths = det_paths or [None] * len(seq_dirs)
    dets_all = [mot.read_detections(p or os.path.join(d, "det", "det.txt"))
                for d, p in zip(seq_dirs, det_paths)]
    lengths = [min(i.seq_length, max_frames) if max_frames else i.seq_length
               for i in infos]
    results = [[] for _ in seq_dirs]
    # pixels feed only BUSCA crops and features: a pixel-free tracker's
    # sequence skips the decode
    needs_pixels = [
        getattr(t, "use_busca", False)
        or getattr(getattr(t, "trk", None), "use_busca", False)
        or getattr(t, "feat_fn", None) is not None
        for t in trackers
    ]
    t0 = time.perf_counter()
    step = 0
    while True:
        live = [i for i in range(len(seq_dirs)) if step < lengths[i]]
        if not live:
            break
        frame_id = step + 1
        frames_now = {i: cv2.imread(infos[i].frame_path(frame_id))
                      if needs_pixels[i] else None for i in live}
        # every ECC solve starts on the CMC pool before any update runs,
        # each with its tracker's own recipe
        for i in live:
            if hasattr(trackers[i], "cmc_prefetch"):
                trackers[i].cmc_prefetch(frames_now[i])
        onlines, pending = {}, []
        for i in live:
            boxes, scores = dets_all[i].get(
                frame_id, (np.zeros((0, 4)), np.zeros(0)))
            trk = trackers[i]
            if hasattr(trk, "update_deferred"):
                gen = trk.update_deferred(boxes, scores, 1.0, frames_now[i])
                try:
                    pending.append((i, gen, next(gen)))
                except StopIteration as e:
                    onlines[i] = e.value
            else:
                onlines[i] = trk.update(boxes, scores, 1.0, frames_now[i])
        if pending:
            onlines.update(service_deferred_updates(pending))
        for i in live:
            tlwhs, ids, confs = filter_output_tracks(
                onlines[i], min_box_area, vertical_thresh)
            results[i].append((frame_id, tlwhs, ids, confs))
        step += 1
    dt = time.perf_counter() - t0
    total = max(sum(len(r) for r in results), 1)
    return [SequenceResult(infos[i].name, len(results[i]), results[i],
                           dt * len(results[i]) / total)
            for i in range(len(seq_dirs))]


def results_to_pred(
    seq_result: SequenceResult,
) -> Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """SequenceResult -> the {frame: (tlwh, ids, scores)} metric input."""
    out = {}
    for frame_id, tlwhs, ids, confs in seq_result.results:
        if ids:
            out[frame_id] = (
                np.stack(tlwhs),
                np.asarray(ids, int),
                np.asarray(confs),
            )
    return out


def evaluate_sequence(
    seq_result: SequenceResult,
    gt: Dict[int, Tuple[np.ndarray, np.ndarray]],
) -> metrics_lib.MotMetrics:
    return metrics_lib.evaluate_clear(gt, results_to_pred(seq_result))


def run_ab(
    make_base_tracker: Callable[[], object],
    make_busca_tracker: Callable[[], object],
    frames_factory: Callable[[], Iterable],
    detections: Sequence[Tuple[np.ndarray, np.ndarray]],
    gt: Dict[int, Tuple[np.ndarray, np.ndarray]],
    name: str = "seq",
) -> Dict[str, metrics_lib.MotMetrics]:
    """The reference's A/B acceptance pattern: the same sequence through the
    base tracker and the tracker with BUSCA, metrics out."""
    out = {}
    for tag, factory in (("base", make_base_tracker),
                         ("busca", make_busca_tracker)):
        seq = run_sequence(factory(), frames_factory(), detections, name=name)
        out[tag] = evaluate_sequence(seq, gt)
    return out


def run_mot_sequence(
    seq_dir: str,
    tracker,
    det_path: Optional[str] = None,
    output_path: Optional[str] = None,
    max_frames: Optional[int] = None,
) -> SequenceResult:
    """Run a tracker over an on-disk MOTChallenge sequence with its public
    detections (``det/det.txt``, or ``det_path``): the cached-detection
    evaluation mode.  Frames are decoded with cv2."""
    import cv2

    info = mot.load_seqinfo(seq_dir)
    det_path = det_path or os.path.join(seq_dir, "det", "det.txt")
    dets_by_frame = mot.read_detections(det_path)
    n = info.seq_length
    if max_frames:
        n = min(n, max_frames)

    def frames():
        for f in range(1, n + 1):
            yield cv2.imread(info.frame_path(f))

    detections = [
        dets_by_frame.get(f, (np.zeros((0, 4)), np.zeros(0)))
        for f in range(1, n + 1)
    ]
    result = run_sequence(tracker, frames(), detections, name=info.name)
    if output_path:
        mot.write_results(output_path, result.results)
    return result


def _eval_one(args):
    name, gt, pred, iou_threshold = args
    return name, metrics_lib.evaluate_clear(gt, pred, iou_threshold)


def evaluate_sequences_parallel(
    per_seq: Dict[str, Tuple[dict, dict]],
    num_workers: int = 8,
    iou_threshold: float = 0.5,
) -> Dict[str, metrics_lib.MotMetrics]:
    """CLEAR metrics of each sequence, over a process pool when
    ``num_workers`` > 1 (the TrackEval ``USE_PARALLEL`` role,
    adapters/GHOST/src/eval_track_eval.py:97-98).

    Args:
      per_seq: ``{name: (gt, pred)}`` in the ``evaluate_clear`` formats.
    """
    items = [(name, gt, pred, iou_threshold)
             for name, (gt, pred) in per_seq.items()]
    if num_workers <= 1 or len(items) <= 1:
        return dict(_eval_one(i) for i in items)
    import multiprocessing as mp

    with mp.get_context("spawn").Pool(min(num_workers, len(items))) as pool:
        return dict(pool.map(_eval_one, items))


# tally layout: count-like sufficient statistics of MotMetrics, so that
# aggregation is a plain vector sum (equal to metrics.accumulate)
_TALLY_DIM = 10


def metrics_to_tally(m: metrics_lib.MotMetrics) -> np.ndarray:
    """MotMetrics -> additive sufficient-statistics vector ``[10]`` (f64)."""
    idtp = m.idr * m.num_gt
    # num_pred is carried explicitly; the idp reconstruction (fallback for
    # metrics without it) collapses to 0 when idp == 0
    total_p = m.num_pred if m.num_pred else (
        (idtp / m.idp) if m.idp > 0 else 0.0
    )
    return np.asarray(
        [
            m.num_gt,
            m.num_false_positives,
            m.num_misses,
            m.num_switches,
            m.num_matches,
            m.motp * m.num_matches,
            idtp,
            total_p,
            m.mostly_tracked,
            m.mostly_lost,
        ],
        dtype=np.float64,
    )


def tally_to_metrics(t: np.ndarray) -> metrics_lib.MotMetrics:
    """Inverse of :func:`metrics_to_tally` after summation."""
    num_gt, fp, fn, idsw, matches, motp_w, idtp, total_p, mt, ml = t
    return metrics_lib.MotMetrics(
        mota=1.0 - (fp + fn + idsw) / num_gt if num_gt else 0.0,
        motp=motp_w / matches if matches else 0.0,
        idf1=2 * idtp / (num_gt + total_p) if (num_gt + total_p) else 0.0,
        idp=idtp / total_p if total_p else 0.0,
        idr=idtp / num_gt if num_gt else 0.0,
        num_switches=int(idsw),
        num_false_positives=int(fp),
        num_misses=int(fn),
        num_matches=int(matches),
        num_gt=int(num_gt),
        mostly_tracked=int(mt),
        mostly_lost=int(ml),
        num_pred=int(total_p),
    )


def global_metrics(
    per_seq: Dict[str, metrics_lib.MotMetrics],
) -> metrics_lib.MotMetrics:
    """Aggregate metrics over the sequences of this process: the summed
    tallies back to metrics (equal to ``metrics.accumulate``).  The
    multi-process allgather of busca_tpu's version is ROADMAP.md item 23."""
    local = np.zeros(_TALLY_DIM, np.float64)
    for m in per_seq.values():
        local += metrics_to_tally(m)
    return tally_to_metrics(local)
