"""CLEAR-MOT + identity metrics and HOTA (port of
``busca_tpu.eval.metrics``).

``motmetrics``/TrackEval are not vendored dependencies of this framework, so
the golden-number evaluation path (MOTA/IDF1/IDs — the reference's published
table, README.md:126-131) is implemented here:

- **CLEAR** (Bernardin & Stiefelhagen 2008, as implemented by py-motmetrics):
  per-frame correspondence with carry-over preference — matches from the
  previous frame are kept while still valid (IoU >= 0.5), remaining pairs are
  matched by Hungarian on IoU distance; counts FP/FN/IDSW; MOTA = 1 -
  (FP + FN + IDSW) / num_gt.
- **Identity** (Ristani et al. 2016): a single global bipartite matching
  between gt and predicted trajectories minimizing ID-FP+ID-FN; IDF1 =
  2 IDTP / (gt boxes + pred boxes).

Assignment runs on the port's LAPJV (busca_tpu_torch.ops.lap).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from busca_tpu_torch.ops import lap


@dataclasses.dataclass
class MotMetrics:
    mota: float
    motp: float
    idf1: float
    idp: float
    idr: float
    num_switches: int
    num_false_positives: int
    num_misses: int
    num_matches: int
    num_gt: int
    mostly_tracked: int
    mostly_lost: int
    # total predicted boxes (IDTP + IDFP); carried explicitly so aggregation
    # never has to reconstruct it as idtp/idp (which collapses when idp == 0
    # and would silently drop that shard's ID false positives)
    num_pred: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _iou_tlwh(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of tlwh boxes WITHOUT the +1 convention (motmetrics
    semantics, which the MOTChallenge evaluation uses)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    a2 = a.copy()
    a2[:, 2:] += a2[:, :2]
    b2 = b.copy()
    b2[:, 2:] += b2[:, :2]
    iw = np.maximum(
        np.minimum(a2[:, None, 2], b2[None, :, 2])
        - np.maximum(a2[:, None, 0], b2[None, :, 0]),
        0,
    )
    ih = np.maximum(
        np.minimum(a2[:, None, 3], b2[None, :, 3])
        - np.maximum(a2[:, None, 1], b2[None, :, 1]),
        0,
    )
    inter = iw * ih
    union = (a[:, 2] * a[:, 3])[:, None] + (b[:, 2] * b[:, 3])[None, :] - inter
    return np.where(union > 0, inter / union, 0)


def _check_unique_ids(per_frame, what: str):
    """An id appearing twice in one frame is ill-formed MOT data (TrackEval
    raises 'predicts the same ID more than once in a single timestep');
    silently accepting it would corrupt the correspondence bookkeeping, so
    fail loudly."""
    for f, entry in per_frame.items():
        ids = entry[1]
        if len(ids) != len(set(int(i) for i in ids)):
            raise ValueError(
                f"{what} frame {f} repeats a track id: {list(ids)}"
            )


def evaluate_clear(
    gt: Dict[int, Tuple[np.ndarray, np.ndarray]],
    pred: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]],
    iou_threshold: float = 0.5,
) -> MotMetrics:
    """Compute CLEAR + identity metrics for one sequence.

    Args:
      gt: {frame: (tlwh, ids)} ground truth.
      pred: {frame: (tlwh, ids, scores)} tracker output.
    """
    _check_unique_ids(gt, "gt")
    _check_unique_ids(pred, "pred")
    frames = sorted(set(gt.keys()) | set(pred.keys()))
    correspondences: Dict[int, int] = {}  # gt id -> pred id from prev frame
    last_match: Dict[int, int] = {}  # gt id -> last matched pred id (for IDSW)

    fp = fn = idsw = matches = 0
    num_gt = 0
    dist_sum = 0.0

    # per-trajectory bookkeeping for MT/ML and IDF1
    gt_frames: Dict[int, int] = {}
    gt_tracked_frames: Dict[int, int] = {}
    # (gt_id, pred_id) -> overlap count for ID metrics
    pair_overlap: Dict[Tuple[int, int], int] = {}
    pred_frames: Dict[int, int] = {}

    for f in frames:
        g_boxes, g_ids = gt.get(f, (np.zeros((0, 4)), np.zeros(0, int)))
        p_boxes, p_ids, _ = pred.get(
            f, (np.zeros((0, 4)), np.zeros(0, int), np.zeros(0))
        )
        num_gt += len(g_ids)
        for gid in g_ids:
            gt_frames[gid] = gt_frames.get(gid, 0) + 1
        for pid in p_ids:
            pred_frames[pid] = pred_frames.get(pid, 0) + 1

        iou = _iou_tlwh(g_boxes, p_boxes)
        # identity-metric overlaps use the same threshold
        for gi, gid in enumerate(g_ids):
            for pi, pid in enumerate(p_ids):
                if iou[gi, pi] >= iou_threshold:
                    pair_overlap[(gid, pid)] = pair_overlap.get((gid, pid), 0) + 1

        matched_g = set()
        matched_p = set()
        frame_corr: Dict[int, int] = {}

        # 1) carry over still-valid correspondences
        pid_to_idx = {pid: i for i, pid in enumerate(p_ids)}
        gid_to_idx = {gid: i for i, gid in enumerate(g_ids)}
        for gid, pid in correspondences.items():
            gi = gid_to_idx.get(gid)
            pi = pid_to_idx.get(pid)
            if gi is None or pi is None:
                continue
            if iou[gi, pi] >= iou_threshold:
                frame_corr[gid] = pid
                matched_g.add(gi)
                matched_p.add(pi)
                matches += 1
                dist_sum += 1 - iou[gi, pi]

        # 2) Hungarian on the rest.  motmetrics semantics: invalid pairs are
        # forbidden edges and the solver maximizes the NUMBER of valid
        # matches first, min total distance second (motmetrics
        # lap.add_expensive_edges) — exactly what ops.lap.solve_dense
        # implements (a cost-limit LAP would trade match count against
        # distance).
        free_g = [i for i in range(len(g_ids)) if i not in matched_g]
        free_p = [i for i in range(len(p_ids)) if i not in matched_p]
        if free_g and free_p:
            cost = 1 - iou[np.ix_(free_g, free_p)]
            cost[cost > 1 - iou_threshold] = np.inf
            rows, cols = lap.solve_dense(cost)
            for i, j in zip(rows, cols):
                gi, pi = free_g[i], free_p[j]
                gid, pid = g_ids[gi], p_ids[pi]
                frame_corr[gid] = pid
                matched_g.add(gi)
                matched_p.add(pi)
                matches += 1
                dist_sum += 1 - iou[gi, pi]
                if gid in last_match and last_match[gid] != pid:
                    idsw += 1

        fn += len(g_ids) - len(matched_g)
        fp += len(p_ids) - len(matched_p)
        for gid, pid in frame_corr.items():
            last_match[gid] = pid
            gt_tracked_frames[gid] = gt_tracked_frames.get(gid, 0) + 1
        correspondences = frame_corr

    # ---- identity metrics (global trajectory matching) ----------------------
    g_traj = sorted(gt_frames)
    p_traj = sorted(pred_frames)
    total_g = sum(gt_frames.values())
    total_p = sum(pred_frames.values())
    idtp = 0
    if g_traj and p_traj:
        ng, np_ = len(g_traj), len(p_traj)
        # cost = ID-FN + ID-FP for each pairing (Ristani et al.)
        size = ng + np_
        cost = np.zeros((size, size))
        for i, gid in enumerate(g_traj):
            for j, pid in enumerate(p_traj):
                ov = pair_overlap.get((gid, pid), 0)
                cost[i, j] = (gt_frames[gid] - ov) + (pred_frames[pid] - ov)
        for i, gid in enumerate(g_traj):
            cost[i, np_:] = lap.BIG
            cost[i, np_ + i] = gt_frames[gid]  # unmatched gt trajectory
        for j, pid in enumerate(p_traj):
            cost[ng:, j] = lap.BIG
            cost[ng + j, j] = pred_frames[pid]  # unmatched pred trajectory
        cost[ng:, np_:] = 0
        x, _, _ = lap._solve_square(cost)
        for i, gid in enumerate(g_traj):
            j = x[i]
            if j < np_:
                idtp += pair_overlap.get((gid, p_traj[j]), 0)
    idp = idtp / total_p if total_p else 0.0
    idr = idtp / total_g if total_g else 0.0
    idf1 = (
        2 * idtp / (total_g + total_p) if (total_g + total_p) else 0.0
    )

    mt = ml = 0
    for gid, n in gt_frames.items():
        ratio = gt_tracked_frames.get(gid, 0) / n
        if ratio >= 0.8:
            mt += 1
        elif ratio <= 0.2:
            ml += 1

    mota = 1.0 - (fp + fn + idsw) / num_gt if num_gt else 0.0
    motp = dist_sum / matches if matches else 0.0
    return MotMetrics(
        mota=mota,
        motp=motp,
        idf1=idf1,
        idp=idp,
        idr=idr,
        num_switches=idsw,
        num_false_positives=fp,
        num_misses=fn,
        num_matches=matches,
        num_gt=num_gt,
        mostly_tracked=mt,
        mostly_lost=ml,
        num_pred=int(total_p),
    )


def evaluate_hota(
    gt: Dict[int, Tuple[np.ndarray, np.ndarray]],
    pred: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]],
    alphas: np.ndarray = None,
) -> Dict[str, float]:
    """HOTA (Luiten et al., IJCV 2021) — the TrackEval algorithm.

    Two passes: (1) accumulate per-identity-pair soft potential matches to a
    global alignment score; (2) per alpha, per-frame Hungarian on
    ``alignment * similarity`` with matches valid iff IoU >= alpha; then
    DetA = TP/(TP+FN+FP), AssA = mean association Jaccard over TPs,
    HOTA_alpha = sqrt(DetA * AssA), HOTA = mean over alphas.

    Returns the alpha-averaged TrackEval summary row: {'hota', 'deta',
    'assa', 'detre', 'detpr', 'assre', 'asspr', 'loca'} (LocA = mean TP
    similarity; Re/Pr per TrackEval hota.py's AssRe/AssPr/DetRe/DetPr).
    """
    if alphas is None:
        alphas = np.arange(0.05, 0.99, 0.05)
    _check_unique_ids(gt, "gt")
    _check_unique_ids(pred, "pred")
    frames = sorted(set(gt.keys()) | set(pred.keys()))

    gt_ids_all = sorted({int(i) for f in gt.values() for i in f[1]})
    pr_ids_all = sorted(
        {int(i) for f in pred.values() for i in f[1]}
    )
    g_index = {g: i for i, g in enumerate(gt_ids_all)}
    p_index = {p: i for i, p in enumerate(pr_ids_all)}
    ng, np_ = len(gt_ids_all), len(pr_ids_all)
    if ng == 0 or np_ == 0:
        deta = 0.0 if (ng or np_) else 1.0
        return {k: deta for k in
                ("hota", "deta", "assa", "detre", "detpr", "assre", "asspr",
                 "loca")}

    potential = np.zeros((ng, np_))
    gt_count = np.zeros(ng)
    pr_count = np.zeros(np_)
    per_frame = []  # cached (gi, pi, sim) per frame
    for f in frames:
        g_boxes, g_ids = gt.get(f, (np.zeros((0, 4)), np.zeros(0, int)))
        p_boxes, p_ids, _ = pred.get(
            f, (np.zeros((0, 4)), np.zeros(0, int), np.zeros(0))
        )
        gi = np.array([g_index[int(i)] for i in g_ids], int)
        pi = np.array([p_index[int(i)] for i in p_ids], int)
        sim = _iou_tlwh(g_boxes, p_boxes)
        per_frame.append((gi, pi, sim))
        gt_count[gi] += 1
        pr_count[pi] += 1
        if len(gi) and len(pi):
            denom = sim.sum(0)[None, :] + sim.sum(1)[:, None] - sim
            soft = np.where(denom > 1e-8, sim / np.maximum(denom, 1e-8), 0.0)
            np.add.at(potential, (gi[:, None], pi[None, :]), soft)

    alignment = potential / np.maximum(
        gt_count[:, None] + pr_count[None, :] - potential, 1e-8
    )

    acc = {k: [] for k in ("hota", "deta", "assa", "detre", "detpr",
                           "assre", "asspr", "loca")}
    for alpha in alphas:
        tp = fn = fp = 0
        tp_sim = 0.0
        match_count = np.zeros((ng, np_))
        for gi, pi, sim in per_frame:
            if len(gi) == 0 or len(pi) == 0:
                fn += len(gi)
                fp += len(pi)
                continue
            score = alignment[np.ix_(gi, pi)] * sim
            # maximize score -> minimize negative
            m, _, _ = lap.linear_assignment(-score, thresh=1e9)
            matched = 0
            for r, c in m:
                if sim[r, c] >= alpha - 1e-8:
                    match_count[gi[r], pi[c]] += 1
                    matched += 1
                    tp_sim += float(sim[r, c])
            tp += matched
            fn += len(gi) - matched
            fp += len(pi) - matched
        deta = tp / max(tp + fn + fp, 1)
        ass_jaccard = match_count / np.maximum(
            gt_count[:, None] + pr_count[None, :] - match_count, 1e-8
        )
        assa = float((match_count * ass_jaccard).sum() / max(tp, 1))
        acc["deta"].append(deta)
        acc["assa"].append(assa)
        acc["hota"].append(np.sqrt(deta * assa))
        acc["detre"].append(tp / max(tp + fn, 1))
        acc["detpr"].append(tp / max(tp + fp, 1))
        acc["assre"].append(float(
            (match_count * match_count / np.maximum(gt_count[:, None], 1))
            .sum() / max(tp, 1)))
        acc["asspr"].append(float(
            (match_count * match_count / np.maximum(pr_count[None, :], 1))
            .sum() / max(tp, 1)))
        # TrackEval: LocA = max(eps, sum_sim) / max(eps, TP) -> 1.0 when TP=0
        acc["loca"].append(max(tp_sim, 1e-10) / max(tp, 1e-10))
    return {k: float(np.mean(v)) for k, v in acc.items()}


def accumulate(per_seq: Dict[str, MotMetrics]) -> MotMetrics:
    """Aggregate sequence metrics the way MOTChallenge does (count-weighted)."""
    tot = lambda f: sum(getattr(m, f) for m in per_seq.values())
    num_gt = tot("num_gt")
    fp, fn, idsw = (
        tot("num_false_positives"),
        tot("num_misses"),
        tot("num_switches"),
    )
    matches = tot("num_matches")
    motp = (
        sum(m.motp * m.num_matches for m in per_seq.values()) / matches
        if matches
        else 0.0
    )
    # exact aggregate: idtp_i = idr_i * num_gt_i ; total pred boxes carried
    # explicitly (num_pred), reconstructed from idp only for legacy values
    idtp = sum(m.idr * m.num_gt for m in per_seq.values())
    total_p = sum(
        m.num_pred if m.num_pred
        else ((m.idr * m.num_gt / m.idp) if m.idp > 0 else 0.0)
        for m in per_seq.values()
    )
    idf1 = 2 * idtp / (num_gt + total_p) if (num_gt + total_p) else 0.0
    return MotMetrics(
        mota=1.0 - (fp + fn + idsw) / num_gt if num_gt else 0.0,
        motp=motp,
        idf1=idf1,
        idp=idtp / total_p if total_p else 0.0,
        idr=idtp / num_gt if num_gt else 0.0,
        num_switches=idsw,
        num_false_positives=fp,
        num_misses=fn,
        num_matches=matches,
        num_gt=num_gt,
        mostly_tracked=tot("mostly_tracked"),
        mostly_lost=tot("mostly_lost"),
        num_pred=int(total_p),
    )
