"""Offline trajectory post-processing: AFLink, interpolation and GSI (port of
``busca_tpu.trackers.postprocess``).

The reference's StrongSORT path optionally applies AFLink and GSI after
tracking (adapters/StrongSORT/strong_sort.py:29-46), link first, then
smooth.

- ``linear_interpolation``: fill gaps of up to ``interval`` frames in each
  trajectory linearly;
- ``gaussian_smoothed_interpolation`` (GSI): linear interpolation, then each
  coordinate smoothed by closed-form Gaussian-process regression (RBF
  kernel, length scale ``tau``), numpy on the host;
- ``aflink``: appearance-free tracklet linking, scored by
  :class:`~busca_tpu_torch.models.aflink.AFLinkModel` on its device.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def _split_tracks(results: np.ndarray) -> Dict[int, np.ndarray]:
    """rows [frame, id, x, y, w, h, score, ...] -> {id: rows sorted by
    frame}"""
    out = {}
    for tid in np.unique(results[:, 1]).astype(int):
        rows = results[results[:, 1] == tid]
        out[tid] = rows[np.argsort(rows[:, 0])]
    return out


def linear_interpolation(results: np.ndarray, interval: int = 20
                         ) -> np.ndarray:
    """Fill per-track frame gaps up to ``interval`` with linear interpolation.

    Args:
      results: ``[N, >=7]`` MOT rows (frame, id, x, y, w, h, score, ...).
    """
    if len(results) == 0:
        return results
    results = np.asarray(results, dtype=np.float64)
    out = [results]
    for tid, rows in _split_tracks(results).items():
        frames = rows[:, 0].astype(int)
        for i in range(1, len(frames)):
            gap = frames[i] - frames[i - 1]
            if 1 < gap <= interval:
                for k in range(1, gap):
                    a = k / gap
                    row = rows[i - 1] * (1 - a) + rows[i] * a
                    row[0] = frames[i - 1] + k
                    row[1] = tid
                    out.append(row[None])
    merged = np.concatenate(out, axis=0)
    order = np.lexsort((merged[:, 1], merged[:, 0]))
    return merged[order]


def _gpr_smooth(t: np.ndarray, y: np.ndarray, tau: float) -> np.ndarray:
    """Closed-form RBF Gaussian-process regression, evaluated at the inputs:
    k(a, b) = exp(-(a-b)^2 / (2 tau^2)), observation noise 1e-2."""
    t = t.astype(np.float64)[:, None]
    d2 = (t - t.T) ** 2
    k = np.exp(-d2 / (2.0 * tau * tau))
    alpha = np.linalg.solve(k + 1e-2 * np.eye(len(t)), y)
    return k @ alpha


def gaussian_smoothed_interpolation(
    results: np.ndarray, interval: int = 20, tau: float = 10.0
) -> np.ndarray:
    """GSI: linear interpolation + per-coordinate GP smoothing per track."""
    results = linear_interpolation(results, interval)
    if len(results) == 0:
        return results
    out = []
    for tid, rows in _split_tracks(results).items():
        rows = rows.copy()
        if len(rows) >= 2:
            t = rows[:, 0]
            # adaptive length scale: tau scaled by the track's span
            tau_eff = min(tau, max(1.0, len(rows) / 10.0 * tau))
            for col in range(2, 6):
                rows[:, col] = _gpr_smooth(t, rows[:, col], tau_eff)
        out.append(rows)
    merged = np.concatenate(out, axis=0)
    order = np.lexsort((merged[:, 1], merged[:, 0]))
    return merged[order]


def link_candidates(
    tracks: Dict[int, np.ndarray],
    thrT: Tuple[int, int] = (0, 30),
    thrS: float = 75.0,
) -> List[Tuple[int, int]]:
    """AFLink's candidate pairs (tracklet ``i`` ends, tracklet ``j``
    starts): a temporal gap in ``[thrT[0], thrT[1])`` and end/start centers
    closer than ``thrS`` px, in id order."""
    ids = sorted(tracks)
    cands = []
    for i in ids:
        ri = tracks[i]
        for j in ids:
            if i == j:
                continue
            rj = tracks[j]
            gap = rj[0, 0] - ri[-1, 0]
            if not (thrT[0] <= gap < thrT[1]):
                continue
            ci = ri[-1, 2:4] + ri[-1, 4:6] / 2.0
            cj = rj[0, 2:4] + rj[0, 4:6] / 2.0
            if np.hypot(*(ci - cj)) >= thrS:
                continue
            cands.append((i, j))
    return cands


def candidate_probs(tracks: Dict[int, np.ndarray],
                    cands: List[Tuple[int, int]], model) -> np.ndarray:
    """The link model's P(same) for each candidate pair."""
    from busca_tpu_torch.models.aflink import (
        AFLinkConfig,
        make_score_fn,
        normalize_segment,
    )

    config = AFLinkConfig()
    seg1 = np.stack([
        normalize_segment(tracks[i], tracks[i][-1, 0] + 1, config, True)
        for i, _ in cands
    ])
    seg2 = np.stack([
        normalize_segment(tracks[j], tracks[i][-1, 0] + 1, config, False)
        for i, j in cands
    ])
    return np.asarray(make_score_fn(model)(seg1, seg2))


def greedy_links(cands: List[Tuple[int, int]], probs: np.ndarray,
                 thrP: float = 0.05) -> List[Tuple[int, int]]:
    """AFLink's links: candidate pairs taken greedily by descending
    probability above ``thrP``, each tracklet linking forward and backward
    at most once."""
    order = np.argsort(-probs)
    used_src, used_dst = set(), set()
    links = []
    for k in order:
        if probs[k] < thrP:
            break
        i, j = cands[k]
        if i in used_src or j in used_dst:
            continue
        used_src.add(i)
        used_dst.add(j)
        links.append((i, j))
    return links


def merge_links(results: np.ndarray, links: List[Tuple[int, int]]
                ) -> np.ndarray:
    """Rows with linked ids merged by union-find (each chain takes its
    first tracklet's id), ordered by (frame, id)."""
    parent = {int(i): int(i) for i in np.unique(results[:, 1])}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i, j in links:
        parent[find(j)] = find(i)
    out = results.copy()
    for i in sorted(parent):
        root = find(i)
        if root != i:
            out[results[:, 1] == i, 1] = root
    order = np.lexsort((out[:, 1], out[:, 0]))
    return out[order]


def aflink(
    results: np.ndarray,
    model=None,
    thrT: Tuple[int, int] = (0, 30),
    thrS: float = 75.0,
    thrP: float = 0.05,
) -> np.ndarray:
    """Appearance-free tracklet linking (AFLink) over MOT result rows.

    The reference applies this between tracking and GSI
    (adapters/StrongSORT/strong_sort.py:29-38) with these defaults: the
    candidate pairs of :func:`link_candidates` are scored by ``model`` (an
    :class:`~busca_tpu_torch.models.aflink.AFLinkModel`), linked by
    :func:`greedy_links` and merged by :func:`merge_links`.
    """
    if model is None:
        raise ValueError(
            "aflink needs a trained link model: load AFLink weights into "
            "busca_tpu_torch.models.aflink.AFLinkModel")
    tracks = _split_tracks(results)
    cands = link_candidates(tracks, thrT, thrS)
    if not cands:
        return results
    probs = candidate_probs(tracks, cands, model)
    return merge_links(results, greedy_links(cands, probs, thrP))
