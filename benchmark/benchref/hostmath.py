"""Frozen copy of ``busca_tpu_torch/core/hostmath.py`` at commit c2c24f5, part of the
benchmark's plain reference (it imports nothing of the program; edits
to the program do not reach it).

Host-side (numpy) geometry and Kalman math of the per-frame tracker
bookkeeping (port of ``busca_tpu.core.hostmath``).

The matrices are tiny (tens of tracks), so this stays on the host CPU.  The
gating and noise constants come from :mod:`busca_tpu_torch.core.kalman`,
the batched device filter, as busca_tpu's come from its ``core.kalman``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from benchref.kalman import (
    CHI2INV95,
    STD_WEIGHT_POSITION,
    STD_WEIGHT_VELOCITY,
)

__all__ = [
    "iou_matrix",
    "iou_distance",
    "fuse_score",
    "center_distance",
    "tlwh_to_tlbr",
    "tlbr_to_tlwh",
    "tlwh_to_xyah",
    "xyah_to_tlwh",
    "HostKalman",
    "CHI2INV95",
]


def tlwh_to_tlbr(tlwh: np.ndarray) -> np.ndarray:
    out = np.array(tlwh, dtype=np.float64, copy=True)
    out[..., 2:] += out[..., :2]
    return out


def tlbr_to_tlwh(tlbr: np.ndarray) -> np.ndarray:
    out = np.array(tlbr, dtype=np.float64, copy=True)
    out[..., 2:] -= out[..., :2]
    return out


def tlwh_to_xyah(tlwh: np.ndarray) -> np.ndarray:
    out = np.array(tlwh, dtype=np.float64, copy=True)
    out[..., :2] += out[..., 2:] / 2.0
    out[..., 2] /= out[..., 3]
    return out


def xyah_to_tlwh(xyah: np.ndarray) -> np.ndarray:
    out = np.array(xyah, dtype=np.float64, copy=True)
    out[..., 2] *= out[..., 3]
    out[..., :2] -= out[..., 2:] / 2.0
    return out


def iou_matrix(atlbr: np.ndarray, btlbr: np.ndarray) -> np.ndarray:
    """Pairwise IoU with the +1 convention (= cython_bbox.bbox_overlaps)."""
    atlbr = np.asarray(atlbr, dtype=np.float64)
    btlbr = np.asarray(btlbr, dtype=np.float64)
    if atlbr.shape[0] == 0 or btlbr.shape[0] == 0:
        return np.zeros((atlbr.shape[0], btlbr.shape[0]))
    a = atlbr[:, None, :]
    b = btlbr[None, :, :]
    iw = np.maximum(
        np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0]) + 1,
        0.0,
    )
    ih = np.maximum(
        np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1]) + 1,
        0.0,
    )
    inter = iw * ih
    area_a = (a[..., 2] - a[..., 0] + 1) * (a[..., 3] - a[..., 1] + 1)
    area_b = (b[..., 2] - b[..., 0] + 1) * (b[..., 3] - b[..., 1] + 1)
    union = area_a + area_b - inter
    return np.where(union > 0, inter / union, 0.0)


def iou_matrix_std(atlbr: np.ndarray, btlbr: np.ndarray) -> np.ndarray:
    """Pairwise IoU, standard convention (no +1) — torchvision/SORT style."""
    atlbr = np.asarray(atlbr, dtype=np.float64)
    btlbr = np.asarray(btlbr, dtype=np.float64)
    if atlbr.shape[0] == 0 or btlbr.shape[0] == 0:
        return np.zeros((atlbr.shape[0], btlbr.shape[0]))
    a = atlbr[:, None, :]
    b = btlbr[None, :, :]
    iw = np.maximum(
        np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0]),
        0.0,
    )
    ih = np.maximum(
        np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1]),
        0.0,
    )
    inter = iw * ih
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a + area_b - inter
    return np.where(union > 0, inter / union, 0.0)


def iou_distance(atlbr, btlbr) -> np.ndarray:
    return 1.0 - iou_matrix(atlbr, btlbr)


def fuse_score(cost_matrix: np.ndarray, det_scores: np.ndarray) -> np.ndarray:
    if cost_matrix.size == 0:
        return cost_matrix
    return 1.0 - (1.0 - cost_matrix) * np.asarray(det_scores)[None, :]


def center_distance(
    atlbr: np.ndarray, btlbr: np.ndarray, weight_size: bool = False
) -> np.ndarray:
    atlbr = np.asarray(atlbr, dtype=np.float64)
    btlbr = np.asarray(btlbr, dtype=np.float64)
    if atlbr.shape[0] == 0 or btlbr.shape[0] == 0:
        return np.zeros((atlbr.shape[0], btlbr.shape[0]))
    ac = (atlbr[:, :2] + atlbr[:, 2:]) / 2.0
    bc = (btlbr[:, :2] + btlbr[:, 2:]) / 2.0
    diff = ac[:, None, :] - bc[None, :, :]
    dist = np.sqrt((diff * diff).sum(-1))
    if weight_size:
        a_sz = np.sqrt((atlbr[:, 2] - atlbr[:, 0]) * (atlbr[:, 3] - atlbr[:, 1]))
        b_sz = np.sqrt((btlbr[:, 2] - btlbr[:, 0]) * (btlbr[:, 3] - btlbr[:, 1]))
        ratio = a_sz[:, None] / b_sz[None, :]
        dist = dist * np.maximum(ratio, 1.0 / ratio)
    return dist


class HostKalman:
    """Batched numpy constant-velocity Kalman filter (host mirror).

    All methods operate on stacked states ``mean [N, 8]`` / ``cov [N, 8,
    8]``.
    """

    def __init__(self):
        self.F = np.eye(8)
        self.F[np.arange(4), np.arange(4) + 4] = 1.0
        self.H = np.eye(4, 8)

    @staticmethod
    def _diag_embed(std: np.ndarray) -> np.ndarray:
        k = std.shape[-1]
        return (std**2)[..., :, None] * np.eye(k)

    def initiate(self, measurement: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        m = np.atleast_2d(np.asarray(measurement, dtype=np.float64))
        mean = np.concatenate([m, np.zeros_like(m)], axis=-1)
        h = m[:, 3]
        std = np.stack(
            [
                2 * STD_WEIGHT_POSITION * h,
                2 * STD_WEIGHT_POSITION * h,
                np.full_like(h, 1e-2),
                2 * STD_WEIGHT_POSITION * h,
                10 * STD_WEIGHT_VELOCITY * h,
                10 * STD_WEIGHT_VELOCITY * h,
                np.full_like(h, 1e-5),
                10 * STD_WEIGHT_VELOCITY * h,
            ],
            axis=-1,
        )
        return mean, self._diag_embed(std)

    def _motion_cov(self, h: np.ndarray) -> np.ndarray:
        std = np.stack(
            [
                STD_WEIGHT_POSITION * h,
                STD_WEIGHT_POSITION * h,
                np.full_like(h, 1e-2),
                STD_WEIGHT_POSITION * h,
                STD_WEIGHT_VELOCITY * h,
                STD_WEIGHT_VELOCITY * h,
                np.full_like(h, 1e-5),
                STD_WEIGHT_VELOCITY * h,
            ],
            axis=-1,
        )
        return self._diag_embed(std)

    def predict(self, mean, cov):
        mean = np.asarray(mean, dtype=np.float64)
        cov = np.asarray(cov, dtype=np.float64)
        new_mean = mean @ self.F.T
        new_cov = self.F @ cov @ self.F.T + self._motion_cov(mean[:, 3])
        return new_mean, new_cov

    def project(self, mean, cov, confidence=None):
        """Project to measurement space.

        ``confidence`` enables StrongSORT's NSA noise adaptation: the
        measurement noise std scales by ``(1 - confidence)`` (NSA Kalman,
        used via the conf-passing update at deep_sort/track.py:242).
        """
        h = mean[:, 3]
        std = np.stack(
            [
                STD_WEIGHT_POSITION * h,
                STD_WEIGHT_POSITION * h,
                np.full_like(h, 1e-1),
                STD_WEIGHT_POSITION * h,
            ],
            axis=-1,
        )
        if confidence is not None:
            std = std * (1.0 - np.asarray(confidence, dtype=np.float64))[:, None]
        pm = mean @ self.H.T
        pc = self.H @ cov @ self.H.T + self._diag_embed(std)
        return pm, pc

    def update(self, mean, cov, measurement, confidence=None):
        mean = np.asarray(mean, dtype=np.float64)
        cov = np.asarray(cov, dtype=np.float64)
        z = np.atleast_2d(np.asarray(measurement, dtype=np.float64))
        pm, pc = self.project(mean, cov, confidence)
        pht = cov @ self.H.T  # [N, 8, 4]
        # gain K: solve S K^T = (P H^T)^T  (batched)
        kt = np.linalg.solve(pc, np.swapaxes(pht, 1, 2))  # [N, 4, 8]
        gain = np.swapaxes(kt, 1, 2)
        innov = z - pm
        new_mean = mean + np.einsum("nij,nj->ni", gain, innov)
        new_cov = cov - np.einsum("nij,njk,nlk->nil", gain, pc, gain)
        return new_mean, new_cov

    def gating_distance(
        self, mean, cov, measurements, only_position=False, metric="maha"
    ):
        pm, pc = self.project(
            np.asarray(mean, dtype=np.float64), np.asarray(cov, dtype=np.float64)
        )
        z = np.asarray(measurements, dtype=np.float64)
        if only_position:
            pm, pc, z = pm[:, :2], pc[:, :2, :2], z[:, :2]
        d = z[None, :, :] - pm[:, None, :]  # [N, M, k]
        if metric == "gaussian":
            return (d * d).sum(-1)
        if metric == "maha":
            chol = np.linalg.cholesky(pc)  # [N, k, k]
            y = np.linalg.solve(chol[:, None], d[..., None])[..., 0]
            return (y * y).sum(-1)
        raise ValueError(f"invalid metric: {metric}")
