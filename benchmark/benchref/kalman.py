"""Frozen copy of ``busca_tpu_torch/core/kalman.py`` at commit c2c24f5, part of the
benchmark's plain reference (it imports nothing of the program; edits
to the program do not reach it).

Batched 8-state constant-velocity Kalman filter as torch linear algebra
on any device (port of ``busca_tpu.core.kalman``; the trackers run the
float64 host filter of :mod:`busca_tpu_torch.core.hostmath`, which takes
its constants from here, as busca_tpu's does).

State ``(x, y, a, h, vx, vy, va, vh)``: box center, aspect ratio (w/h),
height and their velocities; every function is batched over a leading
track axis ``N``.  The numbers of the reference
(adapters/TransCenter/tracking/mot_online/kalman_filter.py:22-269):
``initiate`` with zero velocity and a diagonal covariance scaled by h;
``predict`` as F x, F P F^T + Q(h); ``update`` with the gain from a
Cholesky solve of the projected covariance; ``gating_distance`` the
squared Mahalanobis (or Gaussian) distance of measurements.
"""

from __future__ import annotations

import torch

# 0.95 quantile of the chi-square distribution (gating thresholds), N dof.
CHI2INV95 = {
    1: 3.8415,
    2: 5.9915,
    3: 7.8147,
    4: 9.4877,
    5: 11.070,
    6: 12.592,
    7: 14.067,
    8: 15.507,
    9: 16.919,
}
STD_WEIGHT_POSITION = 1.0 / 20
STD_WEIGHT_VELOCITY = 1.0 / 160
_NDIM = 4


def _motion_mat(like: torch.Tensor) -> torch.Tensor:
    f = torch.eye(2 * _NDIM, dtype=like.dtype, device=like.device)
    f[torch.arange(_NDIM), torch.arange(_NDIM) + _NDIM] = 1.0  # dt = 1
    return f


def _update_mat(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(_NDIM, 2 * _NDIM, dtype=like.dtype, device=like.device)


def _diag(std: torch.Tensor) -> torch.Tensor:
    return torch.diag_embed(std * std)


def initiate(measurement: torch.Tensor):
    """Track states from unassociated xyah measurements ``[N, 4]``: mean
    ``[N, 8]`` and covariance ``[N, 8, 8]``."""
    measurement = torch.as_tensor(measurement)
    if not measurement.is_floating_point():
        measurement = measurement.to(torch.float32)
    mean = torch.cat([measurement, torch.zeros_like(measurement)], dim=-1)
    h = measurement[:, 3]
    std = torch.stack([
        2 * STD_WEIGHT_POSITION * h, 2 * STD_WEIGHT_POSITION * h,
        torch.full_like(h, 1e-2), 2 * STD_WEIGHT_POSITION * h,
        10 * STD_WEIGHT_VELOCITY * h, 10 * STD_WEIGHT_VELOCITY * h,
        torch.full_like(h, 1e-5), 10 * STD_WEIGHT_VELOCITY * h,
    ], dim=-1)
    return mean, _diag(std)


def _motion_cov(h: torch.Tensor) -> torch.Tensor:
    """The process noise Q(h) ``[N, 8, 8]``."""
    return _diag(torch.stack([
        STD_WEIGHT_POSITION * h, STD_WEIGHT_POSITION * h,
        torch.full_like(h, 1e-2), STD_WEIGHT_POSITION * h,
        STD_WEIGHT_VELOCITY * h, STD_WEIGHT_VELOCITY * h,
        torch.full_like(h, 1e-5), STD_WEIGHT_VELOCITY * h,
    ], dim=-1))


def predict(mean: torch.Tensor, covariance: torch.Tensor):
    """The prediction step: mean ``[N, 8]``, covariance ``[N, 8, 8]``."""
    f = _motion_mat(mean)
    new_cov = torch.einsum("ij,njk,lk->nil", f, covariance, f) \
        + _motion_cov(mean[:, 3])
    return mean @ f.T, new_cov


def project(mean: torch.Tensor, covariance: torch.Tensor):
    """The state distribution in measurement space: ``[N, 4]`` and
    ``[N, 4, 4]``."""
    h = mean[:, 3]
    innovation = _diag(torch.stack([
        STD_WEIGHT_POSITION * h, STD_WEIGHT_POSITION * h,
        torch.full_like(h, 1e-1), STD_WEIGHT_POSITION * h,
    ], dim=-1))
    u = _update_mat(mean)
    return mean @ u.T, torch.einsum("ij,njk,lk->nil", u, covariance,
                                    u) + innovation


def update(mean: torch.Tensor, covariance: torch.Tensor,
           measurement: torch.Tensor):
    """The correction step with xyah measurements ``[N, 4]``; the gain
    ``P H^T S^-1`` by two triangular solves against S's Cholesky factor,
    as the reference does."""
    proj_mean, proj_cov = project(mean, covariance)
    u = _update_mat(mean)
    chol = torch.linalg.cholesky(proj_cov)  # [N, 4, 4]
    pht = torch.einsum("nij,kj->nik", covariance, u)  # [N, 8, 4]
    z = torch.linalg.solve_triangular(chol, pht.transpose(1, 2), upper=False)
    kt = torch.linalg.solve_triangular(chol.transpose(1, 2), z, upper=True)
    gain = kt.transpose(1, 2)  # [N, 8, 4]
    innovation = measurement - proj_mean
    new_mean = mean + torch.einsum("nij,nj->ni", gain, innovation)
    new_cov = covariance - torch.einsum("nij,njk,nlk->nil", gain, proj_cov,
                                        gain)
    return new_mean, new_cov


def gating_distance(mean: torch.Tensor, covariance: torch.Tensor,
                    measurements: torch.Tensor, only_position: bool = False,
                    metric: str = "maha") -> torch.Tensor:
    """Squared gating distance ``[N, M]`` of xyah measurements ``[M, 4]``
    to N track states."""
    proj_mean, proj_cov = project(mean, covariance)
    if only_position:
        proj_mean = proj_mean[:, :2]
        proj_cov = proj_cov[:, :2, :2]
        measurements = measurements[:, :2]
    d = measurements[None, :, :] - proj_mean[:, None, :]  # [N, M, k]
    if metric == "gaussian":
        return torch.sum(d * d, dim=-1)
    if metric == "maha":
        chol = torch.linalg.cholesky(proj_cov)
        z = torch.linalg.solve_triangular(chol, d.transpose(1, 2),
                                          upper=False)
        return torch.sum(z * z, dim=1)
    raise ValueError(f"invalid distance metric: {metric}")
