"""The port's device box algebra and batched Kalman filter
(busca_tpu_torch.core.boxes / core.kalman) against busca_tpu's on the
same seeded float32 inputs, on the CPU.

Tolerances: box conversions, IoU matrices, distances and the score fusion
within 1e-5 relative and 1e-6 absolute (the same float32 operations; a
product or division may round once otherwise); the Kalman steps and
gating distances within 1e-4 relative (float32 Cholesky factors and
triangular solves in two libraries); the host filter's constants equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from busca_tpu.core import boxes as jboxes
from busca_tpu.core import kalman as jkalman
from busca_tpu_torch.core import boxes, hostmath, kalman

RTOL, ATOL = 1e-5, 1e-6
KALMAN_RTOL, KALMAN_ATOL = 1e-4, 1e-4


def _tlbr(rng, n):
    xy = rng.uniform(0, 300, (n, 2))
    wh = rng.uniform(5, 80, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("name", ["tlwh_to_tlbr", "tlbr_to_tlwh",
                                  "tlwh_to_xyah", "xyah_to_tlwh", "centers"])
def test_conversions_match_busca_tpu(rng, name):
    x = np.abs(rng.randn(7, 4).astype(np.float32)) * 50 + 1
    _close(getattr(boxes, name)(torch.from_numpy(x)),
           getattr(jboxes, name)(jnp.asarray(x)))


@pytest.mark.parametrize("name", ["iou_matrix", "iou_matrix_std",
                                  "iou_distance", "center_distance"])
def test_matrices_match_busca_tpu(rng, name):
    a, b = _tlbr(rng, 9), _tlbr(rng, 6)
    a[3] = a[5]  # a duplicate box (IoU 1) and overlapping pairs
    b[0] = 0.0  # a padded (zero) lane stays finite
    _close(getattr(boxes, name)(torch.from_numpy(a), torch.from_numpy(b)),
           getattr(jboxes, name)(jnp.asarray(a), jnp.asarray(b)))
    if name == "center_distance":
        _close(boxes.center_distance(torch.from_numpy(a),
                                     torch.from_numpy(b[1:]), True),
               jboxes.center_distance(jnp.asarray(a), jnp.asarray(b[1:]),
                                      True))


def test_fuse_score_matches_busca_tpu(rng):
    cost = rng.uniform(0, 1, (5, 4)).astype(np.float32)
    scores = rng.uniform(0, 1, 4).astype(np.float32)
    _close(boxes.fuse_score(torch.from_numpy(cost), torch.from_numpy(scores)),
           jboxes.fuse_score(jnp.asarray(cost), jnp.asarray(scores)))


def test_kalman_steps_match_busca_tpu(rng):
    xyah = np.concatenate([rng.uniform(50, 500, (6, 2)),
                           rng.uniform(0.3, 0.7, (6, 1)),
                           rng.uniform(40, 200, (6, 1))], 1).astype(np.float32)
    meas = (xyah + rng.randn(6, 4).astype(np.float32)
            * np.array([3, 3, 0.01, 3], np.float32))
    tm, tc = kalman.initiate(torch.from_numpy(xyah))
    jm, jc = jkalman.initiate(jnp.asarray(xyah))
    _close(tm, jm), _close(tc, jc)
    for _ in range(3):
        tm, tc = kalman.predict(tm, tc)
        jm, jc = jkalman.predict(jm, jc)
        _close(tm, jm, KALMAN_RTOL, KALMAN_ATOL)
        _close(tc, jc, KALMAN_RTOL, KALMAN_ATOL)
        tm, tc = kalman.update(tm, tc, torch.from_numpy(meas))
        jm, jc = jkalman.update(jm, jc, jnp.asarray(meas))
        _close(tm, jm, KALMAN_RTOL, KALMAN_ATOL)
        _close(tc, jc, KALMAN_RTOL, KALMAN_ATOL)
    probe = torch.from_numpy(meas[::-1].copy())
    for only_position in (False, True):
        for metric in ("maha", "gaussian"):
            _close(kalman.gating_distance(tm, tc, probe, only_position,
                                          metric),
                   jkalman.gating_distance(jm, jc, jnp.asarray(probe.numpy()),
                                           only_position, metric),
                   KALMAN_RTOL, KALMAN_ATOL)
    with pytest.raises(ValueError, match="metric"):
        kalman.gating_distance(tm, tc, probe, metric="cosine")
    assert kalman.initiate(torch.ones(2, 4, dtype=torch.int64))[0].dtype \
        == torch.float32


def test_host_filter_constants_are_busca_tpus():
    assert hostmath.CHI2INV95 == jkalman.CHI2INV95
    assert (kalman.STD_WEIGHT_POSITION, kalman.STD_WEIGHT_VELOCITY) == (
        jkalman.STD_WEIGHT_POSITION, jkalman.STD_WEIGHT_VELOCITY)
