"""The port's device ECC (busca_tpu_torch.ops.ecc) against busca_tpu's
``ecc_euclidean`` and against tests/test_ecc.py's ground-truth and cv2
bars, on the CPU, and the CMC ``backend`` argument.

Tolerances:
- against busca_tpu at 120x160 (translation, rotation, identical frames;
  50 and 80 iterations): the warp within 2e-5 (measured 3.5e-6: the same
  float32 sums in two libraries, the 3x3 solves in float64 here), the
  correlation within 1e-5;
- tests/test_ecc.py's bars: translation 0.2 px and the rotation block
  0.02; rotation angle 5e-3 and translation 0.5 px; cv2's warp within
  0.25; the gray conversion within 1 level of cv2's;
- ``jnp.gradient``'s edge rule: exact.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from busca_tpu.ops.ecc import ecc_euclidean as j_ecc
from busca_tpu_torch.ops import ecc as tecc
from busca_tpu_torch.trackers import cmc
from test_ecc import _apply_warp, _invert_affine, _textured

WARP_ATOL, RHO_ATOL = 2e-5, 1e-5


def _rot(theta, tx, ty):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, tx], [s, c, ty]], np.float32)


@pytest.mark.parametrize("true,iters", [
    (_rot(0.0, 3.0, -2.0), 50), (_rot(0.02, 2.0, 1.0), 80),
    (_rot(0.0, 0.0, 0.0), 20)], ids=["shift", "rotation", "identity"])
def test_matches_busca_tpu(rng, true, iters):
    tpl = _textured(rng)
    img = _apply_warp(tpl, true)
    rho_j, warp_j = j_ecc(jnp.asarray(tpl), jnp.asarray(img), iters)
    rho_t, warp_t = tecc.ecc_euclidean(torch.from_numpy(tpl),
                                       torch.from_numpy(img), iters)
    np.testing.assert_allclose(warp_t.numpy(), np.asarray(warp_j), rtol=0,
                               atol=WARP_ATOL)
    assert abs(float(rho_t) - float(rho_j)) <= RHO_ATOL


def test_recovers_translation_and_rotation(rng):
    """tests/test_ecc.py's ground-truth bars."""
    tpl = _textured(rng)
    true = np.array([[1, 0, 3.0], [0, 1, -2.0]], np.float32)
    rho, warp = tecc.ecc_euclidean(torch.from_numpy(tpl), torch.from_numpy(
        _apply_warp(tpl, true)), 60)
    want = _invert_affine(true)
    assert float(rho) > 0.95
    np.testing.assert_allclose(warp[:, 2].numpy(), want[:, 2], atol=0.2)
    np.testing.assert_allclose(warp[:, :2].numpy(), want[:, :2], atol=0.02)
    true = _rot(0.02, 2.0, 1.0)
    rho, warp = tecc.ecc_euclidean(torch.from_numpy(tpl), torch.from_numpy(
        _apply_warp(tpl, true)), 80)
    warp, want = warp.numpy(), _invert_affine(true)
    assert float(rho) > 0.9
    np.testing.assert_allclose(np.arctan2(warp[1, 0], warp[0, 0]),
                               np.arctan2(want[1, 0], want[0, 0]), atol=5e-3)
    np.testing.assert_allclose(warp[:, 2], want[:, 2], atol=0.5)


def test_matches_cv2_oracle(rng):
    tpl = _textured(rng)
    img = _apply_warp(tpl, np.array([[1, 0, 2.5], [0, 1, 1.5]], np.float32))
    crit = (cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 60, 1e-5)
    _, cv_warp = cv2.findTransformECC(
        templateImage=tpl, inputImage=img,
        warpMatrix=np.eye(2, 3, dtype=np.float32),
        motionType=cv2.MOTION_EUCLIDEAN, criteria=crit)
    _, warp = tecc.ecc_euclidean(torch.from_numpy(tpl),
                                 torch.from_numpy(img), 60)
    np.testing.assert_allclose(warp.numpy(), cv_warp, atol=0.25)


def test_gray_and_gradient(rng):
    frame = rng.randint(0, 255, (40, 50, 3), dtype=np.uint8)
    got = tecc.rgb_to_gray(torch.from_numpy(frame), bgr=True).numpy()
    want = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY).astype(np.float32)
    np.testing.assert_allclose(got, want, atol=1.0)
    img = rng.uniform(0, 255, (7, 9)).astype(np.float32)
    gy, gx = jnp.gradient(jnp.asarray(img))
    assert np.array_equal(tecc._gradient(torch.from_numpy(img), 0).numpy(),
                          np.asarray(gy))
    assert np.array_equal(tecc._gradient(torch.from_numpy(img), 1).numpy(),
                          np.asarray(gx))


class _Warped:
    def __init__(self):
        self.warps = []

    def apply_camera_motion(self, warp):
        self.warps.append(np.asarray(warp))


def test_cmc_backends(rng):
    """``compensate_tracks``: cv2 stays the default; ``backend="device"``
    warps the tracks by ``estimate_cmc``'s warp and refuses a scale, as
    busca_tpu's ``"jax"`` backend does; an unknown backend is refused; the
    device path runs on the card unless asked for the CPU, and raises
    without CUDA."""
    frame = rng.randint(0, 255, (80, 100, 3), dtype=np.uint8)
    rho, warp = tecc.estimate_cmc(frame, frame, num_iterations=20,
                                  device="cpu")
    assert rho > 0.99
    np.testing.assert_allclose(warp, np.eye(2, 3), atol=1e-2)
    tpl = np.stack([np.clip(_textured(rng), 0, 255).astype(np.uint8)] * 3,
                   axis=-1)
    cur = np.ascontiguousarray(_apply_warp(
        tpl, np.array([[1, 0, 2.0], [0, 1, -1.0]], np.float32)))
    tracks = [_Warped()]
    cc = cmc.compensate_tracks(tracks, tpl, cur, backend="device",
                               device="cpu")
    _, want = tecc.estimate_cmc(tpl, cur, device="cpu")
    assert np.array_equal(tracks[0].warps[0], want) and cc > 0.9
    default = [_Warped()]
    cmc.compensate_tracks(default, tpl, cur)
    np.testing.assert_array_equal(default[0].warps[0],
                                  cmc.ecc_align(tpl, cur)[1])
    with pytest.raises(ValueError, match="cv2 backend"):
        cmc.compensate_tracks([], tpl, cur, backend="device", scale=0.5,
                              device="cpu")
    with pytest.raises(ValueError, match="backend"):
        cmc.compensate_tracks([], tpl, cur, backend="jax")
    if not torch.cuda.is_available():
        # the device path defaults to the card: no quiet CPU solve
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cmc.compensate_tracks([], tpl, cur, backend="device")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tecc.estimate_cmc(tpl, cur)
