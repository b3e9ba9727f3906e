"""Camera-motion compensation by ECC image alignment (port of the cv2 path
of ``busca_tpu.trackers.cmc``).

The reference aligns consecutive grayscale frames with OpenCV's
``findTransformECC`` (Euclidean motion, 100 iterations, eps 1e-5,
byte_tracker.py:626-650) and warps every unmatched track's position by the
recovered 2x3 matrix.  cv2 is optional and imported where it is used:
without it, and when ECC does not converge, the warp is the identity.
:func:`submit_warp` runs a solve on a shared thread pool, so the lockstep
drivers overlap the sequences' solves with each other and with the device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

IDENTITY_2X3 = np.eye(2, 3, dtype=np.float32)


def ecc_align(
    prev_frame: np.ndarray,
    cur_frame: np.ndarray,
    number_of_iterations: int = 100,
    termination_eps: float = 1e-5,
    warp_mode: str = "MOTION_EUCLIDEAN",
    scale: float = 1.0,
    gauss_filt_size: int = 0,
):
    """Estimate the 2x3 warp aligning ``prev_frame`` to ``cur_frame``.

    ``scale`` < 1 solves on INTER_AREA-downscaled images and rescales the
    translation; ``gauss_filt_size`` > 0 pre-smooths inside cv2.  Returns
    ``(correlation_coefficient, warp_matrix [2, 3])``.
    """
    try:
        import cv2
    except ImportError:
        return 1.0, IDENTITY_2X3.copy()
    prev_frame = np.asarray(prev_frame)
    cur_frame = np.asarray(cur_frame)
    modes = {
        "MOTION_EUCLIDEAN": cv2.MOTION_EUCLIDEAN,
        "MOTION_AFFINE": cv2.MOTION_AFFINE,
    }
    if warp_mode not in modes:
        raise ValueError(f"Invalid warp_mode: {warp_mode}")
    g1 = cv2.cvtColor(prev_frame, cv2.COLOR_BGR2GRAY)
    g2 = cv2.cvtColor(cur_frame, cv2.COLOR_BGR2GRAY)
    if not 0.0 < scale <= 1.0:
        raise ValueError(f"cmc scale must be in (0, 1], got {scale}")
    if scale != 1.0:
        g1 = cv2.resize(g1, None, fx=scale, fy=scale,
                        interpolation=cv2.INTER_AREA)
        g2 = cv2.resize(g2, None, fx=scale, fy=scale,
                        interpolation=cv2.INTER_AREA)
    warp = np.eye(2, 3, dtype=np.float32)
    criteria = (
        cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT,
        number_of_iterations,
        termination_eps,
    )
    try:
        if gauss_filt_size > 0:
            cc, warp = cv2.findTransformECC(
                g1, g2, warp, modes[warp_mode], criteria, None,
                gauss_filt_size,
            )
        else:
            cc, warp = cv2.findTransformECC(
                templateImage=g1,
                inputImage=g2,
                warpMatrix=warp,
                motionType=modes[warp_mode],
                criteria=criteria,
            )
    except cv2.error:
        return 1.0, IDENTITY_2X3.copy()
    if scale != 1.0:
        warp = warp.copy()
        warp[:, 2] /= scale  # rotation is scale-invariant; translation isn't
    return float(cc), warp


def parse_scale(value):
    """argparse ``type=`` validator for ``--cmc-scale``: float in (0, 1]."""
    import argparse

    s = float(value)
    if not 0.0 < s <= 1.0:
        raise argparse.ArgumentTypeError(
            f"cmc scale must be in (0, 1], got {s}"
        )
    return s


def apply_warp(tracks: Sequence, warp: np.ndarray):
    """Warp every track's position by a precomputed 2x3 matrix."""
    for t in tracks:
        t.apply_camera_motion(warp)


_EXECUTOR = None


def submit_warp(prev_frame, cur_frame, scale: float = 1.0, **ecc_kwargs):
    """Schedule ``ecc_align(prev_frame, cur_frame, scale=scale,
    **ecc_kwargs)`` on the shared CMC thread pool (at most 8 workers, named
    ``cmc-ecc``) and return its ``concurrent.futures.Future`` of ``(cc,
    warp)``.  cv2 releases the GIL in its solve, so the lockstep drivers'
    ``cmc_prefetch`` calls, each with its tracker's own recipe, run the
    sequences' solves side by side while the device works."""
    global _EXECUTOR
    if _EXECUTOR is None:
        import concurrent.futures
        import os

        _EXECUTOR = concurrent.futures.ThreadPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            thread_name_prefix="cmc-ecc",
        )
    return _EXECUTOR.submit(ecc_align, prev_frame, cur_frame, scale=scale,
                            **ecc_kwargs)


def compensate_tracks(
    tracks: Sequence,
    prev_frame: Optional[np.ndarray],
    cur_frame: Optional[np.ndarray],
    scale: float = 1.0,
) -> float:
    """ECC-align frames and warp each track (byte_tracker.py:626-650)."""
    if prev_frame is None or cur_frame is None:
        return 1.0
    cc, warp = ecc_align(prev_frame, cur_frame, scale=scale)
    apply_warp(tracks, warp)
    return cc
