"""The port's StrongSORT cached-artifact path (``.npy`` detections with
features, deep_sort NMS, ECC-JSON camera warps, the deep_sort_app frame
loop) against busca_tpu's, on the fixture of tests/test_strongsort_io.py:
a deep_sort ``.npy`` and, for the full runs, JPEGs written with cv2.

Every output is compared exactly: the NMS picks, the ECC matrices, and the
result rows of whole cached runs (with BUSCA, with and without an ECC JSON).
"""

import json

import numpy as np
import pytest

from busca_tpu.eval import strongsort_io as jio
from busca_tpu.trackers.strongsort import StrongSortConfig as JSSCfg
from busca_tpu.trackers.strongsort import StrongSortTracker as JSS
from busca_tpu_torch.eval import strongsort_io as tio
from busca_tpu_torch.trackers.strongsort import (
    StrongSortConfig,
    StrongSortTracker,
)
from test_strongsort_io import FEAT_DIM, _make_fixture
from test_torch_byte_pipeline import CROP_HW, engines  # noqa: F401
from test_torch_strongsort import one_torch_thread  # noqa: F401


def test_gather_and_create_detections(tmp_path):
    seq, det_file, mat = _make_fixture(tmp_path)
    got = tio.gather_sequence_info(seq, det_file)
    want = jio.gather_sequence_info(seq, det_file)
    assert got.keys() == want.keys()
    for k in ("sequence_name", "min_frame_idx", "max_frame_idx",
              "feature_dim", "image_filenames"):
        assert got[k] == want[k], k
    assert got["feature_dim"] == FEAT_DIM
    np.testing.assert_array_equal(got["detections"], want["detections"])
    for frame, min_height in ((1, 0), (1, 25), (7, 0)):
        for a, b in zip(tio.create_detections(mat, frame, min_height),
                        jio.create_detections(mat, frame, min_height)):
            np.testing.assert_array_equal(a, b)


def test_deep_sort_nms_overlap_semantics():
    """Overlap = intersection over the candidate's area (not IoU), on the
    hand-made case and on seeded random boxes at several overlaps."""
    boxes = np.array([[0, 0, 10, 10], [0, 0, 5, 5], [50, 50, 10, 10]], float)
    scores = np.array([0.9, 0.5, 0.8])
    assert sorted(tio.non_max_suppression(boxes, 0.9, scores)) == [0, 2]
    assert sorted(tio.non_max_suppression(boxes, 1.0, scores)) == [0, 1, 2]
    rng = np.random.RandomState(5)
    for _ in range(20):
        n = rng.randint(0, 25)
        b = np.concatenate([rng.uniform(0, 200, (n, 2)),
                            rng.uniform(5, 60, (n, 2))], axis=1)
        s = rng.uniform(0, 1, n)
        for overlap in (0.3, 0.7, 1.0):
            assert tio.non_max_suppression(b, overlap, s) == \
                jio.non_max_suppression(b, overlap, s)


def test_ecc_matrix_guard(tmp_path):
    warps = {
        "1": np.eye(3).tolist(),
        "2": (np.eye(3) + 0.01).tolist(),
        "3": (np.eye(3) * 500.0).tolist(),  # degenerate -> identity
        "4": [[1, 0, 5], [0, 1, -3]],  # 2x3 accepted
    }
    path = tmp_path / "ecc.json"
    path.write_text(json.dumps(warps))
    got, want = tio.load_ecc_warps(str(path)), jio.load_ecc_warps(str(path))
    assert got == want
    assert tio.ecc_matrix_for_frame(got, 5) is None
    np.testing.assert_allclose(tio.ecc_matrix_for_frame(got, 3), np.eye(3))
    for f in (1, 2, 3, 4):
        np.testing.assert_array_equal(tio.ecc_matrix_for_frame(got, f),
                                      jio.ecc_matrix_for_frame(want, f))


@pytest.mark.parametrize("with_ecc", [False, True])
def test_full_cached_run_matches_jax(engines, tmp_path, with_ecc):
    """The whole deep_sort_app loop from files, StrongSORT + BUSCA on the
    JPEG frames: the result rows of both packages are equal, and the
    written txts are identical."""
    jeng, teng = engines
    seq, det_file, _ = _make_fixture(tmp_path, n_frames=16,
                                     with_images=True)
    ecc = None
    if with_ecc:
        rng = np.random.RandomState(2)
        ecc = {str(f): [[1, 0, float(rng.uniform(-3, 3))],
                        [0, 1, float(rng.uniform(-2, 2))], [0, 0, 1]]
               for f in range(2, 17, 3)}
    kw = dict(use_busca=True, crop_hw=CROP_HW, busca_thresh=0.1, n_init=2)
    outs = {}
    for tag, io, trk in (
            ("jax", jio, JSS(JSSCfg(**kw), jeng)),
            ("torch", tio, StrongSortTracker(StrongSortConfig(**kw), teng))):
        out_file = str(tmp_path / f"{tag}.txt")
        res = io.run_cached_sequence(seq, det_file, trk, min_confidence=0.6,
                                     ecc_warps=ecc, output_file=out_file)
        outs[tag] = (res, open(out_file).read())
    (got, got_txt), (want, want_txt) = outs["torch"], outs["jax"]
    assert got.name == want.name and got.num_frames == want.num_frames == 16
    for (fa, ta, ia, ca), (fb, tb, ib, cb) in zip(got.results, want.results):
        assert fa == fb and ia == ib and ca == cb
        np.testing.assert_array_equal(np.reshape(ta, (-1, 4)),
                                      np.reshape(tb, (-1, 4)))
    assert got_txt == want_txt
    assert len(got_txt.splitlines()) >= 2 * 12  # both objects tracked
