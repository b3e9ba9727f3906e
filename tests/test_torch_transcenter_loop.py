"""The port's TransCenter loop against busca_tpu's on the CPU: the tiny
TransCenterDetector (64x96 test size) + TransCenterByteTracker + BUSCA (the
small engine of tests/test_torch_byte_pipeline.py) over the first frames of
the synthetic dropout sequence, with the detector weights carried across by
``transcenter_state_dict_from_flax``.

Per frame the detection counts must be equal, the boxes and scores within
1e-3 and the track ids equal.  The detector maps agree to about 1e-6
(tests/test_torch_transcenter_model.py), so the loop can only diverge where
a score sits within that noise of a threshold; the test checks that none
does on this seed, rather than tolerate a flip.
"""

import jax
import numpy as np
import pytest

from busca_tpu.eval import detector as jdetector
from busca_tpu.eval.synthetic import default_dropout_sequence
from busca_tpu.models.transcenter import TransCenterConfig as JConfig
from busca_tpu.trackers.base import Track as JTrack
from busca_tpu.trackers.byte import ByteTrackerConfig as JByteCfg
from busca_tpu.trackers.transcenter import (
    TransCenterByteTracker as JTracker,
)
from busca_tpu.trackers.transcenter import (
    boxes_to_center_priors as j_boxes_to_center_priors,
)
from busca_tpu_torch.eval import detector as tdetector
from busca_tpu_torch.eval.run import make_tracker
from busca_tpu_torch.models.convert import transcenter_state_dict_from_flax
from busca_tpu_torch.models.transcenter import TransCenterConfig
from busca_tpu_torch.trackers.base import Track
from busca_tpu_torch.trackers.byte import ByteTrackerConfig
from busca_tpu_torch.trackers.transcenter import (
    TransCenterByteTracker,
    boxes_to_center_priors,
)
from test_torch_byte_pipeline import CROP_HW, engines  # noqa: F401
from test_torch_transcenter_model import random_params

TEST_SIZE = (64, 96)
N_FRAMES = 4
OUT_THRESH = 0.3
BOX_TOL = 1e-3
TRACKER_KW = dict(use_busca=True, crop_hw=CROP_HW, track_thresh=0.6,
                  busca_thresh=0.1, select_highest_candidate=False)
# every score threshold the loop applies: out_thresh, BYTE's low bound,
# track_thresh and det_thresh = track_thresh + 0.1
THRESHOLDS = (OUT_THRESH, 0.1, 0.6, 0.7)


@pytest.fixture(scope="module")
def detectors():
    th, tw = TEST_SIZE
    z = np.zeros((1, th, tw, 3), np.float32)
    hm = np.zeros((1, th // 4, tw // 4, 1), np.float32)
    jcfg = JConfig.tiny()
    from busca_tpu.models.transcenter import TransCenterDETR

    # seed 12: on seed 11 every score stays below det_thresh, so no track
    # starts.  The wh bias makes upright boxes of about 16x32 canvas pixels
    # (the output filter drops boxes wider than 1.6x their height).
    variables = jax.tree_util.tree_map(np.asarray, random_params(
        TransCenterDETR(jcfg), z, z, hm, seed=12))
    variables["params"]["wh_out"]["bias"] = np.array([4.0, 8.0], np.float32)
    jdet = jdetector.TransCenterDetector(
        jcfg, variables=variables, test_size=TEST_SIZE,
        out_thresh=OUT_THRESH)
    tdet = tdetector.TransCenterDetector(
        TransCenterConfig.tiny(),
        state_dict=transcenter_state_dict_from_flax(variables),
        test_size=TEST_SIZE, out_thresh=OUT_THRESH, device="cpu")
    return jdet, tdet


def _frames(n=N_FRAMES):
    seq = default_dropout_sequence(40)
    # start in the dropout window so that the third round runs
    start = next(t for t in range(seq.num_frames)
                 if not seq.objects[0].detected_at(t)) - 2
    return [seq.frame(t) for t in range(start, start + n)]


def test_detect_matches_jax(detectors):
    jdet, tdet = detectors
    jdet.reset()
    tdet.reset()
    # the last two centers lie outside the 64x96 plane and are clamped
    pos = np.array([[10.0, 8.0, 30.0, 50.0], [60.0, 20.0, 80.0, 60.0],
                    [-30.0, 10.0, -10.0, 30.0], [90.0, 55.0, 110.0, 80.0]],
                   np.float32)
    for i, frame in enumerate(_frames(3)):
        cur = None if i == 0 else pos
        want = jdet.detect(frame, current_pos=cur)
        got = tdet.detect(frame, current_pos=cur)
        assert got.scale == want.scale
        np.testing.assert_array_equal(got.image, np.asarray(want.image))
        assert got.image.dtype == np.uint8
        assert len(got.scores) == len(want.scores) > 0, f"frame {i}"
        np.testing.assert_allclose(got.boxes_tlbr, want.boxes_tlbr,
                                   rtol=0, atol=BOX_TOL)
        np.testing.assert_allclose(got.scores, want.scores, rtol=0,
                                   atol=BOX_TOL)


def _spy(engine, count):
    orig = engine.associate

    def associate(*a, **k):
        count[0] += 1
        return orig(*a, **k)

    engine.associate = associate
    return orig


def test_loop_matches_jax_frame_by_frame(detectors, engines):
    jdet, tdet = detectors
    jeng, teng = engines
    frames = _frames()
    jdet.reset()
    tdet.reset()
    JTrack.reset_id_counter()
    Track.reset_id_counter()
    jtrk = JTracker(JByteCfg(**TRACKER_KW), jeng)
    ttrk = make_tracker("transcenter", TRACKER_KW, teng, CROP_HW)
    assert isinstance(ttrk, TransCenterByteTracker)
    jlog, tlog = [], []
    jrounds, trounds = [0], [0]
    jorig, torig = _spy(jeng, jrounds), _spy(teng, trounds)
    try:
        want = jdetector.track_frames_with_detector(
            jdet, jtrk, frames, min_box_area=0.0, det_log=jlog)
        got = tdetector.track_frames_with_detector(
            tdet, ttrk, frames, min_box_area=0.0, det_log=tlog)
    finally:
        jeng.associate, teng.associate = jorig, torig
    assert got.num_frames == want.num_frames == N_FRAMES
    assert set(got.stage_times) == {"detector_s", "tracker_s"}
    for (fj, bj, sj), (ft, bt, st) in zip(jlog, tlog):
        assert ft == fj and len(st) == len(sj), f"frame {fj}"
        np.testing.assert_allclose(bt, bj, rtol=0, atol=BOX_TOL / 0.25)
        np.testing.assert_allclose(st, sj, rtol=0, atol=BOX_TOL)
        gaps = np.abs(np.asarray(sj)[:, None] - np.asarray(THRESHOLDS))
        assert gaps.min() > 1e-5, f"frame {fj}: a score sits on a threshold"
    for (fj, tl_j, ids_j, _), (ft, tl_t, ids_t, _) in zip(want.results,
                                                          got.results):
        assert ids_t == ids_j, f"frame {fj}: ids diverged"
        np.testing.assert_allclose(np.reshape(tl_t, (-1, 4)),
                                   np.reshape(tl_j, (-1, 4)), rtol=0,
                                   atol=BOX_TOL / 0.25)
    assert sum(len(r[2]) for r in got.results) > 0, "no track was output"
    assert trounds[0] == jrounds[0] >= 1, "the third round never ran"


def test_state_dict_round_trip(detectors):
    """``state_dict`` carries the previous canvas: restoring it into a fresh
    detector reproduces the unbroken stream's next frame; ``reset`` clears
    it, and a reset detector treats the next frame as the first."""
    _, tdet = detectors
    f0, f1, f2 = _frames(3)
    tdet.reset()
    assert tdet.state_dict() == {"pre_canvas": None}
    tdet.detect(f0)
    state = tdet.state_dict()
    assert state["pre_canvas"].dtype == np.uint8
    assert state["pre_canvas"].shape == TEST_SIZE + (3,)
    unbroken = tdet.detect(f1)

    other = tdetector.TransCenterDetector(
        TransCenterConfig.tiny(), state_dict=tdet.model.state_dict(),
        test_size=TEST_SIZE, out_thresh=OUT_THRESH, device="cpu")
    other.load_state_dict(state)
    resumed = other.detect(f1)
    np.testing.assert_array_equal(resumed.boxes_tlbr, unbroken.boxes_tlbr)
    np.testing.assert_array_equal(resumed.scores, unbroken.scores)

    other.reset()
    assert other.state_dict()["pre_canvas"] is None
    first = other.detect(f2)  # pre = curr
    tdet.reset()
    np.testing.assert_array_equal(tdet.detect(f2).scores, first.scores)
    other.load_state_dict({"pre_canvas": None})
    assert other.state_dict()["pre_canvas"] is None


def test_feedback_export_matches_jax():
    """The tracker's position export and the center-prior transform."""
    kw = dict(track_thresh=0.0)
    JTrack.reset_id_counter()
    Track.reset_id_counter()
    jtrk = JTracker(JByteCfg(**kw))
    ttrk = TransCenterByteTracker(ByteTrackerConfig(**kw))
    assert ttrk.get_detector_positions() is None
    boxes = np.array([[5.0, 5.0, 15.0, 20.0], [40.0, 10.0, 60.0, 50.0]])
    scores = np.array([0.9, 0.8])
    for trk in (jtrk, ttrk):
        trk.update(boxes, scores, 0.5, None)
        trk.update(boxes + 1.0, scores, 0.5, None)
    want = jtrk.get_detector_positions()
    got = ttrk.get_detector_positions()
    assert got.dtype == np.float32 and got.shape == (2, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(boxes_to_center_priors(got),
                                  j_boxes_to_center_priors(want))
    assert boxes_to_center_priors(None) is None


def test_build_transcenter_detector_from_npz(tmp_path):
    """The MOT17 preset (full width) from a busca_tpu ``.npz``: every
    parameter arrives in its place; ``.pth`` is refused."""
    from busca_tpu.models.checkpoint import save_params_npz
    from busca_tpu.models.transcenter import TransCenterDETR

    z = np.zeros((1, 64, 96, 3), np.float32)
    hm = np.zeros((1, 16, 24, 1), np.float32)
    variables = random_params(TransCenterDETR(JConfig.for_dataset("mot17")),
                              z, z, hm, seed=13)
    path = str(tmp_path / "transcenter.npz")
    save_params_npz(path, jax.tree_util.tree_map(np.asarray, variables))
    det = tdetector.build_transcenter_detector(ckpt=path, device="cpu")
    assert det.config.K == 300 and det.test_size == (640, 1088)
    sd = det.model.state_dict()
    p = variables["params"]
    np.testing.assert_array_equal(
        sd["pvt.stage2.attn_5.sr.weight"].numpy(),
        np.asarray(p["pvt"]["stage2"]["attn_5"]["sr"]["kernel"]).transpose(
            3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["dec_5.cross_pre.value_3.weight"].numpy(),
        np.asarray(p["dec_5"]["cross_pre"]["value_3"]["kernel"]).T)
    np.testing.assert_array_equal(
        sd["pvt.stage0.ffn_2.dwconv.weight"].numpy(),
        np.asarray(p["pvt"]["stage0"]["ffn_2"]["dwconv"]["kernel"]).transpose(
            3, 2, 0, 1))
    np.testing.assert_array_equal(sd["dec_norm.weight"].numpy(),
                                  np.asarray(p["dec_norm"]["scale"]))
    with pytest.raises(ValueError, match="npz"):
        tdetector.build_transcenter_detector(ckpt="weights.pth",
                                             device="cpu")
