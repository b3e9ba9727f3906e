"""The port's GHOST tracker: busca_tpu's GHOST tracker cases through the
port, and GHOST + BUSCA held against busca_tpu frame by frame on the CPU.

The parity run drives both packages' ``FeatureShim`` over a seeded random
stream with camera drift (tests/test_pipeline_fuzz.py's
``_random_sequence``): each package's ReID feature extractor (a small
ResNet, weights carried through the weight bridge) computes the features
of every detection and, in the third round, fresh features of the Kalman
candidates; BUSCA is the small model of tests/test_torch_byte_pipeline.py.
With ``motion_compensation`` off and on (ECC through cv2 on both sides).
Track ids and boxes must be equal on every frame; third-round
probabilities must agree within 0.0242.
"""

import jax
import numpy as np
import pytest
import torch

from busca_tpu.eval import run as jrun
from busca_tpu.eval.features import ReidFeatureExtractor as JExtractor
from busca_tpu.trackers.ghost import GhostConfig as JGhostCfg
from busca_tpu.trackers.ghost import GhostTracker as JGhost
from busca_tpu_torch.eval import run as trun
from busca_tpu_torch.eval.features import ReidFeatureExtractor
from busca_tpu_torch.models.convert import resnet_state_dict_from_flax
from busca_tpu_torch.trackers.ghost import (
    PROXY_REDUCERS,
    GhostConfig,
    GhostTrack,
    GhostTracker,
)
from test_pipeline_fuzz import _random_sequence
from test_torch_byte_pipeline import (  # noqa: F401 (the fixture)
    CROP_HW,
    PROB_TOL,
    _logged,
    engines,
)
from test_torch_strongsort import StubEngine, one_torch_thread  # noqa: F401

FRAME = np.zeros((240, 320, 3), dtype=np.uint8)


def _objects(t):
    b1 = np.array([50 + 3 * t, 60, 90 + 3 * t, 160])
    b2 = np.array([200, 100 + 2 * t, 240, 190 + 2 * t])
    return np.stack([b1, b2]), np.array([0.9, 0.85]), np.eye(2, 16)


def _run(tracker, frames, dropout=(), drop_obj=0):
    outs = []
    for t in range(frames):
        boxes, scores, feats = _objects(t)
        if t in dropout:
            keep = [i for i in range(2) if i != drop_obj]
            boxes, scores, feats = boxes[keep], scores[keep], feats[keep]
        outs.append(tracker.update(boxes, scores, feats, FRAME))
    return outs


# ---- tests/test_ghost.py's tracker cases through the port ----------------

def test_stable_tracking_and_id_persistence():
    outs = _run(GhostTracker(GhostConfig()), 12)
    assert len(outs[-1]) == 2
    assert sorted(t.track_id for t in outs[0]) == \
        sorted(t.track_id for t in outs[11])


def test_inactive_patience_revival():
    trk = GhostTracker(GhostConfig(apply_motion_model=False,
                                   inact_patience=10))
    outs = _run(trk, 16, dropout=range(6, 9))
    ids_before = sorted(t.track_id for t in outs[5])
    assert ids_before == sorted(t.track_id for t in outs[12])
    assert len(outs[7]) == 1
    trk2 = GhostTracker(GhostConfig(apply_motion_model=False,
                                    inact_patience=1))
    outs2 = _run(trk2, 16, dropout=range(6, 12))
    assert sorted(t.track_id for t in outs2[14]) != ids_before


def test_proxy_reducers():
    d = np.array([[0.1, 0.5, 0.9]])
    assert PROXY_REDUCERS["min"](d)[0] == 0.1
    assert PROXY_REDUCERS["max"](d)[0] == 0.9
    for mode in ("mean", "meanminmax", "median"):
        np.testing.assert_allclose(PROXY_REDUCERS[mode](d)[0], 0.5)


def test_dynamic_thresholds():
    trk = GhostTracker(GhostConfig(act_reid_thresh="tbd", thresh_tbd=True))
    _run(trk, 3)
    assert isinstance(trk.act_thresh, float)


def test_motion_model_predicts_forward():
    t = GhostTrack(1, np.array([0.0, 0, 10, 10]), np.ones(4), 0.9, 1)
    t.add_detection(np.array([5.0, 0, 15, 10]), np.ones(4), 0.9, 2)
    t.update_velocity(5)
    t.motion_step()
    np.testing.assert_allclose(t.pos, [10, 0, 20, 10])


def test_busca_rescue_ghost():
    trk = GhostTracker(GhostConfig(use_busca=True, inact_patience=30),
                       assoc_engine=StubEngine(kalman_prob=1.0))
    outs = _run(trk, 30, dropout=range(15, 20))
    assert len(outs[16]) == 2  # kept active by the Kalman candidate
    assert sorted(t.track_id for t in outs[14]) == \
        sorted(t.track_id for t in outs[25])
    tr = next(iter(trk.tracks.values()))
    assert 0.10000001 in tr.conf_mem  # rescue frames kept out of memory


def test_lockstep_prefetch_refused():
    """The lockstep drivers' ECC prefetch, refused before it was ported,
    now runs: nothing to align before the first frame or on a static
    camera; otherwise the solve is submitted with GHOST's recipe, its warp
    equals the inline solve's, and the next update consumes the hint."""
    from busca_tpu_torch.trackers import cmc

    rng = np.random.RandomState(4)
    frames = [rng.randint(0, 255, FRAME.shape, dtype=np.uint8)
              for _ in range(2)]
    frames[1] = np.roll(frames[0], 2, axis=1)
    static = GhostTracker(GhostConfig(motion_compensation=True,
                                      is_moving=False))
    static.update(*_objects(0), frames[0])
    assert static.cmc_prefetch(frames[1]) is None
    trk = GhostTracker(GhostConfig(motion_compensation=True))
    assert trk.cmc_prefetch(frames[0]) is None  # no previous frame
    trk.update(*_objects(0), frames[0])
    fut = trk.cmc_prefetch(frames[1])
    assert fut is not None and trk._warp_hint is not None
    cfg = trk.cfg
    _, want = cmc.ecc_align(frames[1], frames[0],
                            number_of_iterations=cfg.mc_num_iter,
                            termination_eps=cfg.mc_termination_eps,
                            gauss_filt_size=15)
    np.testing.assert_array_equal(fut.result()[1], want)
    trk.update(*_objects(1), frames[1])
    assert trk._warp_hint is None


# ---- GHOST + BUSCA against busca_tpu, frame by frame ---------------------

@pytest.fixture(scope="module")
def extractors():
    small = dict(layers=(1, 1, 1, 1), num_classes=7, crop_hw=CROP_HW)
    jext = JExtractor(**small)
    variables = jax.tree_util.tree_map(np.asarray, jext.variables)
    return jext, ReidFeatureExtractor(resnet_state_dict_from_flax(variables),
                                      device="cpu", **small)


@pytest.mark.parametrize("mc", [False, True], ids=["ecc_off", "ecc_on"])
def test_ghost_busca_frame_by_frame(engines, extractors, mc):
    jeng, teng = engines
    jext, text = extractors
    seq = _random_sequence(808, with_drift=True)
    # a rescued track takes its Kalman candidate's fresh features
    # (update_feats_third_round), so they steer the later rounds
    kw = dict(use_busca=True, crop_hw=CROP_HW, busca_thresh=0.1,
              select_highest_candidate=False, det_conf=0.5,
              motion_compensation=mc, is_moving=mc,
              update_feats_third_round=True)
    jshim = jrun.shim_for_runner(
        "ghost", JGhost(JGhostCfg(**kw), jeng, feature_extractor=jext),
        jext, CROP_HW)
    tshim = trun.shim_for_runner(
        "ghost", GhostTracker(GhostConfig(**kw), teng,
                              feature_extractor=text), text, CROP_HW)
    jlog, tlog = [], []
    jorig, torig = _logged(jeng, jlog), _logged(teng, tlog)
    third_rounds, det_frames, calls0 = 0, 0, text.calls
    try:
        for t in range(seq.num_frames):
            frame = seq.frame(t)
            boxes, scores = seq.detections(t)
            det_frames += len(boxes) > 0
            n_log = len(jlog)
            jout = jshim.update(boxes.copy(), scores.copy(), 1.0, frame)
            tout = tshim.update(boxes.copy(), scores.copy(), 1.0, frame)
            assert [x.track_id for x in tout] == \
                [x.track_id for x in jout], f"frame {t + 1}: ids diverged"
            for a, b in zip(tout, jout):
                np.testing.assert_array_equal(a.tlwh, b.tlwh,
                                              err_msg=f"frame {t + 1}")
            assert len(tlog) == len(jlog), f"frame {t + 1}"
            for pt, pj in zip(tlog[n_log:], jlog[n_log:]):
                assert (pt is None) == (pj is None)
                if pj is not None:
                    third_rounds += 1
                    np.testing.assert_allclose(pt, pj, rtol=0, atol=PROB_TOL,
                                               err_msg=f"frame {t + 1}")
    finally:
        jeng.associate, teng.associate = jorig, torig
    assert third_rounds >= 1, "the stream never reached the third round"
    # one call per frame for the detections, more for Kalman candidates
    assert text.calls - calls0 > det_frames


def test_shim_uploads_the_frame_once(extractors, monkeypatch):
    """The shim puts the frame on the extractor's device once; the
    tracker's crops reuse that tensor."""
    _, text = extractors
    seen = []
    orig = torch.as_tensor

    def spy(x, *a, **k):
        if isinstance(x, np.ndarray) and x.ndim == 3:
            seen.append(x.shape)
        return orig(x, *a, **k)

    trk = GhostTracker(GhostConfig(use_busca=True, crop_hw=CROP_HW),
                       StubEngine(), feature_extractor=text)
    shim = trun.shim_for_runner("ghost", trk, text, CROP_HW)
    monkeypatch.setattr(torch, "as_tensor", spy)
    boxes, scores, _ = _objects(0)
    shim.update(boxes, scores, 1.0, FRAME)
    assert seen == [FRAME.shape]
