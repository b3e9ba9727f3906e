"""The port's StrongSORT tracker: busca_tpu's StrongSORT cases through the
port, and StrongSORT + BUSCA held against busca_tpu frame by frame on the
CPU.

The parity scenes are seeded random streams (tests/test_pipeline_fuzz.py's
``_random_sequence``: 3-6 objects, dropout windows, score dips, detector
noise) with per-identity features (tests/test_pipeline_oracle.py's
``_object_features``), through the small BUSCA model of
tests/test_torch_byte_pipeline.py with weights shared through the weight
bridge.  Track ids and boxes must be equal on every frame; third-round
probabilities must agree within 0.0242 (the measured crop-noise tail of the
JAX pipeline fuzz); each scene must run at least one third round.
"""

import numpy as np
import pytest
import torch

from busca_tpu.trackers.strongsort import StrongSortConfig as JSSCfg
from busca_tpu.trackers.strongsort import StrongSortTracker as JSS
from busca_tpu_torch.eval.run import make_tracker
from busca_tpu_torch.trackers.strongsort import (
    NearestNeighborMetric,
    StrongSortConfig,
    StrongSortTracker,
)
from test_byte_tracker import StubEngine as JStubEngine
from test_pipeline_fuzz import _random_sequence
from test_pipeline_oracle import _object_features
from test_torch_byte_pipeline import (  # noqa: F401 (the fixture)
    CROP_HW,
    PROB_TOL,
    _logged,
    engines,
)

FRAME = np.zeros((240, 320, 3), dtype=np.uint8)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tests run many small torch ops per frame beside JAX; with
    torch's default thread pool in each of the suite's parallel workers the
    CPU is oversubscribed, and a module slows down many times over.  One
    intra-op thread for the module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StubEngine(JStubEngine):
    """Always (or never) votes for the Kalman candidate, on the CPU."""

    device = torch.device("cpu")


def _objects(t):
    b1 = np.array([50 + 3 * t, 60, 90 + 3 * t, 160])
    b2 = np.array([200, 100 + 2 * t, 240, 190 + 2 * t])
    feats = np.eye(2, 8)  # distinct, constant appearance per object
    return np.stack([b1, b2]), np.array([0.9, 0.85]), feats


def _run(tracker, frames, dropout=(), drop_obj=0):
    outs = []
    for t in range(frames):
        boxes, scores, feats = _objects(t)
        if t in dropout:
            keep = [i for i in range(2) if i != drop_obj]
            boxes, scores, feats = boxes[keep], scores[keep], feats[keep]
        tracker.predict()
        outs.append(tracker.update(boxes, scores, feats, FRAME))
    return outs


# ---- tests/test_strongsort.py's cases through the port -------------------

def test_stable_tracking():
    trk = StrongSortTracker(StrongSortConfig())
    outs = _run(trk, 12)
    assert len(outs[2]) == 2  # confirmed after n_init=3 frames
    assert sorted(t.track_id for t in outs[3]) == \
        sorted(t.track_id for t in outs[11])


def test_appearance_gallery_matching():
    m = NearestNeighborMetric(matching_threshold=0.3, budget=5)
    f1 = np.array([1.0, 0, 0])
    f2 = np.array([0, 1.0, 0])
    m.partial_fit([f1, f2], [1, 2], [1, 2])
    cost = m.distance(np.stack([f2, f1]), [1, 2])
    assert cost[0, 1] < 0.01 and cost[1, 0] < 0.01
    assert cost[0, 0] > 0.9 and cost[1, 1] > 0.9


def test_nsa_kalman_trusts_confident_measurements():
    from busca_tpu_torch.core.hostmath import HostKalman

    kf = HostKalman()
    m, c = kf.initiate(np.array([[100.0, 100.0, 0.5, 80.0]]))
    m, c = kf.predict(m, c)
    z = np.array([[120.0, 100.0, 0.5, 80.0]])
    m_hi, _ = kf.update(m, c, z, confidence=np.array([0.99]))
    m_lo, _ = kf.update(m, c, z, confidence=np.array([0.01]))
    assert abs(m_hi[0, 0] - 120.0) < abs(m_lo[0, 0] - 120.0)


def test_busca_rescue_and_conf_filtered_memory():
    cfg = StrongSortConfig(use_busca=True)
    trk = StrongSortTracker(cfg, assoc_engine=StubEngine(kalman_prob=1.0))
    outs = _run(trk, 30, dropout=range(15, 20))
    assert sorted(t.track_id for t in outs[13]) == \
        sorted(t.track_id for t in outs[28])
    assert len(outs[16]) == 2  # the rescued track stays in the output
    # the BUSCA-rescued frames carry conf 0.10000001 and stay out of the
    # conf-filtered memory views
    track = [t for t in trk.tracks if t.is_confirmed()][0]
    thr = cfg.min_confidence + cfg.minimum_conf_modifier
    assert trk.conf_threshold == thr
    assert sum(1 for c in track.conf_mem if c < thr) > 0
    assert len(track.images_mem) == sum(
        1 for c, im in zip(track.conf_mem, track._images_mem)
        if c >= thr and im is not None)


def test_busca_skips_old_tracks():
    """Only confirmed age-1 tracks enter the third round."""
    cfg = StrongSortConfig(use_busca=True, max_age=30)
    trk = StrongSortTracker(cfg, assoc_engine=StubEngine(kalman_prob=1.0))
    outs = _run(trk, 10, dropout=range(5, 10))
    assert len(outs[7]) == 1


def test_deepsort_alias_vanilla_flags():
    """``deepsort`` = vanilla DeepSORT: cascade, gallery, plain Kalman."""
    cfg = make_tracker("deepsort", {}, engine=None).cfg
    assert not cfg.nsa and not cfg.ema and not cfg.mc and not cfg.woc
    assert cfg.max_cosine_distance == 0.2 and cfg.nn_budget == 100
    assert make_tracker("deepsort", {"nsa": True}, engine=None).cfg.nsa
    assert make_tracker("strongsort", {}, engine=None).cfg.nsa


# ---- StrongSORT + BUSCA against busca_tpu, frame by frame ----------------

def _parity(engines, seed):
    """Both packages' StrongSortTracker + BUSCA over one seeded stream;
    returns (third rounds, every ``_assign`` call of the port as (args,
    result))."""
    jeng, teng = engines
    seq = _random_sequence(seed)
    kw = dict(use_busca=True, crop_hw=CROP_HW, busca_thresh=0.1,
              select_highest_candidate=False)
    jtrk = JSS(JSSCfg(**kw), jeng)
    ttrk = StrongSortTracker(StrongSortConfig(**kw), teng)
    assigns = []
    assign = ttrk._assign

    def logged_assign(cost, tracks, dets, max_distance):
        out = assign(cost, tracks, dets, max_distance)
        assigns.append(((np.array(cost), list(tracks), list(dets),
                         max_distance), out))
        return out

    ttrk._assign = logged_assign
    rng_feats = {oid: np.random.RandomState(500 + oid).randn(32)
                 for oid in range(len(seq.objects))}
    jlog, tlog = [], []
    jorig, torig = _logged(jeng, jlog), _logged(teng, tlog)
    third_rounds = 0
    try:
        for t in range(seq.num_frames):
            frame = seq.frame(t)
            boxes, scores = seq.detections(t)
            feats = _object_features(seq, t, rng_feats)
            n_log = len(jlog)
            outs = []
            for trk in (jtrk, ttrk):
                trk.predict()
                outs.append(trk.update(
                    boxes.copy(), scores.copy(),
                    None if feats is None else feats.copy(), frame))
            jout, tout = outs
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
    return third_rounds, assigns


@pytest.mark.parametrize("seed", [606, 707])
def test_strongsort_busca_frame_by_frame(engines, seed):
    third_rounds, _ = _parity(engines, seed)
    assert third_rounds >= 1, "the stream never reached the third round"


def test_strongsort_assign_protocol_seed(engines):
    """deep_sort's assignment protocol (a full Hungarian over the matrix
    clamped to ``max_distance + 1e-5``; clamped pairs take part, then drop,
    linear_assignment.py:52-86), the fix pinned by tests/test_pipeline_fuzz.
    py::test_strongsort_assign_protocol_seed on seed 8006's stream.

    After both fixes no frame of that stream separates the protocols any
    more (busca_tpu's run there assigns as a cost-limit LAP would), so the
    4x4 frame is built: rows 0-1 sit within 1e-5 of the tie between one
    clamped and two valid pairs, where the Hungarian matches both rows and
    the cost-limit LAP leaves row 1 coasting.  The port must pick
    busca_tpu's assignment there, and on every frame of seed 8006's stream,
    run frame by frame with busca_tpu."""
    from busca_tpu_torch.ops import lap

    clamp = 0.45 + 1e-5
    cost = np.array([[0.1, 0.25, clamp, clamp],
                     [0.300005, clamp, clamp, clamp],
                     [clamp, clamp, 0.1, clamp],
                     [clamp, clamp, clamp, 0.2]])
    ids = [3, 5, 6, 9]
    want = JSS._assign(cost, ids, list(range(4)), 0.45)
    assert StrongSortTracker._assign(cost, ids, list(range(4)), 0.45) == want
    assert want[0] == [(3, 1), (5, 0), (6, 2), (9, 3)]
    limit = lap.linear_assignment(cost, 0.45)[0].tolist()
    assert sorted(map(tuple, limit)) == [(0, 0), (2, 2), (3, 3)]

    third_rounds, assigns = _parity(engines, 8006)
    assert third_rounds >= 1
    assert assigns
    for args, got in assigns:
        assert got == JSS._assign(*args)
