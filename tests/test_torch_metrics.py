"""The port's host metric stack (busca_tpu_torch.eval.metrics, ops.lap)
against busca_tpu's on the same inputs: the reference's metric regression
cases (tests/test_metrics_fuzz.py), a seeded fuzz block of tiny scenes, and
seeded cost matrices through the assignment solvers.

Both packages run the same float64 numpy code on the same inputs, so every
field must be equal exactly.  The detection-AP cases of the reference (the
recall-threshold linspace quirk and seed 3001468) go through CLEAR and HOTA
here, each image a frame and each box its own id; the port's COCO evaluator
(``eval/detection.py``) is held in tests/test_torch_detection.py.
"""

import numpy as np
import pytest

from busca_tpu.eval import metrics as jmetrics
from busca_tpu.ops import lap as jlap
from busca_tpu_torch.eval import metrics as tmetrics
from busca_tpu_torch.ops import lap as tlap
from test_metrics_fuzz import _random_detections, _random_scene

REGRESSION_SEEDS = [1001855, 1005905, 1015153, 1021523, 1032252, 1046651]


def _assert_same(gt, pred):
    want = jmetrics.evaluate_clear(gt, pred).as_dict()
    got = tmetrics.evaluate_clear(gt, pred).as_dict()
    assert got == want
    assert tmetrics.evaluate_hota(gt, pred) == jmetrics.evaluate_hota(gt, pred)
    return got


def _detections_as_scene(dets, gts):
    """Detection-AP inputs as a tracking scene: image i is frame i, every gt
    box id 1 + its index, every detection id 100 + its index, the detection
    score its confidence."""
    gt, pred = {}, {}
    for img, boxes in gts.items():
        tlwh = np.asarray(boxes, float).copy()
        tlwh[:, 2:] -= tlwh[:, :2]
        gt[img] = (tlwh, np.arange(1, len(tlwh) + 1))
    for img, (boxes, scores) in dets.items():
        tlwh = np.asarray(boxes, float).copy()
        tlwh[:, 2:] -= tlwh[:, :2]
        pred[img] = (tlwh, np.arange(100, 100 + len(tlwh)),
                     np.asarray(scores, float))
    return gt, pred


def test_clear_maximizes_matches():
    """One strong pair and two moderate cross pairs: two matches, as
    motmetrics keeps (the reference's seed-1001855 regression)."""
    gt = {0: (np.array([[33.3, 40.9, 22.1, 20.3],
                        [29.8, 41.4, 27.9, 14.3]]),
              np.array([1, 2]))}
    pred = {0: (np.array([[33.1, 42.1, 21.6, 20.0],
                          [33.9, 46.0, 29.6, 17.2]]),
                np.array([11, 12]), np.ones(2))}
    got = _assert_same(gt, pred)
    assert got["num_matches"] == 2
    assert got["num_false_positives"] == got["num_misses"] == 0


@pytest.mark.parametrize("seed", REGRESSION_SEEDS)
def test_clear_regression_seeds(seed):
    rng = np.random.RandomState(seed)
    gt, pred = _random_scene(rng, n_frames=rng.randint(2, 13), max_gt=4)
    _assert_same(gt, pred)


def test_recall_threshold_linspace_scene():
    """The reference's linspace-quirk scene: 10 gt boxes, the first 7
    detected exactly."""
    gts = {0: np.array([[10.0 * i, 0.0, 10.0 * i + 8.0, 8.0]
                        for i in range(10)])}
    boxes = np.array([[10.0 * i, 0.0, 10.0 * i + 8.0, 8.0]
                      for i in range(7)])
    dets = {0: (boxes, np.linspace(0.9, 0.3, 7))}
    got = _assert_same(*_detections_as_scene(dets, gts))
    assert got["num_matches"] == 7 and got["num_misses"] == 3


def test_seed_3001468_scene():
    rng = np.random.RandomState(3001468)
    dets, gts = _random_detections(rng, n_imgs=rng.randint(1, 4))
    _assert_same(*_detections_as_scene(dets, gts))


def test_duplicate_id_in_frame_is_rejected_by_both():
    gt = {0: (np.array([[10.0, 10, 20, 20]]), np.array([1]))}
    bad = {0: (np.array([[10.0, 10, 20, 20], [40.0, 40, 10, 10]]),
               np.array([7, 7]), np.ones(2))}
    for mod in (jmetrics, tmetrics):
        with pytest.raises(ValueError, match="repeats"):
            mod.evaluate_clear(gt, bad)
        with pytest.raises(ValueError, match="repeats"):
            mod.evaluate_hota(gt, bad)


@pytest.mark.parametrize("block", range(4))
def test_fuzz_block(block):
    """30 seeded tiny scenes per block, 120 in all, and the CLEAR tallies of
    each block accumulated by both packages."""
    per_seq_j, per_seq_t = {}, {}
    for i in range(30):
        seed = 200_000 + block * 30 + i
        rng = np.random.RandomState(seed)
        gt, pred = _random_scene(rng, n_frames=rng.randint(2, 13), max_gt=4)
        _assert_same(gt, pred)
        per_seq_j[seed] = jmetrics.evaluate_clear(gt, pred)
        per_seq_t[seed] = tmetrics.evaluate_clear(gt, pred)
    assert (tmetrics.accumulate(per_seq_t).as_dict()
            == jmetrics.accumulate(per_seq_j).as_dict())


def _cost(rng, n, m, kind):
    cost = rng.uniform(0.0, 1.0, (n, m))
    if kind == "ties":
        cost = np.round(cost * 4) / 4  # many equal entries
    elif kind == "forbidden":
        cost[rng.rand(n, m) < 0.3] = np.inf
    return cost


KINDS = ["uniform", "ties", "forbidden"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (8, 8), (12, 5)])
def test_lap_matches_jax(kind, shape):
    rng = np.random.RandomState(100 * shape[0] + 10 * shape[1]
                                + KINDS.index(kind))
    for _ in range(10):
        cost = _cost(rng, *shape, kind)
        for thresh in (0.3, 0.8):
            want = jlap.linear_assignment(cost, thresh)
            got = tlap.linear_assignment(cost, thresh)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
            want = jlap.lapjv(cost, extend_cost=True, cost_limit=thresh)
            got = tlap.lapjv(cost, extend_cost=True, cost_limit=thresh)
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[2], want[2])
        for a, b in zip(tlap.solve_dense(cost), jlap.solve_dense(cost)):
            np.testing.assert_array_equal(a, b)
        if kind != "forbidden":
            want = jlap.lapjv(cost)
            got = tlap.lapjv(cost)
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])
