"""The batch-statistics third round encodes only crops that carry BN
weight (``assoc/engine.py::_fold_memory``): padding rows send no memory
crop through the ReID, each request's incomplete memories share one zero
crop, and the batch is padded to a multiple of 8 crops.  The BN
statistics and the ReID head still run over the slots
(``models/reid.py::UnitRows``).  Held against the same engine with the
memory unfolded before the model call (every row's ``[L]`` crops, padding
rows included, and the candidate crops padded to their rows, as
``BuscaModel`` takes them without ``mem_gather``) and against busca_tpu,
banked and not.  A call folds only where its unfolded batch has at least
``FOLD_MIN_CROPS`` crops (128, above every call of these small engines):
the tests of the folded path lower it to 0 (``fold_all``), and one test
holds the threshold itself.

Tolerances: the folded against the unfolded call bit for bit (within
tests/test_torch_associate_many.py's rtol 2e-4 / atol 2e-6 the design
would allow; one torch thread, as every module here: the CPU's products
then reduce in one order whatever the batch); against busca_tpu 1e-4;
bit for bit between the banked and unbanked scorers, which build the
same batch.
"""

import numpy as np
import pytest
import torch

from busca_tpu_torch.assoc import engine as engine_mod
from busca_tpu_torch.models.reid import ReIDResNet, UnitRows
from busca_tpu_torch.trackers.base import Track
from busca_tpu_torch.utils import profiling
from test_torch_associate_many import JAX_TOL
from test_torch_engine import (  # noqa: F401 (the fixture)
    H,
    SEQ_LEN,
    W,
    _det,
    _engines,
    _track,
    shared,
)
from test_torch_strongsort import one_torch_thread  # noqa: F401

MODES = ["unbanked", "banked"]
KW = dict(select_highest_candidate=False)


@pytest.fixture
def fold_all(monkeypatch):
    """Every call folds, however small its batch."""
    monkeypatch.setattr(engine_mod, "FOLD_MIN_CROPS", 0)


def _request(seed, mem_lens, n_dets=3):
    """Tracks with the given memory lengths (below ``SEQ_LEN`` is
    incomplete), a shared detection pool and a Kalman candidate each."""
    r = np.random.RandomState(seed)
    tracks = [_track(r, n, (40 + 25 * i, 60)) for i, n in enumerate(mem_lens)]
    dets = [_det(r, (50 + 20 * j, 60)) for j in range(n_dets)]
    kal = [Track(t.tlwh, 0.1, r.randint(0, 255, (H, W, 3), np.uint8), 1.0)
           for t in tracks]
    return (tracks, dets, None, kal)


def _unfold(engine):
    """``engine`` with each model call's memory units expanded back to
    ``[B, L]`` crops and its candidate crops cut or padded with zero crops
    to their rows before the call (no memory gather)."""
    orig = engine._probs

    def probs(mem, can, mem_boxes, can_boxes, mask, normalize_ims,
              mem_gather=None, can_weights=None, **kw):
        if mem_gather is not None:
            mem = mem[:, 0][torch.from_numpy(mem_gather)]
            rows = can_weights.shape[0]
            can = torch.cat([can, can.new_zeros((rows,) + can.shape[1:])])
            can = can[:rows]
        return orig(mem, can, mem_boxes, can_boxes, mask, normalize_ims,
                    can_weights=can_weights, **kw)

    engine._probs = probs
    return engine


def _associate(engine, req):
    tracks, dets, _, kal = req
    return engine.associate(tracks, dets, extra_kalman_candidates=kal, **KW)


# one request: 3 tracks in a 4-row bucket and 5 in an 8-row one, each with
# complete and incomplete memories; grouped: 5 tracks of three requests in
# an 8-row bucket, one request all incomplete, one all complete
ONE = [(1, [SEQ_LEN, 2, SEQ_LEN + 2]),
       (2, [1, SEQ_LEN, 3, SEQ_LEN + 1, 2])]
MANY = [(3, [SEQ_LEN, 2]), (4, [3]), (5, [SEQ_LEN + 1, SEQ_LEN])]
# four requests of 2 tracks: 20 candidate units, encoded as 24 crops and
# taken as 32 rows of the statistics
WIDE = [(20 + i, [SEQ_LEN, 2 + i]) for i in range(4)]


@pytest.mark.parametrize("mode", MODES)
def test_folded_equals_unfolded_and_busca_tpu(shared, mode, fold_all):
    jeng, teng = _engines(shared, mode)
    _, ref = _engines(shared, mode)
    _unfold(ref)
    for seed, lens in ONE:
        req = _request(seed, lens)
        (got, rel), (want, wrel) = _associate(teng, req), _associate(ref, req)
        np.testing.assert_array_equal(rel, wrel)
        np.testing.assert_array_equal(rel, np.asarray(lens) >= SEQ_LEN)
        np.testing.assert_array_equal(got, want)
        tracks, dets, _, kal = req
        jp, jrel = jeng.associate(tracks, dets, extra_kalman_candidates=kal,
                                  **KW)
        np.testing.assert_array_equal(rel, jrel)
        np.testing.assert_allclose(got, jp, rtol=0, atol=JAX_TOL)
    for case in (MANY, WIDE):
        requests = [_request(seed, lens) for seed, lens in case]
        got = teng.associate_many(requests, **KW)
        want = ref.associate_many(requests, **KW)
        jwant = jeng.associate_many(requests, **KW)
        for (p, r), (pw, rw), (pj, rj) in zip(got, want, jwant):
            np.testing.assert_array_equal(r, rw)
            np.testing.assert_array_equal(r, rj)
            np.testing.assert_array_equal(p, pw)
            np.testing.assert_allclose(p, pj, rtol=0, atol=JAX_TOL)


@pytest.mark.parametrize("mode", MODES)
def test_banked_equals_unbanked_with_incomplete_memories(shared, mode,
                                                         fold_all):
    """The banked and unbanked scorers fold by the same ``reliable`` flags,
    so they encode the same crops in the same order: equal bit for bit,
    whichever engine runs first."""
    _, unbanked = _engines(shared, "unbanked")
    _, banked = _engines(shared, "banked")
    first, second = ((unbanked, banked) if mode == "unbanked"
                     else (banked, unbanked))
    for seed, lens in ONE:
        req = _request(seed, lens)
        (p1, r1), (p2, r2) = _associate(first, req), _associate(second, req)
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(p1, p2)
    requests = [_request(seed, lens) for seed, lens in MANY]
    a = first.associate_many(requests, **KW)
    b = second.associate_many(requests, **KW)
    for (p1, r1), (p2, r2) in zip(a, b):
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(p1, p2)


def _resnet_inputs(monkeypatch):
    """Record every ReID input batch and its BN group weights."""
    seen = []
    orig = ReIDResNet.forward

    def forward(self, x, sample_mask=None):
        seen.append((x.clone(), sample_mask))
        return orig(self, x, sample_mask)

    monkeypatch.setattr(ReIDResNet, "forward", forward)
    return seen


@pytest.mark.parametrize("mode", MODES)
def test_a_call_that_folds_nothing_is_bit_equal(shared, mode, monkeypatch,
                                                fold_all):
    """No padding row (8 tracks fill their bucket), every memory complete,
    16 candidate units (a power of two and a multiple of 8), a memory of
    8 * L crops (a multiple of 8): the ReID's input batch is the unfolded
    call's, crop for crop, its statistics rows are the units in order with
    the unfolded call's weights, and the probabilities are equal bit for
    bit; one request and a grouped call of two."""
    _, teng = _engines(shared, mode)
    _, ref = _engines(shared, mode)
    _unfold(ref)
    seen = _resnet_inputs(monkeypatch)
    req = _request(7, [SEQ_LEN + i for i in range(8)], n_dets=7)
    (got, rel), (want, wrel) = _associate(teng, req), _associate(ref, req)
    np.testing.assert_array_equal(rel, wrel)
    np.testing.assert_array_equal(got, want)
    requests = [_request(8, [SEQ_LEN] * 4), _request(9, [SEQ_LEN + 1] * 4)]
    for (p1, r1), (p2, r2) in zip(teng.associate_many(requests, **KW),
                                  ref.associate_many(requests, **KW)):
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(p1, p2)
    assert len(seen) == 4
    assert all(len(x) == 8 * SEQ_LEN + 16 for x, _ in seen)
    for (x1, m1), (x2, m2) in zip(seen[0::2], seen[1::2]):
        assert torch.equal(x1, x2)
        assert isinstance(m1, UnitRows) and torch.equal(m1.weights, m2)
        assert torch.equal(m1.rows, torch.arange(len(x1)))
        assert torch.equal(m1.ids, torch.argmax(m2, dim=-1))


def _counts(engine, calls):
    """The counters of each call in ``calls`` (functions of the engine)."""
    profiling.enable_tracing()
    try:
        out = []
        for call in calls:
            call(engine)
            out.append(profiling.drain().counts)
        return out
    finally:
        profiling.disable_tracing()


CALLS = [
    lambda e: _associate(e, _request(10, [SEQ_LEN, 2, SEQ_LEN + 1],
                                     n_dets=2)),
    lambda e: e.associate_many([_request(s, lens) for s, lens in MANY],
                               **KW),
    lambda e: e.associate_many([_request(seed, [SEQ_LEN, SEQ_LEN])
                                for seed, _ in WIDE], **KW),
]


@pytest.mark.parametrize("mode", MODES)
def test_counters_count_the_crops_encoded(shared, mode, fold_all):
    """One request of 3 tracks (one incomplete memory) in a 4-row bucket:
    2 complete memories' 2 * L crops and one zero crop, 6 candidate units
    (the zero crop, 2 detections, 3 Kalman candidates), the batch padded
    to 24.  The grouped call of MANY: 5 tracks in 8 rows, 3 complete
    memories and 2 requests' zero crops, 14 candidate units (each
    request's zero crop, the 2 detections nearest its tracks, its Kalman
    candidates), padded to 32.  Four requests of 2 complete memories fill
    8 rows and fold no memory; 20 candidate units pad the batch to 64
    crops, where the unfolded batch has 8 * L + 32."""
    one, many, full = _counts(_engines(shared, mode)[1], CALLS)
    units = 2 * SEQ_LEN + 1
    assert (one["assoc.tracks"], one["assoc.rows"]) == (3, 4)
    assert one["assoc.crops"] == 24
    assert one["assoc.mem_folded"] == 4 * SEQ_LEN - units
    units = 3 * SEQ_LEN + 2
    assert (many["assoc.tracks"], many["assoc.rows"]) == (5, 8)
    assert many["assoc.crops"] == 32
    assert many["assoc.mem_folded"] == 8 * SEQ_LEN - units
    assert (full["assoc.tracks"], full["assoc.rows"]) == (8, 8)
    assert full["assoc.crops"] == 64
    assert full["assoc.mem_folded"] == 0


@pytest.mark.parametrize("mode", MODES)
def test_only_calls_of_fold_min_crops_fold(shared, mode, monkeypatch):
    """At the real threshold (128) none of these calls folds: each encodes
    its unfolded batch, ``b * L`` memory crops and ``next_pow2(u, 8)``
    candidates, with probabilities equal bit for bit to the unfolded
    call's.  At 48, the single request's 4 * L + 8 = 28 crops stay whole,
    the grouped calls' 8 * L + 16 = 56 and 8 * L + 32 = 72 fold, and the
    first of them is padded up to 48 crops."""
    teng = _engines(shared, mode)[1]
    _, ref = _engines(shared, mode)
    _unfold(ref)
    for call in CALLS:
        got, want = call(teng), call(ref)
        if isinstance(got, tuple):
            got, want = [got], [want]
        for (p1, r1), (p2, r2) in zip(got, want):
            np.testing.assert_array_equal(r1, r2)
            np.testing.assert_array_equal(p1, p2)
    one, many, full = _counts(teng, CALLS)
    assert (one["assoc.crops"], one["assoc.mem_folded"]) == (
        4 * SEQ_LEN + 8, 0)
    assert (many["assoc.crops"], many["assoc.mem_folded"]) == (
        8 * SEQ_LEN + 16, 0)
    assert (full["assoc.crops"], full["assoc.mem_folded"]) == (
        8 * SEQ_LEN + 32, 0)
    monkeypatch.setattr(engine_mod, "FOLD_MIN_CROPS", 48)
    one, many, full = _counts(teng, CALLS)
    assert (one["assoc.crops"], one["assoc.mem_folded"]) == (
        4 * SEQ_LEN + 8, 0)
    assert many["assoc.crops"] == 48
    assert many["assoc.mem_folded"] == 8 * SEQ_LEN - (3 * SEQ_LEN + 2)
    assert (full["assoc.crops"], full["assoc.mem_folded"]) == (64, 0)


@pytest.mark.parametrize("mode", MODES)
def test_masking_rows_at_the_model_call_moves_the_statistics(shared, mode,
                                                              fold_all):
    """The memory units' BN weights come from the lane mask the model call
    takes, so masking the last half of the live rows there (the harness's
    ``half_batch`` fault) changes the first half's probabilities, in one
    request and in a grouped call."""
    _, teng = _engines(shared, mode)
    _, cut = _engines(shared, mode)
    orig = cut._probs

    def probs(mem, can, mem_boxes, can_boxes, mask, *a, **kw):
        mask = mask.copy()
        live = mask.nonzero()[0]
        mask[live[(len(live) + 1) // 2:]] = 0.0
        return orig(mem, can, mem_boxes, can_boxes, mask, *a, **kw)

    cut._probs = probs
    seed, lens = ONE[1]
    req = _request(seed, lens)
    (p, _), (q, _) = _associate(teng, req), _associate(cut, req)
    kept = (len(lens) + 1) // 2
    assert np.abs(p[:kept] - q[:kept]).max() > 1e-4
    # the first request's last row and the second request are masked
    requests = [_request(11, [SEQ_LEN, 2, 3, SEQ_LEN + 1]),
                _request(12, [3])]
    a = teng.associate_many(requests, **KW)
    b = cut.associate_many(requests, **KW)
    assert np.abs(a[0][0][:3] - b[0][0][:3]).max() > 1e-4
