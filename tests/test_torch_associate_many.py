"""The port's multi-request association (``AssociationEngine.associate_many``
and ``BuscaModel``'s per-request BN groups) on the CPU.

Tolerances: against the port's own per-request ``associate``, ``reliable``
equal and probabilities within rtol 2e-4, atol 2e-6 (busca_tpu's bound in
tests/test_engine.py for the same cases: the grouped BN sums each group's
statistics in another order); against busca_tpu's ``associate_many`` with
the weights carried over, 1e-4 (tests/test_torch_engine.py's bound for
``associate``).  With one group the model's ReID input is bit for bit the
two-group mask it took before groups existed.
"""

import numpy as np
import pytest
import torch

from busca_tpu.trackers.base import ThirdRoundRequest as JRequest
from busca_tpu.trackers.base import run_third_round_many as j_many
from busca_tpu_torch.trackers.base import (
    ThirdRoundRequest,
    Track,
    run_third_round,
    run_third_round_many,
    service_deferred_updates,
)
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

RTOL, ATOL = 2e-4, 2e-6  # busca_tpu's bound, tests/test_engine.py:241-298
JAX_TOL = 1e-4
MODES = ["unbanked", "banked"]


def _request(seed, n_tracks, n_dets, kal_score=0.1):
    """tests/test_engine.py's ``make_req``: tracks with full memories, a
    shared detection pool, a Kalman candidate per track."""
    r = np.random.RandomState(seed)
    tracks = [_track(r, SEQ_LEN + i, (40 + 25 * i, 60))
              for i in range(n_tracks)]
    dets = [_det(r, (50 + 20 * j, 60)) for j in range(n_dets)]
    kal = [Track(t.tlwh, kal_score,
                 r.randint(0, 255, (H, W, 3), np.uint8), 1.0)
           for t in tracks]
    return (tracks, dets, None, kal)


def _single(seed):
    """tests/test_engine.py's five-request case: one track, one det."""
    r = np.random.RandomState(seed)
    tracks = [_track(r, SEQ_LEN + 1, (40 + 7 * seed, 60))]
    dets = [_det(r, (50 + 5 * seed, 60))]
    kal = [Track(tracks[0].tlwh, 0.1,
                 r.randint(0, 255, (H, W, 3), np.uint8), 1.0)]
    return (tracks, dets, None, kal)


CASES = {
    "three_with_empty": lambda: [_request(1, 2, 2), ([], [], None, []),
                                 _request(2, 1, 3)],
    "five_padded_to_8": lambda: [_single(s) for s in range(5)],
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mode", MODES)
def test_associate_many_matches_associate(shared, mode, case):
    _, teng = _engines(shared, mode)
    requests = CASES[case]()
    kw = dict(select_highest_candidate=False)
    batched = teng.associate_many(requests, **kw)
    assert len(batched) == len(requests)
    for (tracks, dets, _, kal), (p_b, r_b) in zip(requests, batched):
        if not tracks:
            assert (p_b, r_b) == (None, None)
            continue
        p_s, r_s = teng.associate(tracks, dets, extra_kalman_candidates=kal,
                                  **kw)
        np.testing.assert_array_equal(r_b, r_s)
        assert p_b.shape == p_s.shape
        np.testing.assert_allclose(p_b, p_s, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mode", MODES)
def test_associate_many_matches_jax(shared, mode, case):
    jeng, teng = _engines(shared, mode)
    requests = CASES[case]()
    for kw in (dict(select_highest_candidate=False),
               dict(select_highest_candidate=True)):
        want = jeng.associate_many(requests, **kw)
        got = teng.associate_many(requests, **kw)
        for (p_w, r_w), (p_g, r_g) in zip(want, got):
            if p_w is None:
                assert p_g is None and r_g is None
                continue
            np.testing.assert_array_equal(r_g, r_w)
            np.testing.assert_allclose(p_g, p_w, rtol=0, atol=JAX_TOL)


def test_banked_associate_many_equals_unbanked(shared):
    """tests/test_bank.py::test_banked_associate_many_parity: the banked
    grouped scorer gathers the same uint8 crops from the bank."""
    _, unbanked = _engines(shared, "unbanked")
    _, banked = _engines(shared, "banked")
    requests = [_request(s, 2, 2, 0.10000001) for s in (21, 22, 23)]
    a = unbanked.associate_many(requests, select_highest_candidate=False)
    b = banked.associate_many(requests, select_highest_candidate=False)
    for (p1, r1), (p2, r2) in zip(a, b):
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(p1, p2)


def test_associate_many_serves_one_by_one_where_busca_tpu_does(shared):
    """One live request, more tracks than the largest bucket, or the
    duplicated path: each request is scored alone (no grouped call)."""
    _, teng = _engines(shared, "unbanked")
    calls = []
    orig = teng._score_grouped
    teng._score_grouped = lambda *a: calls.append(1) or orig(*a)
    teng.associate_many([_request(1, 2, 2), ([], [], None, [])])
    teng.associate_many([_request(s, 3, 2) for s in range(3)])  # 9 > 8
    assert not calls
    teng.associate_many([_request(1, 1, 1), _request(2, 1, 1)])
    assert calls == [1]
    _, dup = _engines(shared, "duplicated")
    dup._score_grouped = None  # must not be reached
    requests = [_request(1, 2, 2), _request(2, 1, 3)]
    got = dup.associate_many(requests, select_highest_candidate=False)
    for (tracks, dets, _, kal), (p_b, _) in zip(requests, got):
        p_s, _ = dup.associate(tracks, dets, extra_kalman_candidates=kal,
                               select_highest_candidate=False)
        np.testing.assert_array_equal(p_b, p_s)


def _model_inputs(seed, b=2, l_mem=SEQ_LEN, c=3, u=4):
    g = torch.Generator().manual_seed(seed)
    return dict(
        mem_crops=torch.randn(b, l_mem, H, W, 3, generator=g),
        can_crops=torch.randn(u, H, W, 3, generator=g),
        mem_bboxes=torch.rand(b, l_mem, 4, generator=g) * 100,
        can_bboxes=torch.rand(b, c, 4, generator=g) * 100,
        sample_mask=torch.tensor([1.0] * (b - 1) + [0.0]),
        can_weights=torch.tensor([1.0, 2.0, 3.0, 1.0]),
        can_gather=torch.randint(0, u, (b, c), generator=g),
    )


def test_one_group_is_bit_equal_to_the_two_column_mask(shared):
    """``num_groups=1`` (with or without explicit zero groups) hands the
    ReID the same [N, 2] mask as before groups existed: memory rows in
    column 0, candidate rows in column 1, zero rows for padded lanes; the
    logits are bit equal."""
    _, _, model = shared
    inputs = _model_inputs(3)
    masks = []
    hook = model.reid_encoder.model.register_forward_pre_hook(
        lambda _m, args: masks.append(args[1].clone()))
    try:
        with torch.no_grad():
            plain = model(**inputs)
            grouped = model(**inputs,
                            mem_group=torch.zeros(2, dtype=torch.long),
                            can_group=torch.zeros(4, dtype=torch.long),
                            num_groups=1)
    finally:
        hook.remove()
    n_mem = 2 * SEQ_LEN
    want = torch.zeros(n_mem + 4, 2)
    want[:n_mem, 0] = inputs["sample_mask"].repeat_interleave(SEQ_LEN)
    want[n_mem:, 1] = inputs["can_weights"]
    for mask in masks:
        assert torch.equal(mask, want)
    assert torch.equal(plain, grouped)


def test_groups_keep_each_request_alone(shared):
    """Two requests concatenated with their groups give each request's
    logits alone, and the mask puts request r's candidates in column
    ``num_groups + r``."""
    _, _, model = shared
    a, b = _model_inputs(5, b=1, u=4), _model_inputs(6, b=1, u=4)
    for x in (a, b):
        x["sample_mask"] = torch.ones(1)
    cat = {k: torch.cat([a[k], b[k]]) for k in a if k != "can_gather"}
    cat["can_gather"] = torch.cat([a["can_gather"], b["can_gather"] + 4])
    masks = []
    hook = model.reid_encoder.model.register_forward_pre_hook(
        lambda _m, args: masks.append(args[1].clone()))
    try:
        with torch.no_grad():
            alone = [model(**x) for x in (a, b)]
            both = model(**cat, mem_group=torch.tensor([0, 1]),
                         can_group=torch.tensor([0] * 4 + [1] * 4),
                         num_groups=2)
    finally:
        hook.remove()
    mask = masks[-1]
    assert mask.shape == (2 * SEQ_LEN + 8, 4)
    assert torch.equal(mask[SEQ_LEN:2 * SEQ_LEN, 1], torch.ones(SEQ_LEN))
    assert torch.equal(mask[2 * SEQ_LEN + 4:, 3], b["can_weights"])
    np.testing.assert_allclose(both.numpy(), torch.cat(alone).numpy(),
                               rtol=RTOL, atol=1e-5)


class _CountingEngine:
    """A stand-in engine that records ``associate_many`` batches."""

    def __init__(self, engine):
        self.engine, self.batches = engine, []
        self.center_distances = engine.center_distances
        self.associate = engine.associate

    def associate_many(self, requests, **kw):
        self.batches.append(len(requests))
        return self.engine.associate_many(requests, **kw)


def _third_round_request(seed, engine, thresh=0.1, n_tracks=1):
    tracks, dets, _, kal = _request(seed, n_tracks, 2)
    return ThirdRoundRequest(tracks, dets, kal, thresh,
                             dict(select_highest_candidate=False), engine)


def test_run_third_round_many_matches_run_third_round(shared):
    """One batched association for the live requests; a disabled
    threshold or an empty pool never reaches the engine; each result
    equals the request's own ``run_third_round`` and busca_tpu's
    ``run_third_round_many`` on the same requests."""
    jeng, teng = _engines(shared, "unbanked")
    counting = _CountingEngine(teng)
    reqs = [_third_round_request(1, counting),
            _third_round_request(2, counting, thresh=0.0),
            ThirdRoundRequest([], [], [], 0.1,
                              dict(select_highest_candidate=False), counting),
            _third_round_request(3, counting, n_tracks=2)]
    got = run_third_round_many(counting, reqs)
    assert counting.batches == [2]
    want = j_many(jeng, [JRequest(r.pool, r.considered, r.kalman_cands,
                                  r.thresh, r.engine_kwargs, jeng)
                         for r in reqs])
    for r, (matches, u_track), (w_m, w_u) in zip(reqs, got, want):
        solo = run_third_round(teng, r.pool, r.considered, r.kalman_cands,
                               r.thresh, **r.engine_kwargs)
        assert [m[0] for m in matches] == [m[0] for m in solo[0]] \
            == [m[0] for m in w_m]
        assert u_track == solo[1] == w_u
        np.testing.assert_allclose([m[1] for m in matches],
                                   [m[1] for m in solo[0]],
                                   rtol=RTOL, atol=ATOL)
    bad = _third_round_request(4, counting)
    bad.engine_kwargs = dict(select_highest_candidate=True)
    with pytest.raises(ValueError, match="uniform engine kwargs"):
        run_third_round_many(counting, reqs[:1] + [bad])


def test_service_deferred_updates_drives_generators_to_the_end(shared):
    """Requests are grouped by engine; each result goes back into its
    generator, and a follow-up yield is served on its own."""
    _, teng = _engines(shared, "unbanked")
    _, other = _engines(shared, "unbanked")
    counting = [_CountingEngine(teng), _CountingEngine(other)]
    seen = {}

    def gen(key, engine, twice=False):
        res = yield _third_round_request(key, engine)
        seen[key] = [res]
        if twice:
            seen[key].append((yield _third_round_request(key + 10, engine)))
        return f"out{key}"

    pending = []
    for key, engine, twice in ((1, counting[0], False),
                               (2, counting[0], True),
                               (3, counting[1], False)):
        g = gen(key, engine, twice)
        pending.append((key, g, next(g)))
    outs = service_deferred_updates(pending)
    assert outs == {1: "out1", 2: "out2", 3: "out3"}
    assert counting[0].batches == [2] and counting[1].batches == [1]
    assert len(seen[2]) == 2
