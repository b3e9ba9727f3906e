"""The port's association engine, host math and assignment against
busca_tpu on the CPU.

Tolerances: probabilities to 1e-4 (float32 ReID and Transformer in two
libraries, shared weights through the weight bridge); reliability flags,
one-hot decisions, host geometry, Kalman math and assignments exactly (the
same float64 numpy code and the same LAPJV source).
"""

import jax
import numpy as np
import pytest
import torch

from busca_tpu.assoc.bank import DeviceCropBank as JBank
from busca_tpu.assoc.engine import AssociationEngine as JEngine
from busca_tpu.core import hostmath as jhm
from busca_tpu.models.busca import BuscaConfig as JCfg
from busca_tpu.models.busca import BuscaModel as JModel
from busca_tpu.ops import lap as jlap
from busca_tpu_torch.assoc.bank import DeviceCropBank
from busca_tpu_torch.assoc.engine import AssociationEngine
from busca_tpu_torch.core import hostmath as thm
from busca_tpu_torch.models.busca import BuscaConfig, BuscaModel
from busca_tpu_torch.models.convert import load_into, state_dict_from_flax
from busca_tpu_torch.ops import lap as tlap
from busca_tpu_torch.trackers.base import Track

H, W = 64, 32
SEQ_LEN, NUM_CAN = 5, 3
SMALL = dict(num_layer=2, nhead=4, trans_dim=64, ff_size=128,
             reid_layers=(1, 1, 1, 1), reid_num_classes=7)
BUCKETS = (1, 2, 4, 8)


@pytest.fixture(scope="module")
def shared():
    cfg = JCfg(**SMALL)
    variables = jax.jit(JModel(cfg).init)(
        jax.random.PRNGKey(0),
        np.zeros((1, SEQ_LEN, H, W, 3), np.float32),
        np.zeros((1, NUM_CAN, H, W, 3), np.float32),
        np.zeros((1, SEQ_LEN, 4), np.float32),
        np.zeros((1, NUM_CAN, 4), np.float32),
    )
    variables = jax.tree_util.tree_map(np.asarray, variables)
    model = BuscaModel(BuscaConfig(**SMALL))
    load_into(model, state_dict_from_flax(variables))
    return cfg, variables, model


def _track(rng, n_mem, xy):
    t = Track(np.array([xy[0], xy[1], 30, 60], np.float64), 0.9,
              image=rng.randint(0, 255, (H, W, 3), dtype=np.uint8))
    for i in range(n_mem - 1):
        t.images_mem.append(rng.randint(0, 255, (H, W, 3), dtype=np.uint8))
        t.tlwh_mem.append(np.array([xy[0] + 2 * i, xy[1], 30, 60], np.float64))
    t.activate(1)
    return t


def _det(rng, xy, score=0.8):
    return Track(np.array([xy[0], xy[1], 30, 60], np.float64), score,
                 image=rng.randint(0, 255, (H, W, 3), dtype=np.uint8))


def _scene(seed):
    rng = np.random.RandomState(seed)
    tracks = [_track(rng, 7, (50, 60)), _track(rng, 5, (150, 40)),
              _track(rng, 2, (90, 120))]  # the last memory is incomplete
    dets = [_det(rng, (52 + 5 * i, 61 + 3 * i)) for i in range(4)]
    kals = [_det(rng, tuple(t.tlwh[:2]), 0.10000001) for t in tracks]
    return tracks, dets, kals


def _engines(shared, mode):
    cfg, variables, model = shared
    kw = dict(seq_len=SEQ_LEN, num_candidates=NUM_CAN, crop_hw=(H, W),
              buckets=BUCKETS, dedup_candidates=mode != "duplicated")
    jbank = JBank((H, W), 64) if mode == "banked" else None
    tbank = DeviceCropBank((H, W), 64, "cpu") if mode == "banked" else None
    return (JEngine(cfg, {"params": variables["params"]}, bank=jbank, **kw),
            AssociationEngine(BuscaConfig(**SMALL), model, bank=tbank, **kw))


@pytest.mark.parametrize("mode", ["unbanked", "banked", "duplicated"])
def test_associate_matches_jax(shared, mode):
    jeng, teng = _engines(shared, mode)
    assert teng.banked == (mode == "banked")
    for seed in (0, 1):
        tracks, dets, kals = _scene(seed)
        for kw in (dict(select_highest_candidate=False),
                   dict(select_highest_candidate=True)):
            want, wrel = jeng.associate(tracks, dets,
                                        extra_kalman_candidates=kals, **kw)
            got, grel = teng.associate(tracks, dets,
                                       extra_kalman_candidates=kals, **kw)
            np.testing.assert_array_equal(grel, wrel)
            assert got.shape == want.shape == (3, 4 + 3)
            atol = 1e-4 if not kw["select_highest_candidate"] else 0.0
            np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_associate_without_kalman_and_empty(shared):
    jeng, teng = _engines(shared, "unbanked")
    tracks, dets, _ = _scene(2)
    want, _ = jeng.associate(tracks, dets[:2],
                             select_highest_candidate=False)
    got, _ = teng.associate(tracks, dets[:2], select_highest_candidate=False)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert teng.associate([], dets) == (None, None)
    assert teng.associate(tracks, []) == (None, None)


def test_engine_raises_for_unported_modes(shared, tmp_path):
    """Every mode of busca_tpu's engine is ported: the debug montage
    writes one decision montage per scored call, each call scored through
    the duplicated path (busca_tpu's routing), with busca_tpu's numbers
    (1e-4, as above); frozen modes refuse it as busca_tpu's do.
    ``reid_stats='frozen'`` and ``'auto'`` (tests/test_torch_engine_frozen.py):
    a frozen-BN model with the same weights scores through them, a
    batch-statistics one is refused."""
    cfg, variables, model = shared
    debug = tmp_path / "montage"
    eng = AssociationEngine(BuscaConfig(**SMALL), model, seq_len=SEQ_LEN,
                            num_candidates=NUM_CAN, crop_hw=(H, W),
                            buckets=BUCKETS, debug_dir=str(debug),
                            bank=DeviceCropBank((H, W), 64, "cpu"))
    assert not eng.banked  # the montage needs the pixels on the host
    jeng = JEngine(cfg, {"params": variables["params"]}, seq_len=SEQ_LEN,
                   num_candidates=NUM_CAN, crop_hw=(H, W), buckets=BUCKETS)
    for seed in (0, 1):
        tracks, dets, kals = _scene(seed)
        got, _ = eng.associate(tracks, dets, extra_kalman_candidates=kals,
                               select_highest_candidate=False)
        want, _ = jeng.associate(tracks, dets, extra_kalman_candidates=kals,
                                 select_highest_candidate=False)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # associate_many routes each request through the montage's path too
    tracks, dets, kals = _scene(2)
    eng.associate_many([(tracks, dets, None, kals), (tracks, dets, None,
                                                     kals)])
    assert sorted(p.name for p in debug.iterdir()) == [
        f"decision_{i:06d}.jpg" for i in range(4)]
    frozen = BuscaModel(BuscaConfig(reid_use_batch_stats=False, **SMALL))
    frozen.load_state_dict(model.state_dict())
    tracks, dets, kals = _scene(0)
    for mode in ("frozen", "auto"):
        with pytest.raises(ValueError, match="batch_stats"):
            AssociationEngine(BuscaConfig(**SMALL), model, reid_stats=mode)
        with pytest.raises(ValueError, match="decision montage"):
            AssociationEngine(BuscaConfig(**SMALL), frozen, reid_stats=mode,
                              debug_dir=str(debug))
        eng = AssociationEngine(BuscaConfig(**SMALL), frozen,
                                seq_len=SEQ_LEN, num_candidates=NUM_CAN,
                                crop_hw=(H, W), buckets=BUCKETS,
                                reid_stats=mode)
        probs, rel = eng.associate(tracks, dets,
                                   extra_kalman_candidates=kals,
                                   select_highest_candidate=False)
        assert probs.shape == (3, 4 + 3) and np.isfinite(probs).all()
        assert rel.tolist() == [True, True, False]
    # associate_many is ported (lockstep): no request and empty requests
    # give nothing to score
    eng = AssociationEngine(BuscaConfig(**SMALL), model, crop_hw=(H, W))
    assert eng.associate_many([]) == []
    assert eng.associate_many([([], [], None, [])]) == [(None, None)]


def test_bank_lru_pinning_and_zero_slot():
    from busca_tpu_torch.assoc.bank import next_uid, tag

    rng = np.random.RandomState(3)
    bank = DeviceCropBank((4, 2), 4, "cpu")
    crops = [tag(rng.randint(1, 255, (4, 2, 3), dtype=np.uint8), next_uid())
             for _ in range(5)]
    slots = bank.resolve([None] + crops[:3])
    assert slots[0] == 0 and sorted(slots[1:]) == [1, 2, 3]
    assert not bank.array[0].any()
    for s, c in zip(slots[1:], crops[:3]):
        np.testing.assert_array_equal(bank.array[int(s)].numpy(), c)
    # resident uids hit the cache
    np.testing.assert_array_equal(bank.resolve(crops[:3]), slots[1:])
    # a fourth crop evicts the least recently used one (crops[0])
    bank.resolve(crops[1:3])
    s4 = bank.resolve([crops[3]])[0]
    assert s4 == slots[1] and len(bank) == 3
    np.testing.assert_array_equal(bank.array[int(s4)].numpy(), crops[3])
    # more distinct crops than slots in one call: refused and rolled back
    with pytest.raises(RuntimeError, match="exhausted"):
        bank.resolve([crops[0], crops[4]] + crops[1:3])
    assert not bank.array[0].any()
    uids = bank.put_device(torch.zeros(2, 4, 2, 3), 1)
    assert len(uids) == 1


# ---------------------------------------------------------------- hostmath --

def _boxes(rng, n):
    xy = rng.uniform(0, 200, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(1, 80, (n, 2))], 1)


def test_hostmath_matches_exactly():
    rng = np.random.RandomState(4)
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    scores = rng.uniform(0, 1, 5)
    for name in ("iou_matrix", "iou_matrix_std", "iou_distance",
                 "center_distance", "tlwh_to_tlbr", "tlbr_to_tlwh",
                 "tlwh_to_xyah", "xyah_to_tlwh"):
        fa, fb = getattr(jhm, name), getattr(thm, name)
        args = (a, b) if name in ("iou_matrix", "iou_matrix_std",
                                  "iou_distance", "center_distance") else (a,)
        np.testing.assert_array_equal(fb(*args), fa(*args), err_msg=name)
    np.testing.assert_array_equal(thm.center_distance(a, b, True),
                                  jhm.center_distance(a, b, True))
    cost = thm.iou_distance(a, b)
    np.testing.assert_array_equal(thm.fuse_score(cost, scores),
                                  jhm.fuse_score(cost, scores))
    assert thm.CHI2INV95 == jhm.CHI2INV95
    assert thm.iou_matrix(np.zeros((0, 4)), b).shape == (0, 5)


def test_host_kalman_matches_exactly():
    rng = np.random.RandomState(5)
    jk, tk = jhm.HostKalman(), thm.HostKalman()
    z = thm.tlwh_to_xyah(np.concatenate(
        [rng.uniform(0, 200, (6, 2)), rng.uniform(10, 80, (6, 2))], 1))
    m_j, c_j = jk.initiate(z)
    m_t, c_t = tk.initiate(z)
    np.testing.assert_array_equal(m_t, m_j)
    np.testing.assert_array_equal(c_t, c_j)
    m_j, c_j = jk.predict(m_j, c_j)
    m_t, c_t = tk.predict(m_t, c_t)
    np.testing.assert_array_equal(m_t, m_j)
    np.testing.assert_array_equal(c_t, c_j)
    z2 = z + rng.randn(*z.shape)
    conf = rng.uniform(0, 1, 6)
    for args in ((z2,), (z2, conf)):
        a = jk.update(m_j, c_j, *args)
        b = tk.update(m_t, c_t, *args)
        np.testing.assert_array_equal(b[0], a[0])
        np.testing.assert_array_equal(b[1], a[1])
    for metric in ("maha", "gaussian"):
        for only_position in (False, True):
            np.testing.assert_array_equal(
                tk.gating_distance(m_t, c_t, z2, only_position, metric),
                jk.gating_distance(m_j, c_j, z2, only_position, metric),
            )


# --------------------------------------------------------------------- lap --

@pytest.mark.parametrize("seed", range(4))
def test_lap_matches_exactly(seed):
    rng = np.random.RandomState(seed)
    n, m = rng.randint(1, 9), rng.randint(1, 9)
    cost = rng.uniform(0, 1, (n, m))
    cost[rng.uniform(0, 1, (n, m)) < 0.2] = np.inf
    for limit in (0.5, 0.9, np.inf):
        if np.isinf(limit):
            finite = np.where(np.isfinite(cost), cost, 5.0)
            a, b = jlap.lapjv(finite, cost_limit=limit), \
                tlap.lapjv(finite, cost_limit=limit)
        else:
            a, b = jlap.lapjv(cost, cost_limit=limit), \
                tlap.lapjv(cost, cost_limit=limit)
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
    for x, y in zip(jlap.linear_assignment(cost, 0.7),
                    tlap.linear_assignment(cost, 0.7)):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(jlap.solve_dense(cost), tlap.solve_dense(cost)):
        np.testing.assert_array_equal(x, y)


def test_lap_builds_into_the_port_build_dir():
    assert tlap._load_native() is not None
    assert "busca_tpu_torch" in tlap._LIB_PATH
