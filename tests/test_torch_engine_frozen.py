"""The port's frozen-stats ReID modes (``reid_stats='frozen'|'auto'``)
against busca_tpu's, on the CPU.

Every case of tests/test_engine_frozen.py has its counterpart here, at
busca_tpu's own bounds: the feature path equals the crops path at frozen
BN (2e-5), warmth, capacity and eviction change nothing (1e-6, warm = cold
exactly), the device feature bank equals the host cache (1e-6), a call
that exhausts the bank raises and a failed call rolls back, batched
requests equal single calls (1e-5), and auto equals frozen on both sides of
its crossover (2e-5) while routing by the track count.  The port's
probabilities are held against busca_tpu's engine at shared weights and
running statistics at the batch-mode engine tests' bounds
(tests/test_torch_engine.py: 1e-4 raw, one-hot decisions exactly), and a
frozen stream restored from a snapshot equals the unbroken one.
"""

import jax
import numpy as np
import pytest
import torch

from busca_tpu.assoc.engine import AssociationEngine as JEngine
from busca_tpu.models.busca import BuscaConfig as JCfg
from busca_tpu.models.busca import BuscaModel as JModel
from busca_tpu.models.reid import ReIDResNet as JReID
from busca_tpu_torch.assoc.bank import next_uid, tag
from busca_tpu_torch.assoc.engine import AssociationEngine
from busca_tpu_torch.models.busca import BuscaConfig, BuscaModel
from busca_tpu_torch.models.convert import load_into, state_dict_from_flax
from busca_tpu_torch.trackers.base import Track
from test_torch_strongsort import one_torch_thread  # noqa: F401

H, W = 96, 32
SEQ_LEN, NUM_CAN = 5, 3
TINY = dict(num_layer=1, reid_num_classes=5, reid_layers=(1, 1, 1, 1))
PROB_TOL = 1e-4  # port vs busca_tpu, raw probabilities


def _jax_variables():
    """tests/test_engine_frozen.py's variables: the frozen-config init with
    non-trivial running statistics."""
    cfg = JCfg(reid_use_batch_stats=False, **TINY)
    variables = jax.jit(JModel(cfg).init)(
        jax.random.PRNGKey(0),
        np.zeros((1, SEQ_LEN, H, W, 3), np.float32),
        np.zeros((1, NUM_CAN, H, W, 3), np.float32),
        np.tile(np.array([0, 0, 10, 10], np.float32), (1, SEQ_LEN, 1)),
        np.tile(np.array([0, 0, 10, 10], np.float32), (1, NUM_CAN, 1)),
    )
    rng = np.random.RandomState(3)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: (
            np.abs(rng.randn(*x.shape)).astype(np.float32) + 0.5
            if "running_var" in str(path)
            else (rng.randn(*x.shape).astype(np.float32) * 0.1
                  if "running_mean" in str(path) else np.asarray(x))),
        variables)


@pytest.fixture(scope="module", name="setup")
def _setup():
    variables = _jax_variables()
    model = BuscaModel(BuscaConfig(reid_use_batch_stats=False, **TINY))
    load_into(model, state_dict_from_flax(variables))
    return variables, model


def _engine(setup, reid_stats="frozen", **kw):
    _, model = setup
    return AssociationEngine(
        BuscaConfig(**TINY), model, seq_len=SEQ_LEN, num_candidates=NUM_CAN,
        crop_hw=(H, W), buckets=(1, 2, 4, 8), reid_stats=reid_stats, **kw)


def _jengine(setup, reid_stats="frozen", **kw):
    variables, _ = setup
    return JEngine(
        JCfg(**TINY), variables, seq_len=SEQ_LEN, num_candidates=NUM_CAN,
        crop_hw=(H, W), buckets=(1, 2, 4, 8), reid_stats=reid_stats, **kw)


def _tagged_crop(rng):
    return tag(rng.randint(0, 255, (H, W, 3), dtype=np.uint8), next_uid())


def _track(rng, n_mem, base_xy=(50, 60)):
    t = Track(np.array([base_xy[0], base_xy[1], 30, 60], np.float64), 0.9,
              image=_tagged_crop(rng))
    for i in range(n_mem - 1):
        t.images_mem.append(_tagged_crop(rng))
        t.tlwh_mem.append(
            np.array([base_xy[0] + 2 * i, base_xy[1], 30, 60], np.float64))
    t.activate(1)
    return t


def _scene(rng, n_tracks=3, n_dets=4):
    """tests/test_engine_frozen.py's scene: the last track's memory is
    incomplete; one Kalman candidate per track."""
    tracks = [_track(rng, SEQ_LEN + 1 + i, base_xy=(40 + 30 * i, 60))
              for i in range(n_tracks)]
    tracks[-1] = _track(rng, 2, base_xy=(160, 60))
    dets = [Track(np.array([45 + 28 * i, 62, 30, 60], np.float64), 0.8,
                  image=_tagged_crop(rng)) for i in range(n_dets)]
    kal = [Track(t.tlwh, 0.10000001, _tagged_crop(rng)) for t in tracks]
    return tracks, dets, kal


def _count_encodes(eng, calls):
    """Each device encode (the bank's encode + scatter, or the host cache's
    encode) appends its batch size to ``calls``."""
    name = "_encode_scatter" if eng._feat_bank else "_encode"
    inner = getattr(eng, name)

    def wrapped(crops, *a):
        calls.append(len(crops))
        return inner(crops, *a)

    setattr(eng, name, wrapped)


@pytest.mark.parametrize("reid_stats", ["frozen", "auto"])
def test_frozen_refuses_a_batch_stats_model(setup, reid_stats):
    """busca_tpu refuses frozen modes without ``batch_stats``; the port
    refuses a model whose BatchNorm computes batch statistics (it never
    flips the BN mode of a module a batch engine may share), and leaves
    the module as it was."""
    model = BuscaModel(BuscaConfig(**TINY))
    with pytest.raises(ValueError, match="batch_stats"):
        AssociationEngine(BuscaConfig(**TINY), model, crop_hw=(H, W),
                          reid_stats=reid_stats)
    assert model.config.reid_use_batch_stats
    assert model.reid_encoder.model.bn1.use_batch_stats
    with pytest.raises(ValueError, match="reid_stats must be"):
        _engine(setup, reid_stats="running")


def test_model_feats_path_matches_crops_path(setup):
    """Precomputed frozen features reproduce the crops-path forward (2e-5);
    the frozen features equal busca_tpu's (1e-5) and so do the feature
    path's probabilities (1e-4)."""
    variables, model = setup
    rng = np.random.RandomState(11)
    b = 2
    mem = rng.rand(b, SEQ_LEN, H, W, 3).astype(np.float32)
    can = rng.rand(b, NUM_CAN, H, W, 3).astype(np.float32)
    mem_boxes = rng.uniform(0, 200, (b, SEQ_LEN, 4)).astype(np.float32)
    can_boxes = rng.uniform(0, 200, (b, NUM_CAN, 4)).astype(np.float32)
    mem_boxes[..., 2:] += 220
    can_boxes[..., 2:] += 220
    t = torch.from_numpy
    with torch.no_grad():
        crops_path = model(t(mem), t(can), t(mem_boxes), t(can_boxes))
        reid = model.reid_encoder.model
        _, mf = reid(t(mem.reshape(-1, H, W, 3)))
        _, cf = reid(t(can.reshape(-1, H, W, 3)))
        feats_path = model(None, None, t(mem_boxes), t(can_boxes),
                           mem_feats=mf.reshape(b, SEQ_LEN, -1),
                           can_feats=cf.reshape(b, NUM_CAN, -1))
        with pytest.raises(ValueError, match="together"):
            model(None, None, t(mem_boxes), t(can_boxes),
                  mem_feats=mf.reshape(b, SEQ_LEN, -1))
    np.testing.assert_allclose(feats_path.numpy(), crops_path.numpy(),
                               rtol=0, atol=2e-5)
    jreid = JReID(layers=TINY["reid_layers"],
                  num_classes=TINY["reid_num_classes"], use_batch_stats=False)
    rv = {"params": variables["params"]["reid_encoder"],
          "batch_stats": variables["batch_stats"]["reid_encoder"]}
    _, jmf = jax.jit(jreid.apply)(rv, mem.reshape(-1, H, W, 3))
    _, jcf = jax.jit(jreid.apply)(rv, can.reshape(-1, H, W, 3))
    np.testing.assert_allclose(mf.numpy(), np.asarray(jmf), rtol=0,
                               atol=1e-5)
    jmodel = JModel(JCfg(reid_use_batch_stats=False, **TINY))
    want = jax.jit(lambda v, mb, cb, mf, cf: jmodel.apply(
        v, None, None, mb, cb, mem_feats=mf, can_feats=cf))(
        variables, mem_boxes, can_boxes,
        np.asarray(jmf).reshape(b, SEQ_LEN, -1),
        np.asarray(jcf).reshape(b, NUM_CAN, -1))
    np.testing.assert_allclose(
        torch.softmax(feats_path, -1).numpy(),
        np.asarray(jax.nn.softmax(want, -1)), rtol=0, atol=PROB_TOL)


@pytest.mark.parametrize("reid_stats,feat_bank", [
    ("frozen", True), ("frozen", False), ("auto", True)])
def test_frozen_associate_matches_jax(setup, reid_stats, feat_bank):
    """The port's frozen and auto probabilities equal busca_tpu's, raw and
    one-hot, on cold and warm caches (auto below its crossover takes the
    fused forward at T=1)."""
    rng = np.random.RandomState(31)
    scenes = [_scene(rng), _scene(rng, n_tracks=1, n_dets=2)]
    jeng = _jengine(setup, reid_stats, feat_bank=feat_bank)
    teng = _engine(setup, reid_stats, feat_bank=feat_bank)
    for tracks, dets, kal in scenes + scenes:
        for sel in (False, True):
            kw = dict(extra_kalman_candidates=kal,
                      select_highest_candidate=sel)
            want, wrel = jeng.associate(tracks, dets, **kw)
            got, grel = teng.associate(tracks, dets, **kw)
            np.testing.assert_array_equal(grel, wrel)
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=0.0 if sel else PROB_TOL)


@pytest.mark.parametrize("reid_stats", ["frozen", "auto"])
def test_frozen_associate_many_matches_jax(setup, reid_stats):
    """``associate_many`` in frozen and auto modes against busca_tpu's, on
    both sides of auto's crossover (3)."""
    rng = np.random.RandomState(32)
    small = [_scene(rng, n_tracks=1, n_dets=2) for _ in range(2)]
    large = [_scene(rng, n_tracks=3, n_dets=3) for _ in range(2)]
    jeng = _jengine(setup, reid_stats, auto_fused_max_t=3)
    teng = _engine(setup, reid_stats, auto_fused_max_t=3)
    for scenes in (small, large):
        reqs = [(t, d, None, k) for t, d, k in scenes]
        kw = dict(select_highest_candidate=False)
        for (pw, rw), (pg, rg) in zip(jeng.associate_many(reqs, **kw),
                                      teng.associate_many(reqs, **kw)):
            np.testing.assert_array_equal(rg, rw)
            np.testing.assert_allclose(pg, pw, rtol=0, atol=PROB_TOL)


@pytest.mark.parametrize("feat_bank", [True, False])
def test_frozen_cache_warmth_invariance(setup, feat_bank):
    """A request scored cold and warm gives the same numbers exactly, and
    the warm call encodes nothing."""
    tracks, dets, kal = _scene(np.random.RandomState(5))
    eng = _engine(setup, feat_bank=feat_bank)
    calls = []
    _count_encodes(eng, calls)
    kw = dict(extra_kalman_candidates=kal, select_highest_candidate=False)
    cold, rel_cold = eng.associate(tracks, dets, **kw)
    n_cold = len(calls)
    assert n_cold > 0
    warm, rel_warm = eng.associate(tracks, dets, **kw)
    assert len(calls) == n_cold
    np.testing.assert_array_equal(warm, cold)
    np.testing.assert_array_equal(rel_warm, rel_cold)


def test_frozen_cache_eviction_invariance(setup):
    """A 2-slot host cache (constant eviction) scores as the default one."""
    tracks, dets, kal = _scene(np.random.RandomState(6))
    big = _engine(setup, feat_bank=False)
    tiny = _engine(setup, feat_cache_slots=2, feat_bank=False)
    kw = dict(extra_kalman_candidates=kal, select_highest_candidate=False)
    p_big, _ = big.associate(tracks, dets, **kw)
    p_big2, _ = big.associate(tracks, dets, **kw)
    p_tiny, _ = tiny.associate(tracks, dets, **kw)
    p_tiny2, _ = tiny.associate(tracks, dets, **kw)
    assert len(tiny._feat_cache) == 2
    np.testing.assert_allclose(p_tiny, p_big, rtol=0, atol=1e-6)
    np.testing.assert_allclose(p_tiny2, p_big2, rtol=0, atol=1e-6)
    np.testing.assert_allclose(p_big2, p_big, rtol=0, atol=1e-6)


def test_frozen_bank_matches_host_cache(setup):
    """The device feature bank (encode + scatter, then gather + score) is
    an execution split of the host cache: the same probabilities cold and
    warm."""
    rng = np.random.RandomState(13)
    scenes = [_scene(rng) for _ in range(2)]
    bank_eng = _engine(setup, feat_bank=True)
    host_eng = _engine(setup, feat_bank=False)
    for tracks, dets, kal in scenes + scenes:
        kw = dict(extra_kalman_candidates=kal, select_highest_candidate=False)
        p_bank, r_bank = bank_eng.associate(tracks, dets, **kw)
        p_host, r_host = host_eng.associate(tracks, dets, **kw)
        np.testing.assert_allclose(p_bank, p_host, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(r_bank, r_host)
    assert bank_eng._bank.shape == (16384, 512)
    assert bank_eng._bank.dtype == torch.float32


def test_frozen_bank_eviction_invariance(setup):
    """A bank barely above one call's working set (alternating scenes
    evict each other) scores as the default capacity."""
    rng = np.random.RandomState(14)
    scene_a, scene_b = _scene(rng), _scene(rng)
    big = _engine(setup, feat_bank=True)
    tiny = _engine(setup, feat_bank=True, feat_cache_slots=26)
    for tracks, dets, kal in (scene_a, scene_b, scene_a, scene_b):
        kw = dict(extra_kalman_candidates=kal, select_highest_candidate=False)
        p_big, _ = big.associate(tracks, dets, **kw)
        p_tiny, _ = tiny.associate(tracks, dets, **kw)
        np.testing.assert_allclose(p_tiny, p_big, rtol=0, atol=1e-6)


def test_frozen_bank_exhaustion_raises(setup):
    """A call referencing more distinct crops than the bank holds raises
    (an in-flight slot is never evicted)."""
    tracks, dets, kal = _scene(np.random.RandomState(15))
    eng = _engine(setup, feat_bank=True, feat_cache_slots=4)
    with pytest.raises(RuntimeError, match="feature bank exhausted"):
        eng.associate(tracks, dets, extra_kalman_candidates=kal,
                      select_highest_candidate=False)


def test_frozen_bank_failed_call_rolls_back(setup):
    """A call that fails before its scatter unregisters its keys and frees
    its slots; one that fails after it resets the bank; the next call is
    right either way."""
    tracks, dets, kal = _scene(np.random.RandomState(16))
    kw = dict(extra_kalman_candidates=kal, select_highest_candidate=False)
    p_ref, _ = _engine(setup, feat_bank=True).associate(tracks, dets, **kw)

    eng = _engine(setup, feat_bank=True, feat_cache_slots=4)
    n_free = len(eng._free_slots)
    with pytest.raises(RuntimeError, match="feature bank exhausted"):
        eng.associate(tracks, dets, **kw)
    assert not eng._slot_of
    assert len(eng._free_slots) == n_free

    eng = _engine(setup, feat_bank=True)

    def injected(*a, **k):
        raise ValueError("injected")

    eng._score_bank = injected
    with pytest.raises(ValueError, match="injected"):
        eng.associate(tracks, dets, **kw)
    assert eng._bank is None and not eng._slot_of
    del eng._score_bank
    p_after, _ = eng.associate(tracks, dets, **kw)
    np.testing.assert_allclose(p_after, p_ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("feat_bank", [True, False])
def test_frozen_associate_many_matches_single(setup, feat_bank):
    """Batched requests equal standalone calls (frozen features couple no
    requests)."""
    rng = np.random.RandomState(8)
    scenes = [_scene(rng, n_tracks=2, n_dets=3) for _ in range(3)]
    kw = dict(select_highest_candidate=False)
    batched = _engine(setup, feat_bank=feat_bank).associate_many(
        [(t, d, None, k) for t, d, k in scenes], **kw)
    single = _engine(setup, feat_bank=feat_bank)
    for (tracks, dets, kal), (p_b, r_b) in zip(scenes, batched):
        p_s, r_s = single.associate(tracks, dets, extra_kalman_candidates=kal,
                                    **kw)
        np.testing.assert_allclose(p_b, p_s, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(r_b, r_s)


def test_frozen_differs_from_batch_mode(setup):
    """Frozen mode is a real change: running statistics are not a batch's,
    so the probabilities differ from batch mode's at the same weights."""
    variables, _ = setup
    tracks, dets, kal = _scene(np.random.RandomState(9))
    batch_model = BuscaModel(BuscaConfig(**TINY))
    load_into(batch_model,
              state_dict_from_flax({"params": variables["params"]}))
    batch = AssociationEngine(BuscaConfig(**TINY), batch_model,
                              seq_len=SEQ_LEN, num_candidates=NUM_CAN,
                              crop_hw=(H, W), buckets=(1, 2, 4, 8))
    kw = dict(extra_kalman_candidates=kal, select_highest_candidate=False)
    p_f, _ = _engine(setup).associate(tracks, dets, **kw)
    p_b, _ = batch.associate(tracks, dets, **kw)
    assert not np.allclose(p_f, p_b, rtol=0.5, atol=1e-30)


def test_frozen_montage_rejected(setup):
    with pytest.raises(ValueError, match="montage"):
        _engine(setup, debug_dir="/tmp/nope")


def test_auto_matches_frozen_numerics_both_sides_of_crossover(setup):
    """auto equals frozen at every T: the fused forward below the
    crossover, the cached path above it, BN on the running statistics in
    both."""
    for n_tracks, n_dets in [(1, 2), (2, 3), (6, 4), (8, 5)]:
        rng = np.random.RandomState(100 + n_tracks)
        tracks, dets, kal = _scene(rng, n_tracks=n_tracks, n_dets=n_dets)
        pf, rf = _engine(setup).associate(tracks, dets,
                                          extra_kalman_candidates=kal)
        pa, ra = _engine(setup, "auto", auto_fused_max_t=4).associate(
            tracks, dets, extra_kalman_candidates=kal)
        np.testing.assert_allclose(pa, pf, rtol=0, atol=2e-5)
        np.testing.assert_array_equal(ra, rf)


def test_auto_routes_by_t_crossover(setup, monkeypatch):
    """Calls at or below the crossover take the fused scorer, larger ones
    the cached path; ``associate_many`` routes by the combined count."""
    engine = _engine(setup, "auto", auto_fused_max_t=2)
    calls = {"fused": 0, "frozen": 0}
    orig_fused = AssociationEngine._score_bucketed_unique
    orig_slots = AssociationEngine._frozen_request_slots

    def spy_fused(self, *a, **kw):
        calls["fused"] += 1
        return orig_fused(self, *a, **kw)

    def spy_slots(self, *a, **kw):
        calls["frozen"] += 1
        return orig_slots(self, *a, **kw)

    monkeypatch.setattr(AssociationEngine, "_score_bucketed_unique",
                        spy_fused)
    monkeypatch.setattr(AssociationEngine, "_frozen_request_slots",
                        spy_slots)
    rng = np.random.RandomState(7)
    tracks, dets, kal = _scene(rng, n_tracks=2, n_dets=3)
    engine.associate(tracks, dets, extra_kalman_candidates=kal)
    assert calls == {"fused": 1, "frozen": 0}
    tracks, dets, kal = _scene(rng, n_tracks=5, n_dets=3)
    engine.associate(tracks, dets, extra_kalman_candidates=kal)
    assert calls == {"fused": 1, "frozen": 1}
    one = _scene(rng, n_tracks=1, n_dets=2)
    engine.associate_many([(one[0], one[1], None, one[2])] * 2)
    assert calls == {"fused": 3, "frozen": 1}  # T=2 in all: fused each
    engine.associate_many([(one[0], one[1], None, one[2])] * 3)
    assert calls == {"fused": 3, "frozen": 4}  # T=3: the cached path


def test_auto_associate_many_matches_frozen(setup):
    """Batched requests route by the combined track count and equal frozen
    mode's results on both sides of the crossover."""
    rng = np.random.RandomState(21)
    small = [_scene(rng, n_tracks=1, n_dets=2) for _ in range(2)]
    large = [_scene(rng, n_tracks=4, n_dets=3) for _ in range(2)]
    for scenes in (small, large):
        reqs = [(t, d, None, k) for t, d, k in scenes]
        rf = _engine(setup).associate_many(reqs)
        ra = _engine(setup, "auto", auto_fused_max_t=3).associate_many(reqs)
        for (pf, relf), (pa, rela) in zip(rf, ra):
            np.testing.assert_allclose(pa, pf, rtol=0, atol=2e-5)
            np.testing.assert_array_equal(rela, relf)


def test_keep_mem_lists_and_banked_per_mode(setup):
    """``banked`` and ``_keep_mem_lists`` give busca_tpu's answers in each
    mode (busca_tpu/assoc/engine.py:419-436): frozen modes keep crop lists
    and never gather pixels, even beside a crop bank."""
    from busca_tpu.assoc.bank import DeviceCropBank as JBank
    from busca_tpu_torch.assoc.bank import DeviceCropBank

    variables, model = setup
    batch_model = BuscaModel(BuscaConfig(**TINY))
    load_into(batch_model,
              state_dict_from_flax({"params": variables["params"]}))
    kw = dict(seq_len=SEQ_LEN, num_candidates=NUM_CAN, crop_hw=(H, W))
    for mode in ("batch", "frozen", "auto"):
        for with_bank in (False, True):
            tbank = DeviceCropBank((H, W), 8, "cpu") if with_bank else None
            jbank = JBank((H, W), 8) if with_bank else None
            jvars = variables if mode != "batch" else {
                "params": variables["params"]}
            want = JEngine(JCfg(**TINY), jvars, bank=jbank, reid_stats=mode,
                           **kw)
            got = AssociationEngine(
                BuscaConfig(**TINY), model if mode != "batch"
                else batch_model, bank=tbank, reid_stats=mode, **kw)
            assert got.banked == want.banked, (mode, with_bank)
            assert got._keep_mem_lists == want._keep_mem_lists


def test_frozen_stream_restored_from_snapshot_equals_unbroken():
    """A BYTE + frozen-BUSCA stream snapshotted mid-way and restored (the
    id counter back at 1) equals the unbroken stream frame by frame.  The
    restored crop mirrors lose their uids, so they are encoded afresh on
    every call (ephemeral bank slots): speed only, as in busca_tpu."""
    from busca_tpu_torch.eval.frozen_delta import calibrate_batch_stats
    from busca_tpu_torch.eval.synthetic import default_dropout_sequence
    from busca_tpu_torch.serve.snapshot import restore_bytes, snapshot_bytes
    from busca_tpu_torch.trackers.byte import ByteTracker, ByteTrackerConfig

    h, w, seq_len = 32, 16, 3
    cfg = BuscaConfig(reid_use_batch_stats=False, **TINY)
    model = BuscaModel(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    calibrate_batch_stats(model, [rng.randn(16, h, w, 3).astype(np.float32)
                                  for _ in range(2)], load=True)
    engine = AssociationEngine(cfg, model, seq_len=seq_len, num_candidates=2,
                               crop_hw=(h, w), buckets=(1, 2, 4),
                               reid_stats="frozen")
    tcfg = ByteTrackerConfig(track_thresh=0.3, use_busca=True,
                             busca_thresh=0.01, seq_len=seq_len,
                             num_candidates=2, crop_hw=(h, w),
                             use_camera_motion_compensation=False)
    seq = default_dropout_sequence(24)
    stream = [(seq.frame(t), *seq.detections(t)) for t in range(24)]

    def outputs(online):
        return sorted((int(t.track_id),
                       tuple(np.round(np.asarray(t.tlwh, float), 6)))
                      for t in online)

    cut = 10
    Track.reset_id_counter()
    tracker = ByteTracker(tcfg, engine)
    for frame, boxes, scores in stream[:cut]:
        tracker.update(boxes, scores, 1.0, torch.from_numpy(frame))
    blob = snapshot_bytes(tracker)
    rounds, ephemeral = [0], [0]
    orig, orig_slot = engine.associate, engine._slot_for

    def counted(*a, **k):
        rounds[0] += 1
        return orig(*a, **k)

    def slot_for(uid, crop, flag, ctx):
        ephemeral[0] += crop is not None and uid is None
        return orig_slot(uid, crop, flag, ctx)

    engine.associate, engine._slot_for = counted, slot_for
    expected = [outputs(tracker.update(boxes, scores, 1.0,
                                       torch.from_numpy(frame)))
                for frame, boxes, scores in stream[cut:]]
    assert ephemeral[0] == 0  # the unbroken stream hits its cache
    Track.reset_id_counter()
    restored = restore_bytes(blob, engine=engine)
    got = [outputs(restored.update(boxes, scores, 1.0,
                                   torch.from_numpy(frame)))
           for frame, boxes, scores in stream[cut:]]
    assert got == expected and any(got)
    assert rounds[0] >= 2, "the third round did not run after the cut"
    assert ephemeral[0] > 0  # the restored mirrors carry no uids
    assert len(engine._free_slots) + len(engine._slot_of) == 16384 - 1
