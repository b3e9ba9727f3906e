"""TransCenter's exact deformable decoder in the port against busca_tpu on
the CPU: ``multi_scale_deformable_attention`` at ragged pyramids (a 1x1
level among them) with locations inside and outside [0, 1], float32 and
bf16; ``DeformableCrossAttention``, ``DecoderLayer`` and the tiny
``TransCenterDETR(sampling="deformable")`` under weights carried across by
``transcenter_state_dict_from_flax``; and a detector loop with
``TransCenterByteTracker``.

busca_tpu zero-initializes the offset and attention-weight kernels, as the
published design does: every query would then sample its own reference
point with uniform weights, and a broken gather would go unseen.  The
weights here are seeded numpy draws for every parameter
(``test_torch_transcenter_model.random_params``), so the offsets move the
samples by a level pixel and more, some of them off the map.

Bounds: MSDA 1e-5 in float32 (the same samples; the level sums run in
another order); the modules and the tiny model's maps 1e-4 (the local
modes' bound, tests/test_torch_transcenter_model.py); the loop's boxes
1e-3 with ids equal.  bf16 is held in bf16 ulps of the output's scale, as
tests/test_torch_bf16_transcenter.py holds the local modes, at bars
measured on these seeds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from busca_tpu.eval import detector as jdetector
from busca_tpu.models import checkpoint as j_checkpoint
from busca_tpu.models import transcenter as jtc
from busca_tpu.ops import deform as jd
from busca_tpu.trackers.base import Track as JTrack
from busca_tpu.trackers.byte import ByteTrackerConfig as JByteCfg
from busca_tpu.trackers.transcenter import (
    TransCenterByteTracker as JTracker,
)
from busca_tpu_torch.eval import detector as tdetector
from busca_tpu_torch.eval.run import make_tracker
from busca_tpu_torch.models import checkpoint as t_checkpoint
from busca_tpu_torch.models import transcenter as ttc
from busca_tpu_torch.models.convert import transcenter_state_dict_from_flax
from busca_tpu_torch.ops import deform as td
from busca_tpu_torch.trackers.base import Track
from test_torch_byte_pipeline import CROP_HW, engines  # noqa: F401
from test_torch_strongsort import one_torch_thread  # noqa: F401
from test_torch_transcenter_model import (
    TEST_HW,
    assert_close,
    ported,
    random_params,
    t,
)
from torch_oracles import bf16_scale_ulps

MSDA_TOL = 1e-5
TOL = 1e-4
BOX_TOL = 1e-3
# measured on these seeds: MSDA 0.0 (the samples widen to float32 alike),
# the attention block 1.0, the decoder layer 0.63, the tiny model's maps
# <= 5.0 ulps of their scale
MSDA_BF16_ULPS = 0.5
CROSS_BF16_ULPS = 2.0
DECODER_BF16_ULPS = 1.5
TINY_BF16_ULPS = 6.0

# (h, w) per level, the first being the query grid in the decoder
PYRAMIDS = {
    "ragged": [(7, 9), (4, 5), (2, 3), (1, 1)],
    "mot17_like": [(8, 12), (4, 6), (2, 3), (1, 2)],
    "two_levels": [(5, 3), (3, 2)],
}


def msda_inputs(shapes, seed, b=2, heads=4, d=8, points=3, lq=11):
    """value, locations in [-0.3, 1.3] (some samples off every level; a few
    on exact pixel centres and edges) and softmaxed weights."""
    rng = np.random.RandomState(seed)
    nl = len(shapes)
    lv = sum(h * w for h, w in shapes)
    value = rng.randn(b, lv, heads, d).astype(np.float32)
    loc = rng.uniform(-0.3, 1.3, (b, lq, heads, nl, points, 2)).astype(
        np.float32)
    h0, w0 = shapes[0]
    loc[0, 0, 0, 0, 0] = [0.5 / w0, 0.5 / h0]  # the first pixel's centre
    loc[0, 1, 0, 0, :2] = [[0.0, 0.0], [1.0, 1.0]]  # the map's corners
    logits = rng.randn(b, lq, heads, nl * points).astype(np.float32)
    w = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return value, loc, w.reshape(b, lq, heads, nl, points).astype(np.float32)


@pytest.mark.parametrize("name", sorted(PYRAMIDS))
def test_msda_matches_jax(name, one_torch_thread):  # noqa: F811
    shapes = PYRAMIDS[name]
    value, loc, w = msda_inputs(shapes, seed=len(name))
    assert (loc < 0).any() and (loc > 1).any()
    want = jax.jit(jd.multi_scale_deformable_attention,
                   static_argnums=1)(value, tuple(shapes), loc, w)
    got = td.multi_scale_deformable_attention(t(value), shapes, t(loc), t(w))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=MSDA_TOL)


def test_msda_zero_outside_and_exact_at_centres():
    """A sample at a pixel centre reads that pixel; one wholly off the map
    reads zero."""
    shapes = [(3, 4), (1, 1)]
    value = np.random.RandomState(3).randn(1, 13, 1, 2).astype(np.float32)
    loc = np.zeros((1, 2, 1, 2, 1, 2), np.float32)
    loc[0, 0, 0, 0, 0] = [(2 + 0.5) / 4, (1 + 0.5) / 3]  # pixel (y1, x2)
    loc[0, 0, 0, 1, 0] = [2.5, -1.5]  # far outside the 1x1 level
    loc[0, 1] = -2.0  # every sample of the second query outside
    w = np.ones((1, 2, 1, 2, 1), np.float32)
    got = td.multi_scale_deformable_attention(t(value), shapes, t(loc),
                                              t(w)).numpy()
    np.testing.assert_array_equal(got[0, 0], value[0, 1 * 4 + 2, 0])
    np.testing.assert_array_equal(got[0, 1], np.zeros(2, np.float32))


def _ulps(got, want, bound, label):
    assert str(got.dtype).split(".")[-1] == str(want.dtype), label
    ulps, exact = bf16_scale_ulps(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    print(f"{label}: {ulps:.2f} ulps of scale, exact {exact:.3f}")
    assert ulps <= bound, label


def test_msda_bf16_matches_jax():
    """bf16 value and weights: the corners widen to float32 in the bilinear
    factors and the levels sum in float32, in both packages."""
    shapes = PYRAMIDS["ragged"]
    value, loc, w = msda_inputs(shapes, seed=4)
    vb, wb = jnp.asarray(value, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = jax.jit(jd.multi_scale_deformable_attention,
                   static_argnums=1)(vb, tuple(shapes), loc, wb)
    got = td.multi_scale_deformable_attention(
        t(value).to(torch.bfloat16), shapes, t(loc), t(w).to(torch.bfloat16))
    _ulps(got, want, MSDA_BF16_ULPS, "MSDA bf16")


# ------------------------------ the modules ---------------------------------

def _memory_inputs(seed, shapes, dim=32, lq=None):
    rng = np.random.RandomState(seed)
    h0, w0 = shapes[0]
    lq = lq or h0 * w0
    q = rng.randn(1, lq, dim).astype(np.float32)
    mem = rng.randn(1, sum(h * w for h, w in shapes), dim).astype(np.float32)
    ref = rng.uniform(0, 1, (1, lq, 2)).astype(np.float32)
    return q, ref, mem


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deformable_cross_attention(dtype):
    dim, heads, points = 32, 4, 3
    shapes = PYRAMIDS["mot17_like"]
    q, ref, mem = _memory_inputs(5, shapes, dim)
    params = random_params(jtc.DeformableCrossAttention(dim, heads, points,
                                                        4),
                           q, ref, mem, spatial_shapes=tuple(shapes))
    jdt = jnp.dtype(dtype)
    jm = jtc.DeformableCrossAttention(dim, heads, points, 4, dtype=jdt)
    want = jax.jit(functools.partial(jm.apply, spatial_shapes=tuple(shapes)))(
        params, q, ref, mem)
    tdt = getattr(torch, dtype)
    tm = ported(ttc.DeformableCrossAttention(dim, heads, points, 4, tdt),
                params)
    with torch.no_grad():
        got = tm(t(q), t(ref), t(mem), shapes)
    if dtype == "float32":
        assert_close(got, want)
    else:
        _ulps(got, want, CROSS_BF16_ULPS, "DeformableCrossAttention bf16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_layer_deformable(dtype):
    dim, heads = 32, 4
    shapes = PYRAMIDS["mot17_like"]
    qf, _, mem_cur = _memory_inputs(6, shapes, dim)
    _, _, mem_pre = _memory_inputs(7, shapes, dim)
    ref = ttc.reference_points(*shapes[0], "cpu")[None].numpy()
    params = random_params(jtc.DecoderLayer(dim, heads, 3, 4,
                                            sampling="deformable"),
                           qf, ref, mem_cur, mem_pre, shapes=tuple(shapes))
    jm = jtc.DecoderLayer(dim, heads, 3, 4, sampling="deformable",
                          dtype=jnp.dtype(dtype))
    want = jax.jit(functools.partial(jm.apply, shapes=tuple(shapes)))(
        params, qf, ref, mem_cur, mem_pre)
    tm = ported(ttc.DecoderLayer(dim, heads, 4, sampling="deformable",
                                 dtype=getattr(torch, dtype), points=3),
                params)
    with torch.no_grad():
        got = tm(t(qf), t(mem_cur), t(mem_pre), shapes, t(ref))
    if dtype == "float32":
        assert_close(got, want)
    else:
        _ulps(got, want, DECODER_BF16_ULPS, "decoder layer deformable bf16")


def test_reference_points_match_jax():
    """busca_tpu's per-query reference points (its pixel centre over the
    grid, float32), at a width whose divisions round."""
    h4, w4 = 7, 17
    gy, gx = jnp.mgrid[0:h4, 0:w4]
    want = jnp.stack([(gx.ravel() + 0.5) / w4, (gy.ravel() + 0.5) / h4],
                     axis=-1).astype(jnp.float32)
    np.testing.assert_array_equal(ttc.reference_points(h4, w4, "cpu").numpy(),
                                  np.asarray(want))


# ------------------------------ the full model ------------------------------

@pytest.fixture(scope="module")
def tiny_deformable():
    rng = np.random.RandomState(17)
    h, w = TEST_HW
    args = (rng.randn(1, h, w, 3).astype(np.float32),
            rng.randn(1, h, w, 3).astype(np.float32),
            rng.rand(1, h // 4, w // 4, 1).astype(np.float32))
    jm = jtc.TransCenterDETR(jtc.TransCenterConfig.tiny(
        sampling="deformable"))
    params = random_params(jm, *args, seed=18)
    return params, args


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_deformable_model_matches_jax(tiny_deformable, dtype):
    params, args = tiny_deformable
    want = jax.jit(jtc.TransCenterDETR(jtc.TransCenterConfig.tiny(
        sampling="deformable", dtype=dtype)).apply)(params, *args)
    tm = ported(ttc.TransCenterDETR(ttc.TransCenterConfig.tiny(
        sampling="deformable", dtype=dtype)), params)
    with torch.no_grad():
        got = tm(*(t(a) for a in args))
    assert set(got) == set(want) == set(ttc.HEADS)
    for k in want:
        assert got[k].shape == want[k].shape, k
        if dtype == "float32":
            assert_close(got[k], want[k])
        else:
            _ulps(got[k], want[k], TINY_BF16_ULPS, f"tiny deformable {k}")


def test_deformable_init_and_converter(tiny_deformable, tmp_path):
    """``init_weights`` follows flax's initialisers (zero offset and weight
    kernels, normal(0.02) level embeddings); busca_tpu's deformable ``.npz``
    loads into the port (the four level embeddings and every layer's
    ``value``, ``offsets``, ``weights`` and ``proj``), and the port's
    writer gives back busca_tpu's tree."""
    m = ttc.TransCenterDETR(ttc.TransCenterConfig.tiny(sampling="deformable"))
    m.init_weights(torch.Generator().manual_seed(0))
    sd = m.state_dict()
    for name in ("offsets", "weights"):
        assert (sd[f"dec_1.cross_pre.{name}.weight"] == 0).all()
        assert (sd[f"dec_1.cross_pre.{name}.bias"] == 0).all()
    assert sd["dec_0.cross_cur.value.weight"].std() > 0
    emb = torch.stack([sd[f"level_embed_{lvl}"] for lvl in range(4)])
    assert emb.shape == (4, 32) and 0.01 < float(emb.std()) < 0.03

    params, args = tiny_deformable
    path = str(tmp_path / "tc_deformable.npz")
    j_checkpoint.save_params_npz(path, jax.tree_util.tree_map(np.asarray,
                                                              params))
    converted = transcenter_state_dict_from_flax(
        t_checkpoint.load_params_npz(path))
    assert set(converted) == set(sd)
    p = params["params"]
    np.testing.assert_array_equal(converted["level_embed_2"].numpy(),
                                  np.asarray(p["level_embed_2"]))
    np.testing.assert_array_equal(
        converted["dec_1.cross_pre.offsets.weight"].numpy(),
        np.asarray(p["dec_1"]["cross_pre"]["offsets"]["kernel"]).T)
    back = str(tmp_path / "back.npz")
    t_checkpoint.save_params_npz(back, t_checkpoint.load_params_npz(path))
    flat_a = j_checkpoint._flatten(j_checkpoint.load_params_npz(back))
    flat_b = j_checkpoint._flatten(jax.tree_util.tree_map(np.asarray,
                                                          params))
    assert set(flat_a) == set(flat_b)


# ------------------------------ the loop ------------------------------------

LOOP_SIZE = (64, 96)
OUT_THRESH = 0.3
TRACKER_KW = dict(use_busca=True, crop_hw=CROP_HW, track_thresh=0.6,
                  busca_thresh=0.1, select_highest_candidate=False)
THRESHOLDS = (OUT_THRESH, 0.1, 0.6, 0.7)


def test_deformable_loop_matches_jax(engines):
    """Two frames of the dropout sequence through both packages' deformable
    TransCenterDetector + TransCenterByteTracker + BUSCA: per frame the
    detection counts and track ids equal, boxes within 1e-3."""
    from busca_tpu.eval.synthetic import default_dropout_sequence

    th, tw = LOOP_SIZE
    z = np.zeros((1, th, tw, 3), np.float32)
    hm = np.zeros((1, th // 4, tw // 4, 1), np.float32)
    jcfg = jtc.TransCenterConfig.tiny(sampling="deformable")
    # seed 20: a few peaks per frame above det_thresh (0.7), so that tracks
    # start; on seed 12 (the local loop's) none does
    variables = jax.tree_util.tree_map(np.asarray, random_params(
        jtc.TransCenterDETR(jcfg), z, z, hm, seed=20))
    variables["params"]["wh_out"]["bias"] = np.array([4.0, 8.0], np.float32)
    jdet = jdetector.TransCenterDetector(
        jcfg, variables=variables, test_size=LOOP_SIZE,
        out_thresh=OUT_THRESH)
    tdet = tdetector.TransCenterDetector(
        ttc.TransCenterConfig.tiny(sampling="deformable"),
        state_dict=transcenter_state_dict_from_flax(variables),
        test_size=LOOP_SIZE, out_thresh=OUT_THRESH, device="cpu")
    jeng, teng = engines
    seq = default_dropout_sequence(40)
    frames = [seq.frame(t_) for t_ in range(2)]
    JTrack.reset_id_counter()
    Track.reset_id_counter()
    jlog, tlog = [], []
    want = jdetector.track_frames_with_detector(
        jdet, JTracker(JByteCfg(**TRACKER_KW), jeng), frames,
        min_box_area=0.0, det_log=jlog)
    got = tdetector.track_frames_with_detector(
        tdet, make_tracker("transcenter", TRACKER_KW, teng, CROP_HW), frames,
        min_box_area=0.0, det_log=tlog)
    for (fj, bj, sj), (ft, bt, st) in zip(jlog, tlog):
        assert ft == fj and len(st) == len(sj) > 0, f"frame {fj}"
        np.testing.assert_allclose(bt, bj, rtol=0, atol=BOX_TOL / 0.25)
        np.testing.assert_allclose(st, sj, rtol=0, atol=BOX_TOL)
        gaps = np.abs(np.asarray(sj)[:, None] - np.asarray(THRESHOLDS))
        assert gaps.min() > 1e-5, f"frame {fj}: a score sits on a threshold"
    for (fj, tl_j, ids_j, _), (_, tl_t, ids_t, _) in zip(want.results,
                                                         got.results):
        assert ids_t == ids_j, f"frame {fj}: ids diverged"
        np.testing.assert_allclose(np.reshape(tl_t, (-1, 4)),
                                   np.reshape(tl_j, (-1, 4)), rtol=0,
                                   atol=BOX_TOL / 0.25)
    assert sum(len(r[2]) for r in got.results) > 0, "no track was output"
