"""The port's TransCenter model (busca_tpu_torch/models/transcenter.py)
against busca_tpu.models.transcenter on the CPU: each module under weights
carried across by ``transcenter_state_dict_from_flax``, the tiny full model
under both local sampling modes, ``generic_decode`` with ties,
``render_prior_heatmap``, and the converter through an ``.npz``.

The parameters are seeded numpy draws shaped by ``jax.eval_shape`` (random
biases, LayerNorm scales and attention-weight kernels too, so that no path
is hidden behind a zero init).  Tolerance 1e-4, the JAX suite's own
local-vs-pallas bound (tests/test_transcenter_model.py); the modules agree to
about 1e-6.  The bilinear upsampling of the level maps
(``jax.image.resize`` vs ``F.interpolate``) differs by up to ~2.4e-7 at
these sizes.
"""

import functools

import jax
import jax.experimental.pallas as pl
import numpy as np
import pytest
import torch

from busca_tpu.models import checkpoint as j_checkpoint
from busca_tpu.models import transcenter as jtc
from busca_tpu.ops import lma_pallas
from busca_tpu_torch.models import checkpoint as t_checkpoint
from busca_tpu_torch.models import transcenter as ttc
from busca_tpu_torch.models.convert import transcenter_state_dict_from_flax

TOL = 1e-4
TEST_HW = (32, 48)


def random_params(module, *args, seed=0, **static):
    """Seeded numpy parameters of the flax ``module`` for ``args`` (and the
    keyword arguments ``static``, which are not traced)."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(functools.partial(module.init, **static),
                            jax.random.PRNGKey(0), *args)

    def fill(path, s):
        leaf = str(getattr(path[-1], "key", path[-1]))
        if leaf == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if leaf == "scale":
            return (1.0 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def ported(tmod, params):
    tmod.load_state_dict(transcenter_state_dict_from_flax(params))
    return tmod.eval()


def t(x):
    return torch.from_numpy(np.asarray(x))


def assert_close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=tol)


# ------------------------------ the modules ---------------------------------

@pytest.mark.parametrize("hw,sr", [((8, 12), 8), ((2, 3), 2), ((5, 7), 4),
                                   ((4, 6), 1)])
def test_sr_attention(hw, sr):
    """SAME-padded spatial reduction: 8x12 with sr 8 pads only the width,
    2x3 with sr 2 pads (0, 1), 5x7 with sr 4 pads both axes unevenly."""
    dim, heads = 16, 2
    x = np.random.RandomState(1).randn(1, hw[0] * hw[1], dim).astype(
        np.float32)
    jm = jtc.SRAttention(dim, heads, sr)
    params = random_params(jm, x, hw=hw)
    want = jax.jit(functools.partial(jm.apply, hw=hw))(params, x)
    tm = ported(ttc.SRAttention(dim, heads, sr), params)
    assert_close(tm(t(x), hw), want)


def test_mix_ffn():
    dim, ratio, hw = 8, 4, (5, 6)
    x = np.random.RandomState(2).randn(2, 30, dim).astype(np.float32)
    jm = jtc.MixFFN(dim, ratio)
    params = random_params(jm, x, hw=hw)
    want = jax.jit(functools.partial(jm.apply, hw=hw))(params, x)
    assert_close(ported(ttc.MixFFN(dim, ratio), params)(t(x), hw), want)


@pytest.mark.parametrize("patch,stride,sr", [(7, 4, 2), (3, 2, 1)])
def test_pvtv2_stage(patch, stride, sr):
    x = np.random.RandomState(3).randn(1, 16, 24, 5).astype(np.float32)
    jm = jtc.PVTv2Stage(16, 2, 2, 2, sr, patch=patch, stride=stride)
    params = random_params(jm, x)
    want = jax.jit(jm.apply)(params, x)
    tm = ported(ttc.PVTv2Stage(5, 16, 2, 2, 2, sr, patch, stride), params)
    assert_close(tm(t(x)), want)


def _decoder_inputs(seed, dim=32, h4=8, w4=12):
    rng = np.random.RandomState(seed)
    q = rng.randn(1, h4, w4, dim).astype(np.float32)
    maps = [rng.randn(1, h4 >> s, max(w4 >> s, 1), dim).astype(np.float32)
            for s in range(4)]
    return q, maps


def test_local_multiscale_attention():
    dim, heads = 32, 4
    q, maps = _decoder_inputs(4)
    jm = jtc.LocalMultiScaleAttention(dim, heads, 4)
    params = random_params(jm, q, maps)
    want = jax.jit(jm.apply)(params, q, maps)
    tm = ported(ttc.LocalMultiScaleAttention(dim, heads, 4), params)
    assert_close(tm(t(q), [t(m) for m in maps]), want)


@pytest.mark.parametrize("sampling", ["local", "local_pallas"])
def test_decoder_layer(sampling, monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(lma_pallas.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    dim, heads = 32, 4
    q, maps = _decoder_inputs(5)
    pre = _decoder_inputs(6)[1]
    shapes = [(m.shape[1], m.shape[2]) for m in maps]
    qf = q.reshape(1, -1, dim)
    ref = np.zeros((1, qf.shape[1], 2), np.float32)
    jm = jtc.DecoderLayer(dim, heads, 4, 4, sampling=sampling)
    params = random_params(jm, qf, ref, maps, pre, shapes=shapes)
    want = jax.jit(functools.partial(jm.apply, shapes=shapes))(
        params, qf, ref, maps, pre)
    tm = ported(ttc.DecoderLayer(dim, heads, 4, sampling=sampling), params)
    assert_close(tm(t(qf), [t(m) for m in maps], [t(m) for m in pre],
                    shapes), want)


# ------------------------------ the full model ------------------------------

@pytest.fixture(scope="module")
def tiny():
    rng = np.random.RandomState(7)
    h, w = TEST_HW
    curr = rng.randn(1, h, w, 3).astype(np.float32)
    pre = rng.randn(1, h, w, 3).astype(np.float32)
    pre_hm = rng.rand(1, h // 4, w // 4, 1).astype(np.float32)
    args = (curr, pre, pre_hm)
    jm = jtc.TransCenterDETR(jtc.TransCenterConfig.tiny())
    params = random_params(jm, *args, seed=8)
    return params, args, jax.jit(jm.apply)(params, *args)


@pytest.mark.parametrize("sampling", ["local", "local_pallas"])
def test_tiny_model_matches_jax(tiny, sampling, monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(lma_pallas.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    params, args, want_local = tiny
    cfg = jtc.TransCenterConfig.tiny(sampling=sampling)
    want = want_local if sampling == "local" else jax.jit(
        jtc.TransCenterDETR(cfg).apply)(params, *args)
    tm = ported(ttc.TransCenterDETR(ttc.TransCenterConfig.tiny(
        sampling=sampling)), params)
    with torch.no_grad():
        got = tm(*(t(a) for a in args))
    assert set(got) == set(want) == {"hm", "reg", "wh", "tracking", "reid"}
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert_close(got[k], want[k])


def test_init_weights_follows_flax_initialisers():
    m = ttc.TransCenterDETR(ttc.TransCenterConfig.tiny())
    m.init_weights(torch.Generator().manual_seed(0))
    sd = m.state_dict()
    assert (sd["hm_out.bias"] == ttc.HM_BIAS).all()
    assert (sd["dec_0.cross_cur.weights.weight"] == 0).all()
    assert (sd["pvt.stage0.norm.weight"] == 1).all()
    assert (sd["pvt.stage0.attn_0.q.bias"] == 0).all()
    k = sd["pvt.stage1.ffn_0.fc1.weight"]  # fan_in 16, 2-sigma truncation
    std = (1 / 16) ** 0.5 / 0.87962566103423978
    assert k.abs().max() <= 2 * std and k.std() > 0.5 * std


def test_converter_round_trip_through_npz(tiny, tmp_path):
    """busca_tpu's npz -> the port's loader -> the same outputs; the port's
    writer -> busca_tpu's loader -> the same tree."""
    params, args, want = tiny
    path = str(tmp_path / "tc.npz")
    j_checkpoint.save_params_npz(path, jax.tree_util.tree_map(np.asarray,
                                                              params))
    loaded = t_checkpoint.load_params_npz(path)
    tm = ported(ttc.TransCenterDETR(ttc.TransCenterConfig.tiny()), loaded)
    with torch.no_grad():
        got = tm(*(t(a) for a in args))
    for k in want:
        assert_close(got[k], want[k])

    back = str(tmp_path / "back.npz")
    t_checkpoint.save_params_npz(back, loaded)
    flat_a = t_checkpoint._flatten(j_checkpoint.load_params_npz(back))
    flat_b = j_checkpoint._flatten(jax.tree_util.tree_map(np.asarray,
                                                          params))
    assert set(flat_a) == set(flat_b)
    for key in flat_a:
        np.testing.assert_array_equal(flat_a[key], flat_b[key])


# ------------------------- decode and prior heatmap --------------------------

def test_generic_decode_with_ties_is_exact():
    """Plateaus and the zeroed map after peak suppression make the top-K
    full of ties; they are taken in index order, as lax.top_k takes them."""
    rng = np.random.RandomState(9)
    b, h, w, k = 2, 12, 16, 40
    hm = np.round(rng.rand(b, h, w, 1) * 4).astype(np.float32) / 4
    hm[:, 3:6, 4:9] = 0.75  # a plateau: every pixel of it is a peak
    out = {
        "hm": hm,
        "reg": rng.randn(b, h, w, 2).astype(np.float32),
        "wh": rng.rand(b, h, w, 2).astype(np.float32) * 8,
        "tracking": rng.randn(b, h, w, 2).astype(np.float32),
    }
    want = jtc.generic_decode({n: np.asarray(v) for n, v in out.items()},
                              k=k)
    got = ttc.generic_decode({n: t(v) for n, v in out.items()}, k=k)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)


@pytest.mark.parametrize("cts", [None, np.zeros((0, 2)),
                                 np.array([[3.0, 5.0], [10.5, 2.25]])])
def test_render_prior_heatmap(cts):
    np.testing.assert_array_equal(ttc.render_prior_heatmap(cts, (10, 12)),
                                  jtc.render_prior_heatmap(cts, (10, 12)))
