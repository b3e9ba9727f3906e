"""busca_tpu's bfloat16 mode in the port's TransCenter, against busca_tpu on
the CPU, per module: both packages run ``dtype=bfloat16`` on the same
float32 parameters (tests/test_torch_transcenter_model.py's seeded draws and
weight bridge), on seeded numpy inputs: the PVTv2 stage,
``LocalMultiScaleAttention`` under both of busca_tpu's tap sums,
``DecoderLayer`` under both local samplings, and the tiny full model's five
maps.

Bounds are in bf16 ulps of the output's scale (the ulp of its largest
magnitude; ``torch_oracles.bf16_scale_ulps``), measured on these seeds.
The products and LayerNorms round as flax's do; torch's bf16 GELU and
softmax round once where XLA's CPU backend rounds per step, and the two
libraries sum in different orders, so a value moves by an ulp here and
there.  busca_tpu's ``sampling="local"`` (its chunked tap sum) accumulates
in bf16; the port sums in float32 under both names, as ``local_pallas``
does (ROADMAP Queue 3), so ``local`` is held to the looser bound.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from busca_tpu.models import transcenter as jtc
from busca_tpu_torch.models import transcenter as ttc
from test_torch_lma import interpret  # noqa: F401 (the fixture)
from test_torch_transcenter_model import (
    TEST_HW,
    _decoder_inputs,
    ported,
    random_params,
    t,
)
from torch_oracles import bf16_scale_ulps

BF16 = "bfloat16"
# measured on these seeds, float32 tap sum (local_pallas / pallas) | bf16
# chunked accumulator (local / chunked): the PVTv2 stage 2.0 ulps of its
# scale; the local multi-scale attention 1.0 | 1.5; the decoder layer
# 0.69 | 0.73; the tiny model's maps <= 3.0 | 3.0
PVT_ULPS = 4.0
LMSA_ULPS = {"pallas": 2.0, "chunked": 3.0}
DECODER_ULPS = {"local_pallas": 1.5, "local": 2.0}
TINY_ULPS = {"local_pallas": 6.0, "local": 8.0}


def _ulps(got, want, bound, label):
    # the same dtype as busca_tpu's (a float32 input's residual promotes)
    assert str(got.dtype).split(".")[-1] == str(want.dtype), label
    ulps, exact = bf16_scale_ulps(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    print(f"{label}: {ulps:.2f} ulps of scale, exact {exact:.3f}")
    assert ulps <= bound, label


@pytest.mark.parametrize("patch,stride,sr", [(7, 4, 2), (3, 2, 1)])
def test_pvtv2_stage_bf16(patch, stride, sr):
    x = np.random.RandomState(3).randn(1, 16, 24, 5).astype(np.float32)
    params = random_params(jtc.PVTv2Stage(16, 2, 2, 2, sr, patch=patch,
                                          stride=stride), x)
    jm = jtc.PVTv2Stage(16, 2, 2, 2, sr, patch=patch, stride=stride,
                        dtype=jnp.bfloat16)
    want = jax.jit(jm.apply)(params, x)
    tm = ported(ttc.PVTv2Stage(5, 16, 2, 2, 2, sr, patch, stride,
                               dtype=torch.bfloat16), params)
    with torch.no_grad():
        got = tm(t(x))
    _ulps(got, want, PVT_ULPS,
          f"PVTv2 stage {patch}/{stride} sr {sr}")


@pytest.mark.parametrize("tap_sum", ["chunked", "pallas"])
def test_local_multiscale_attention_bf16(interpret, tap_sum):
    dim, heads = 32, 4
    q, maps = _decoder_inputs(4)
    params = random_params(jtc.LocalMultiScaleAttention(dim, heads, 4), q,
                           maps)
    jm = jtc.LocalMultiScaleAttention(dim, heads, 4, dtype=jnp.bfloat16,
                                      tap_sum=tap_sum)
    want = jax.jit(jm.apply)(params, q, maps)
    tm = ported(ttc.LocalMultiScaleAttention(dim, heads, 4,
                                             dtype=torch.bfloat16), params)
    with torch.no_grad():
        got = tm(t(q), [t(m) for m in maps])
    _ulps(got, want, LMSA_ULPS[tap_sum], f"LMSA {tap_sum}")


@pytest.mark.parametrize("sampling", ["local", "local_pallas"])
def test_decoder_layer_bf16(interpret, sampling):
    dim, heads = 32, 4
    q, maps = _decoder_inputs(5)
    pre = _decoder_inputs(6)[1]
    shapes = [(m.shape[1], m.shape[2]) for m in maps]
    qf = q.reshape(1, -1, dim)
    ref = np.zeros((1, qf.shape[1], 2), np.float32)
    params = random_params(jtc.DecoderLayer(dim, heads, 4, 4,
                                            sampling=sampling),
                           qf, ref, maps, pre, shapes=shapes)
    jm = jtc.DecoderLayer(dim, heads, 4, 4, sampling=sampling,
                          dtype=jnp.bfloat16)
    want = jax.jit(functools.partial(jm.apply, shapes=shapes))(
        params, qf, ref, maps, pre)
    tm = ported(ttc.DecoderLayer(dim, heads, 4, sampling=sampling,
                                 dtype=torch.bfloat16), params)
    with torch.no_grad():
        got = tm(t(qf), [t(m) for m in maps], [t(m) for m in pre], shapes)
    _ulps(got, want, DECODER_ULPS[sampling],
          f"decoder layer {sampling}")


@pytest.mark.parametrize("sampling", ["local", "local_pallas"])
def test_tiny_transcenter_bf16_matches_jax(interpret, sampling):
    """The tiny model's five maps in bf16, as busca_tpu returns them."""
    rng = np.random.RandomState(7)
    h, w = TEST_HW
    args = (rng.randn(1, h, w, 3).astype(np.float32),
            rng.randn(1, h, w, 3).astype(np.float32),
            rng.rand(1, h // 4, w // 4, 1).astype(np.float32))
    params = random_params(jtc.TransCenterDETR(jtc.TransCenterConfig.tiny()),
                           *args, seed=8)
    cfg = jtc.TransCenterConfig.tiny(sampling=sampling, dtype=jnp.bfloat16)
    want = jax.jit(jtc.TransCenterDETR(cfg).apply)(params, *args)
    tm = ported(ttc.TransCenterDETR(ttc.TransCenterConfig.tiny(
        sampling=sampling, dtype=BF16)), params)
    with torch.no_grad():
        got = tm(*(t(a) for a in args))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        _ulps(got[k], want[k], TINY_ULPS[sampling],
              f"tiny TransCenter {sampling} {k}")
