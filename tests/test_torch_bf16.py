"""busca_tpu's bfloat16 mode in the port's BUSCA path, against busca_tpu on
the CPU: both packages run ``dtype="bfloat16"`` on the same float32
parameters (carried by the weight bridge, busca_tpu's checkpoint route), on
seeded numpy inputs.

- The BUSCA logits, the port's counterpart of ``tests/test_bf16.py`` at its
  configuration (``num_layer=1``, ResNet (1,1,1,1), 4 requests, 64x32
  crops): argmax equal wherever busca_tpu's float32 margin is above 0.05,
  and |delta p| <= 0.12 (``tests/test_bf16.py``'s bar), against busca_tpu's
  bf16 and against the port's own float32.  The measured |delta p| is
  pinned below that bar.
- The Transformer and the ReID features (every BatchNorm mode and mask
  kind) per module, in bf16 ulps of the output's scale.  The products,
  LayerNorms and BatchNorms round as flax does, value for value; torch's
  bf16 elementwise ops (GELU) round once where XLA's CPU backend may round
  per step, and summation orders differ, so a value can move by an ulp, and
  the ResNet carries such moves through its batch-statistic BatchNorms.
- The raise for a dtype that is neither float32 nor bfloat16, in each
  model and in K2's wrapper.

The loop is tests/test_torch_bf16_loop.py, the CLI
tests/test_torch_bf16_cli.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from busca_tpu.models.busca import BuscaConfig as JCfg
from busca_tpu.models.busca import BuscaModel as JModel
from busca_tpu.models.reid import ReIDResNet as JReID
from busca_tpu.models.transformer import TransformerEncoder as JEncoder
from busca_tpu_torch.assoc.engine import AssociationEngine
from busca_tpu_torch.models.busca import BuscaConfig, BuscaModel
from busca_tpu_torch.models.convert import (
    load_into,
    resnet_state_dict_from_flax,
    state_dict_from_flax,
)
from busca_tpu_torch.models.reid import ReIDResNet
from busca_tpu_torch.models.transformer import TransformerEncoder
from torch_oracles import bf16_scale_ulps

BF16 = "bfloat16"
# tests/test_bf16.py's bars
MARGIN, PROB_BAR = 0.05, 0.12
# the measured |delta p| on these seeds, pinned: port bf16 against
# busca_tpu bf16 and against the port's float32 <= 0.0058 (busca_tpu's own
# bf16 against its float32: 0.0055); the loop's third rounds <= 0.0024
PROB_PIN = 0.02
TEST_BF16 = dict(num_layer=1, reid_num_classes=5, reid_layers=(1, 1, 1, 1))
# measured: the Transformer's bf16 output within 0.01 ulp of its scale
# (99.9% of values equal; its products are float32); the ReID's
# L2-normalized features within 10.9 ulps of their scale with batch
# statistics and 1.25 with the stored ones (ResNet (1,1,1,1) on 6 crops of
# 64x32: the batch-statistic BatchNorms over 4x2 maps amplify an ulp moved
# upstream)
TRANSFORMER_ULPS, REID_ULPS = 1.0, 16.0


def _softmax(z):
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def busca_models():
    """tests/test_bf16.py's models and inputs: busca_tpu's float32 and bf16
    BuscaModel on one float32 init, and the port's in both dtypes."""
    rng = np.random.RandomState(0)
    b, l, c, h, w = 4, 3, 2, 64, 32
    mem = rng.randn(b, l, h, w, 3).astype(np.float32)
    can = rng.randn(b, c, h, w, 3).astype(np.float32)

    def boxes(n):
        return np.concatenate([rng.uniform(0, 500, (b, n, 2)),
                               rng.uniform(520, 800, (b, n, 2))],
                              -1).astype(np.float32)

    mb, cb = boxes(l), boxes(c)
    variables = _np_tree(jax.jit(JModel(JCfg(**TEST_BF16)).init)(
        jax.random.PRNGKey(0), mem, can, mb, cb))
    return variables, (mem, can, mb, cb)


def _logits(variables, inputs):
    jout = {dt: np.asarray(jax.jit(JModel(JCfg(**TEST_BF16, dtype=dt)).apply)(
        variables, *inputs)) for dt in ("float32", BF16)}
    tout = {}
    for dt in ("float32", BF16):
        model = BuscaModel(BuscaConfig(**TEST_BF16, dtype=dt))
        load_into(model, state_dict_from_flax(variables))
        with torch.no_grad():
            tout[dt] = model.eval()(*(torch.from_numpy(a) for a in inputs))
    return jout, tout


@pytest.mark.parametrize("decoder", ["as_init", "spread"])
def test_busca_bf16_logits_agree(busca_models, decoder):
    """``spread`` scales the random decoder by 0.02 (as
    tests/test_torch_byte_pipeline.py does), so that the probabilities are
    not saturated and some margins fall under 0.05."""
    variables, inputs = busca_models
    if decoder == "spread":
        variables = jax.tree_util.tree_map(lambda a: a, variables)
        dec = variables["params"]["decoder_linear"]
        dec["weight"] = dec["weight"] * np.float32(0.02)
    jout, tout = _logits(variables, inputs)
    assert tout[BF16].dtype == torch.float32  # float32 decoder, as busca_tpu
    p32 = _softmax(jout["float32"])
    srt = np.sort(p32, -1)
    confident = srt[:, -1] - srt[:, -2] > MARGIN
    assert confident.any()
    want = jout["float32"].argmax(-1)[confident]
    for name, ref in (("busca_tpu bf16", jout[BF16]),
                      ("port float32", tout["float32"].numpy())):
        got = tout[BF16].numpy()
        assert (got.argmax(-1)[confident] == want).all(), name
        assert (got.argmax(-1)[confident]
                == ref.argmax(-1)[confident]).all(), name
        dp = np.abs(_softmax(got) - _softmax(ref)).max()
        print(f"{decoder}: port bf16 vs {name}: max |dp| {dp:.3g}; "
              f"busca_tpu bf16 vs float32 "
              f"{np.abs(_softmax(jout[BF16]) - p32).max():.3g}")
        assert dp <= min(PROB_BAR, PROB_PIN), name


def test_transformer_bf16_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(3, 10, 64).astype(np.float32)
    variables = _np_tree(jax.jit(JEncoder(2, 64, 4, 128).init)(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    jmod = JEncoder(2, 64, 4, 128, dtype=jnp.bfloat16)
    jout, jatt = jax.jit(jmod.apply, static_argnames=("return_att",))(
        variables, jnp.asarray(x), return_att=True)
    assert jout.dtype == jnp.bfloat16
    sd = state_dict_from_flax({"params": {"transformer_encoder":
                                          variables["params"]}})
    tmod = TransformerEncoder(2, 64, 4, 128, dtype=torch.bfloat16)
    tmod.load_state_dict({k[len("transformer_encoder."):]: v
                          for k, v in sd.items()})
    with torch.no_grad():
        tout, tatt = tmod(torch.from_numpy(x), return_att=True)
    assert tout.dtype == torch.bfloat16
    ulps, exact = bf16_scale_ulps(tout.float(), jout.astype(jnp.float32))
    print(f"Transformer bf16: {ulps:.2f} ulps of scale, exact {exact:.3f}")
    assert ulps <= TRANSFORMER_ULPS
    for a, b in zip(tatt, jatt):  # float32 attention (float32 products)
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def reid_variables():
    x0 = np.zeros((2, 64, 32, 3), np.float32)
    jmod = JReID(layers=(1, 1, 1, 1), num_classes=7, use_batch_stats=False)
    variables = _np_tree(jax.jit(jmod.init)(jax.random.PRNGKey(1),
                                            jnp.asarray(x0)))
    rng = np.random.RandomState(11)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 2.0, a.shape) if p[-1].key ==
                      "running_var" else rng.randn(*a.shape) * 0.1
                      ).astype(np.float32), variables["batch_stats"])
    return variables


@pytest.mark.parametrize("mode", ["none", "mask", "groups", "frozen"])
def test_reid_bf16_features_match_jax(reid_variables, mode):
    frozen = mode == "frozen"
    variables = reid_variables if frozen else {
        "params": reid_variables["params"]}
    x = np.random.RandomState(4).randn(6, 64, 32, 3).astype(np.float32)
    mask = {"mask": np.array([1, 1, 1, 0, 1, 0], np.float32),
            "groups": np.array([[1, 0], [1, 0], [0, 0], [0, 2], [0, 1],
                                [1, 0]], np.float32)}.get(mode)
    jmod = JReID(layers=(1, 1, 1, 1), num_classes=7,
                 use_batch_stats=not frozen, dtype=jnp.bfloat16)
    _, want = jax.jit(jmod.apply)(variables, jnp.asarray(x),
                                  None if mask is None else jnp.asarray(mask))
    tmod = ReIDResNet(layers=(1, 1, 1, 1), num_classes=7,
                      use_batch_stats=not frozen, dtype=torch.bfloat16)
    tmod.load_state_dict(resnet_state_dict_from_flax(variables),
                         strict=False)
    with torch.no_grad():
        _, got = tmod.eval()(torch.from_numpy(x), None if mask is None
                             else torch.from_numpy(mask))
    assert got.dtype == torch.float32  # fc7 back to float32, as busca_tpu
    ulps, exact = bf16_scale_ulps(got, want)
    print(f"ReID bf16 features ({mode}): {ulps:.2f} ulps of scale")
    assert ulps <= REID_ULPS


def _build_other_dtype(what):
    from busca_tpu_torch.models.transcenter import (
        TransCenterConfig,
        TransCenterDETR,
    )
    from busca_tpu_torch.models.yolox import YOLOX, YoloxConfig
    from busca_tpu_torch.ops.lma import local_tap_sum_levels
    from busca_tpu_torch.ops.lma_cuda import local_tap_sum_levels_cuda

    levels = [torch.zeros(4, 4, 8), torch.zeros(2, 2, 8)]
    wts = torch.zeros(4, 4, 1, 18)
    half = ([v.half() for v in levels], wts.half(), (1, 2), 1)
    return {
        "busca": lambda: BuscaModel(BuscaConfig(**TEST_BF16,
                                                dtype="float16")),
        "yolox": lambda: YOLOX(YoloxConfig.size("tiny", dtype="float16")),
        "transcenter": lambda: TransCenterDETR(
            TransCenterConfig.tiny(dtype="float64")),
        "k2": lambda: local_tap_sum_levels(*half),
        "k2_wrapper": lambda: local_tap_sum_levels_cuda(*half),
        "k2_mixed": lambda: local_tap_sum_levels_cuda(
            levels, wts.bfloat16(), (1, 2), 1),
        "engine": lambda: AssociationEngine(
            BuscaConfig(**TEST_BF16, dtype=BF16),
            BuscaModel(BuscaConfig(**TEST_BF16))),
    }[what]


@pytest.mark.parametrize("what", ["busca", "yolox", "transcenter", "k2",
                                  "k2_wrapper", "k2_mixed", "engine"])
def test_other_dtypes_raise(what):
    """float16 and float64 are refused everywhere (busca_tpu has float32
    and bfloat16 only), a mix of the two in K2's wrapper, and a model
    whose dtype is not its engine's config's."""
    with pytest.raises(ValueError, match="float32|bfloat16"):
        _build_other_dtype(what)()
