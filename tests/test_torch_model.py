"""The port's models (busca_tpu_torch.models) against busca_tpu's flax
modules on the CPU, with shared weights through the weight bridge.

Tolerances: bucket indices exactly; positional encodings to 1e-3 (the fp16
round-trip can move a value by one fp16 step when the float32 sinusoids
differ in their last bits); the Transformer's outputs and attention and the
BatchNorm modes to 1e-5 (float32, different reduction orders); ReID features
and BUSCA logits to 1e-4 (float32 convolutions in different libraries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from busca_tpu.models import encodings as jenc
from busca_tpu.models.busca import BuscaConfig as JCfg
from busca_tpu.models.busca import BuscaModel as JModel
from busca_tpu.models.convert import (
    convert_busca_state_dict,
    convert_resnet_state_dict,
)
from busca_tpu.models.reid import BatchNorm as JBatchNorm
from busca_tpu.models.reid import ReIDResNet as JReID
from busca_tpu.models.transformer import TransformerEncoder as JEncoder
from busca_tpu_torch.models import encodings as tenc
from busca_tpu_torch.models.busca import BuscaConfig, BuscaModel
from busca_tpu_torch.models.convert import (
    load_into,
    resnet_state_dict_from_flax,
    state_dict_from_flax,
)
from busca_tpu_torch.models.reid import BatchNorm, ReIDResNet
from busca_tpu_torch.models.transformer import TransformerEncoder

CROP = (64, 32)
SMALL = dict(num_layer=2, nhead=4, trans_dim=64, ff_size=128,
             reid_layers=(1, 1, 1, 1), reid_num_classes=7)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _random_boxes(rng, shape):
    xy = rng.uniform(0, 300, shape + (2,))
    wh = rng.uniform(10, 120, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# ---------------------------------------------------------------- encodings --

def test_bucket_indices_equal():
    rng = np.random.RandomState(0)
    boxes = _random_boxes(rng, (4, 9))
    boxes[:, 3] = jenc.missing_candidate_bbox("ltwh")  # the BAD sentinel
    boxes[:, 4] = jenc.missing_candidate_bbox("ltrb")
    ref = boxes[:, -1:, :]
    jxy, jsize = jenc.spatial_indices(jnp.asarray(boxes), jnp.asarray(ref))
    txy, tsize = tenc.spatial_indices(torch.from_numpy(boxes),
                                      torch.from_numpy(ref))
    np.testing.assert_array_equal(np.asarray(jxy), txy.numpy())
    np.testing.assert_array_equal(np.asarray(jsize), tsize.numpy())
    for mem_len, n_can in ((11, 7), (5, 4), (40, 3)):
        for a, b in zip(jenc.temporal_indices(mem_len, n_can),
                        tenc.temporal_indices(mem_len, n_can)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("flavour", ["MEM-SEP-CAN-BAD", "MEM-CAN-SEP",
                                     "CLS-MEM-SEP-CAN-BAD"])
def test_positional_encodings_match(flavour):
    rng = np.random.RandomState(1)
    mem = _random_boxes(rng, (3, 6))
    can = _random_boxes(rng, (3, 4))
    can[:, 2] = np.asarray(
        jenc.missing_candidate_bbox("ltwh"), np.float32)  # missing slot
    want_fake = jenc.insert_fake_bboxes(jnp.asarray(can),
                                        jnp.asarray(mem[:, -1:]), flavour)
    got_fake = tenc.insert_fake_bboxes(torch.from_numpy(can),
                                       torch.from_numpy(mem[:, -1:]), flavour)
    np.testing.assert_array_equal(np.asarray(want_fake), got_fake.numpy())
    jm, jc = jenc.positional_encodings(jnp.asarray(mem), jnp.asarray(can),
                                       64, flavour)
    tm, tc = tenc.positional_encodings(torch.from_numpy(mem),
                                       torch.from_numpy(can), 64, flavour)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=1e-3)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-3)


# -------------------------------------------------------------- transformer --

def test_transformer_outputs_and_attention_match():
    rng = np.random.RandomState(2)
    x = rng.randn(3, 10, 64).astype(np.float32)
    jmod = JEncoder(num_layers=2, d_model=64, nhead=4, dim_feedforward=128)
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    jout, jatt = jax.jit(jmod.apply, static_argnames=("return_att",))(
        variables, jnp.asarray(x), return_att=True)

    sd = state_dict_from_flax(
        {"params": {"transformer_encoder": _np_tree(variables["params"])}})
    tmod = TransformerEncoder(2, 64, 4, 128)
    tmod.load_state_dict({k[len("transformer_encoder."):]: v
                          for k, v in sd.items()})
    with torch.no_grad():
        tout, tatt = tmod(torch.from_numpy(x), return_att=True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)
    for a, b in zip(tatt, jatt):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)


# ---------------------------------------------------------------- batchnorm --

def _bn_inputs():
    rng = np.random.RandomState(3)
    x = (rng.randn(6, 5, 4, 8) * 3 + 1).astype(np.float32)  # NHWC
    weight = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.randn(8).astype(np.float32)
    return rng, x, weight, bias


@pytest.mark.parametrize("mode", ["none", "mask", "groups", "frozen"])
def test_batchnorm_modes_match(mode):
    rng, x, weight, bias = _bn_inputs()
    mask = None
    if mode == "mask":
        mask = np.array([1, 1, 0, 1, 0, 1], np.float32)
    elif mode == "groups":
        # two groups with multiplicities, one all-zero row (-> group 0)
        mask = np.array([[1, 0], [2, 0], [0, 0], [0, 1], [0, 3], [1, 0]],
                        np.float32)
    frozen = mode == "frozen"
    variables = {"params": {"weight": weight, "bias": bias}}
    running_mean = rng.randn(8).astype(np.float32)
    running_var = rng.uniform(0.2, 2.0, 8).astype(np.float32)
    if frozen:
        variables["batch_stats"] = {"running_mean": running_mean,
                                    "running_var": running_var}
    jbn = JBatchNorm(8, use_batch_stats=not frozen)
    want = np.asarray(jbn.apply(variables, jnp.asarray(x),
                                None if mask is None else jnp.asarray(mask)))

    tbn = BatchNorm(8, use_batch_stats=not frozen)
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(weight))
        tbn.bias.copy_(torch.from_numpy(bias))
        tbn.running_mean.copy_(torch.from_numpy(running_mean))
        tbn.running_var.copy_(torch.from_numpy(running_var))
        got = tbn(torch.from_numpy(x).permute(0, 3, 1, 2),
                  None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-5)


# --------------------------------------------------------------------- reid --

@pytest.fixture(scope="module")
def reid_pair():
    jmod = JReID(layers=(1, 1, 1, 1), num_classes=7)
    x0 = np.zeros((2,) + CROP + (3,), np.float32)
    variables = _np_tree(jax.jit(jmod.init)(jax.random.PRNGKey(1),
                                            jnp.asarray(x0)))
    tmod = ReIDResNet(layers=(1, 1, 1, 1), num_classes=7)
    tmod.load_state_dict(resnet_state_dict_from_flax(variables),
                         strict=False)
    return jmod, variables, tmod.eval()


@pytest.mark.parametrize("mask_kind", ["none", "mask", "groups"])
def test_reid_features_match(reid_pair, mask_kind):
    jmod, variables, tmod = reid_pair
    rng = np.random.RandomState(4)
    x = rng.randn(6, *CROP, 3).astype(np.float32)
    mask = {"none": None,
            "mask": np.array([1, 1, 1, 0, 1, 0], np.float32),
            "groups": np.array([[1, 0], [1, 0], [0, 0], [0, 2], [0, 1],
                                [1, 0]], np.float32)}[mask_kind]
    jl, jf = jax.jit(jmod.apply)(variables, jnp.asarray(x),
                                 None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        tl, tf = tmod(torch.from_numpy(x),
                      None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-4)
    # the classifier logits (unused by BUSCA) are unnormalized, |l| ~ 100,
    # and amplify the float32 differences of the features: 1e-3 relative
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3,
                               atol=1e-3)


def test_resnet_bridge_round_trip(reid_pair):
    _, variables, _ = reid_pair
    sd = {k: v.numpy() for k, v in resnet_state_dict_from_flax(
        variables).items()}
    back = convert_resnet_state_dict(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(back["params"])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(variables["params"]))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(leaf, flat_b[path])


# -------------------------------------------------------------------- busca --

@pytest.fixture(scope="module")
def busca_pair():
    cfg = JCfg(**SMALL)
    jmod = JModel(cfg)
    h, w = CROP
    variables = _np_tree(jax.jit(jmod.init)(
        jax.random.PRNGKey(2),
        np.zeros((1, 5, h, w, 3), np.float32),
        np.zeros((1, 3, h, w, 3), np.float32),
        np.zeros((1, 5, 4), np.float32),
        np.zeros((1, 3, 4), np.float32),
    ))
    tmod = BuscaModel(BuscaConfig(**SMALL))
    load_into(tmod, state_dict_from_flax(variables))
    return jmod, variables, tmod.eval()


def _busca_inputs(rng, b=4, l_mem=5, c=3, u=6):
    h, w = CROP
    mem = rng.randn(b, l_mem, h, w, 3).astype(np.float32)
    uniq = rng.randn(u, h, w, 3).astype(np.float32)
    gather = rng.randint(0, u, (b, c)).astype(np.int32)
    weights = np.bincount(gather[:3].ravel(), minlength=u).astype(np.float32)
    mem_boxes = _random_boxes(rng, (b, l_mem))
    can_boxes = _random_boxes(rng, (b, c))
    can_boxes[0, 2] = jenc.missing_candidate_bbox("ltrb")
    mask = np.array([1, 1, 1, 0], np.float32)
    return mem, uniq, gather, weights, mem_boxes, can_boxes, mask


@pytest.mark.parametrize("mode", ["dedup", "duplicated"])
def test_busca_logits_match(busca_pair, mode):
    jmod, variables, tmod = busca_pair
    rng = np.random.RandomState(5)
    mem, uniq, gather, weights, mb, cb, mask = _busca_inputs(rng)
    if mode == "dedup":
        jkw = dict(can_weights=jnp.asarray(weights),
                   can_gather=jnp.asarray(gather))
        tkw = dict(can_weights=torch.from_numpy(weights),
                   can_gather=torch.from_numpy(gather))
        can = uniq
    else:
        jkw, tkw = {}, {}
        can = uniq[gather]
    apply = jax.jit(jmod.apply, static_argnames=("return_att",))
    want, watt = apply(variables, jnp.asarray(mem), jnp.asarray(can),
                       jnp.asarray(mb), jnp.asarray(cb), jnp.asarray(mask),
                       return_att=True, **jkw)
    with torch.no_grad():
        got, gatt = tmod(torch.from_numpy(mem), torch.from_numpy(can),
                         torch.from_numpy(mb), torch.from_numpy(cb),
                         torch.from_numpy(mask), return_att=True, **tkw)
    assert got.shape == (4, 3 + 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(gatt[-1].numpy(), np.asarray(watt[-1]),
                               rtol=0, atol=1e-4)


def test_dedup_equals_duplicated(busca_pair):
    """The multiplicity-weighted unique batch gives the duplicated batch's
    logits (weights = slot counts over the real tracks)."""
    _, _, tmod = busca_pair
    rng = np.random.RandomState(6)
    mem, uniq, gather, weights, mb, cb, mask = _busca_inputs(rng)
    args = [torch.from_numpy(a) for a in (mem,)]
    with torch.no_grad():
        a = tmod(args[0], torch.from_numpy(uniq), torch.from_numpy(mb),
                 torch.from_numpy(cb), torch.from_numpy(mask),
                 can_weights=torch.from_numpy(weights),
                 can_gather=torch.from_numpy(gather))
        b = tmod(args[0], torch.from_numpy(uniq[gather]),
                 torch.from_numpy(mb), torch.from_numpy(cb),
                 torch.from_numpy(mask))
    np.testing.assert_allclose(a[:3].numpy(), b[:3].numpy(), rtol=0,
                               atol=1e-4)


def test_busca_bridge_round_trip(busca_pair):
    """state_dict_from_flax is the inverse of convert_busca_state_dict."""
    _, variables, tmod = busca_pair
    sd = {k: v.numpy() for k, v in state_dict_from_flax(variables).items()}
    assert set(sd) <= set(tmod.state_dict())
    back = convert_busca_state_dict(sd, ignore_reid_fc=False)
    flat_a = jax.tree_util.tree_leaves_with_path(back["params"])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(variables["params"]))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(leaf, flat_b[path])


def _busca_yaml(path):
    import yaml

    transformer = dict(SMALL, reid_layers=list(SMALL["reid_layers"]))
    with open(path, "w") as f:
        yaml.safe_dump({"transformer": transformer,
                        "tracker": {"seq_len": 5, "num_candidates": 3}}, f)
    return str(path)


@pytest.mark.parametrize("case", ["fc_11_classes", "no_bad_token"])
def test_reference_pth_loads_like_jax(busca_pair, tmp_path, case):
    """A reference ``.pth`` that busca_tpu loads loads in the port too, and
    both packages' ``build_engine`` give the same logits.  An 11-class ReID
    ``fc`` (the config says 7) is dropped by both; a checkpoint without
    ``bad_token`` leaves each package's token at its own initial value, so
    the port's must equal its seeded init, and the logits are diffed with
    JAX's initial token copied in."""
    from busca_tpu.eval import run as jrun
    from busca_tpu_torch.eval import run as trun

    _, variables, _ = busca_pair
    sd = state_dict_from_flax(variables)
    if case == "fc_11_classes":
        feat = sd["reid_encoder.model.fc.weight"].shape[1]
        g = torch.Generator().manual_seed(9)
        sd["reid_encoder.model.fc.weight"] = torch.randn((11, feat),
                                                         generator=g)
        sd["reid_encoder.model.fc.bias"] = torch.randn((11,), generator=g)
    else:
        del sd["bad_token"]
    pth = str(tmp_path / "model_busca.pth")
    torch.save({"model_state_dict": sd}, pth)
    cfg = _busca_yaml(tmp_path / "busca.yml")
    jeng, _ = jrun.build_engine(cfg, pth, CROP, dtype="float32")
    teng, _ = trun.build_engine(cfg, pth, device="cpu", crop_hw=CROP,
                                seed=0)
    tmod = teng.model
    if case == "no_bad_token":
        init = BuscaModel(BuscaConfig(**SMALL)).init_weights(
            torch.Generator().manual_seed(0))
        assert torch.equal(tmod.bad_token, init.bad_token)
        with torch.no_grad():
            tmod.bad_token.copy_(torch.from_numpy(
                np.array(jeng.variables["params"]["bad_token"])))
    np.testing.assert_array_equal(
        tmod.non_token.detach().numpy(),
        np.asarray(jeng.variables["params"]["non_token"]))
    rng = np.random.RandomState(8)
    mem, uniq, gather, _, mb, cb, mask = _busca_inputs(rng)
    can = uniq[gather]
    want = jeng.model.apply(jeng.variables, jnp.asarray(mem),
                            jnp.asarray(can), jnp.asarray(mb),
                            jnp.asarray(cb), jnp.asarray(mask))
    with torch.no_grad():
        got = tmod(torch.from_numpy(mem), torch.from_numpy(can),
                   torch.from_numpy(mb), torch.from_numpy(cb),
                   torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_frozen_bn_variables_round_trip():
    cfg = JCfg(**SMALL, reid_use_batch_stats=False)
    h, w = CROP
    variables = _np_tree(jax.jit(JModel(cfg).init)(
        jax.random.PRNGKey(3),
        np.zeros((1, 5, h, w, 3), np.float32),
        np.zeros((1, 3, h, w, 3), np.float32),
        np.zeros((1, 5, 4), np.float32),
        np.zeros((1, 3, 4), np.float32),
    ))
    sd = state_dict_from_flax(variables)
    assert "reid_encoder.model.layer1.0.bn1.running_var" in sd
    back = convert_busca_state_dict({k: v.numpy() for k, v in sd.items()},
                                    ignore_reid_fc=False)
    flat_a = jax.tree_util.tree_leaves_with_path(back["batch_stats"])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(
        variables["batch_stats"]))
    assert len(flat_a) == len(flat_b) > 0
    for path, leaf in flat_a:
        np.testing.assert_array_equal(leaf, flat_b[path])


def test_seeded_init_is_reproducible():
    a = BuscaModel(BuscaConfig(**SMALL)).init_weights(
        torch.Generator().manual_seed(4))
    b = BuscaModel(BuscaConfig(**SMALL)).init_weights(
        torch.Generator().manual_seed(4))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert float(a.non_token.detach().abs().sum()) > 0
