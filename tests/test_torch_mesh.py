"""The port's mesh (busca_tpu_torch.parallel.mesh) against busca_tpu's
sharding rules, and the sharded forward over gloo ranks on the CPU.

- spec by key: every parameter's spec equals busca_tpu's
  ``_spec_for_param`` of the same leaf (a flax conv kernel's dim 3 is the
  torch weight's dim 0), at tp 2 and 4, on the full-width model's shapes
  and the small one's;
- the shards: each split parameter's shard holds 1/tp of it, the packed
  ``in_proj`` by heads (each rank's q, k and v rows), and the shards
  give the whole parameter back exactly;
- the sharded associate-style forward (batch over dp, Megatron and
  channel tp) over 2 ranks (tp=2) and 4 ranks (dp=2, tp=2), spawned, each
  rank holding 1/tp of every split weight, against the single-device port
  and busca_tpu's single-device forward at shared weights: atol 2e-4
  (busca_tpu's bar, tests/test_sharded_numerics.py);
- ``dryrun_multichip(2)`` over gloo.

Spawned ranks import torch and the port only; each launch has its own
timeout and kills its ranks on failure.
"""

import jax
import numpy as np
import pytest
import torch

from busca_tpu.models.busca import BuscaConfig as JCfg
from busca_tpu.models.busca import BuscaModel as JModel
from busca_tpu.parallel.mesh import _spec_for_param as j_spec
from busca_tpu_torch.models.busca import BuscaConfig, BuscaModel
from busca_tpu_torch.models.convert import _busca_key, _leaves
from busca_tpu_torch.models.convert import state_dict_from_flax
from busca_tpu_torch.parallel.dryrun import dryrun_multichip, launch
from busca_tpu_torch.parallel.mesh import (
    _spec_for_param,
    local_devices,
    make_mesh,
    param_shardings,
    shard_tensor,
    unshard_tensor,
)

SMALL = dict(num_layer=2, reid_num_classes=7, reid_layers=(1, 1, 1, 1))
FORWARD_ATOL = 2e-4
LAUNCH_TIMEOUT_S = 240


def _flax_params(cfg: JCfg, seed=0, t=2, l_mem=3, c=2, hw=(64, 32)):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(np.asarray, jax.jit(JModel(cfg).init)(
        jax.random.PRNGKey(seed),
        rng.randn(t, l_mem, *hw, 3).astype(np.float32),
        rng.randn(t, c, *hw, 3).astype(np.float32),
        np.zeros((t, l_mem, 4), np.float32),
        np.zeros((t, c, 4), np.float32)))["params"]


@pytest.fixture(scope="module")
def small_params():
    return _flax_params(JCfg(**SMALL))


def _torch_spec_of(jspec, is_conv):
    spec = tuple(jspec)
    if is_conv:  # [kh, kw, cin, cout] -> [cout, cin, kh, kw]
        spec = (spec[3], spec[2], spec[0], spec[1])
    return spec


@pytest.mark.parametrize("tp", [2, 4])
def test_spec_by_key_matches_busca_tpu(small_params, tp):
    """Every leaf of busca_tpu's tree against the port's parameter of the
    same key; the full-width ResNet-50's convolutions too (shapes only)."""
    checked = split = 0
    for path, value in _leaves(small_params):
        key, is_conv = _busca_key(path)
        torch_shape = (value.transpose(3, 2, 0, 1).shape if is_conv
                       else value.shape)
        got = _spec_for_param(key, torch.empty(torch_shape), tp)
        want = _torch_spec_of(j_spec(("params",) + path, value, tp), is_conv)
        assert got == want, key
        checked += 1
        split += "tp" in got
    assert checked > 60 and split > 30
    # the full-width model, on a meta device (shapes, no memory)
    with torch.device("meta"):
        full = BuscaModel(BuscaConfig())
    names = param_shardings(full, None)  # tp 1: every rule's shape check
    assert names["transformer_encoder.layers.3.linear1.weight"] == (
        "tp", None)
    for name, p in full.named_parameters():
        if name.startswith("reid_encoder") and p.dim() == 4:
            flax = torch.empty(p.shape[2], p.shape[3], p.shape[1],
                               p.shape[0], device="meta")
            assert _spec_for_param(name, p, tp) == _torch_spec_of(
                j_spec(("params", "reid_encoder", "x", "kernel"), flax, tp),
                True), name


@pytest.mark.parametrize("tp", [2, 4])
def test_shards_hold_one_tp_th_and_reassemble(tp):
    model = BuscaModel(BuscaConfig(**SMALL))
    model.init_weights(torch.Generator().manual_seed(0))
    specs = param_shardings(model, None)
    n_split = 0
    for name, p in model.named_parameters():
        spec = _spec_for_param(name, p, tp)
        shards = [shard_tensor(name, p.data, spec, tp, r) for r in range(tp)]
        if "tp" in spec:
            n_split += 1
            dim = spec.index("tp")
            assert all(s.shape[dim] * tp == p.shape[dim] for s in shards)
        assert torch.equal(unshard_tensor(name, shards, spec), p.data)
    assert n_split == sum("tp" in s for s in specs.values())
    # in_proj by heads: rank r holds rows [r d/tp, (r+1) d/tp) of q, k, v
    w = torch.arange(3 * 8 * 2, dtype=torch.float32).reshape(24, 2)
    got = shard_tensor("x.self_attn.in_proj_weight", w, ("tp", None), 2, 1)
    assert torch.equal(got, torch.cat([w[4:8], w[12:16], w[20:24]]))


def test_mesh_and_device_refusals():
    with pytest.raises(RuntimeError, match="initialized process group"):
        make_mesh()
    assert local_devices(3, "cpu") == [torch.device("cpu")] * 3
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="visible"):
            local_devices(2, "cuda")
    with pytest.raises(ValueError):
        local_devices(0, "cpu")


def _forward_inputs(t, seed=2):
    rng = np.random.RandomState(seed)

    def boxes(n):
        xy = rng.uniform(0, 400, (t, n, 2))
        wh = rng.uniform(10, 80, (t, n, 2))
        return np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)

    return dict(mem_crops=rng.randn(t, 3, 64, 32, 3).astype(np.float32),
                can_crops=rng.randn(t, 2, 64, 32, 3).astype(np.float32),
                mem_boxes=boxes(3), can_boxes=boxes(2),
                mask=np.ones((t,), np.float32))


@pytest.fixture(scope="module")
def forward_reference(small_params, tmp_path_factory):
    """The shared weights and inputs on disk, the port's single-device
    probabilities and busca_tpu's (jitted)."""
    root = tmp_path_factory.mktemp("forward")
    state = state_dict_from_flax({"params": small_params})
    torch.save(state, root / "state.pt")
    inputs = _forward_inputs(8)
    np.savez(root / "inputs.npz", **inputs)
    model = BuscaModel(BuscaConfig(**SMALL))
    model.load_state_dict(state, strict=False)
    with torch.no_grad():
        single = torch.softmax(model(*[torch.from_numpy(v)
                                       for v in inputs.values()]), -1)
    jmodel = JModel(JCfg(**SMALL))
    jax_single = np.asarray(jax.jit(lambda p, *a: jax.nn.softmax(
        jmodel.apply({"params": p}, *a), axis=-1))(
        small_params, *inputs.values()))
    return root, dict(model.named_parameters()), single.numpy(), jax_single


@pytest.mark.parametrize("ranks,tp", [(2, 2), (4, 2)],
                         ids=["dp1-tp2", "dp2-tp2"])
def test_sharded_forward_matches_single_device(forward_reference, ranks, tp):
    root, whole, single, jax_single = forward_reference
    launch(ranks, "forward", dict(config=SMALL, state=str(root / "state.pt"),
                                  inputs=str(root / "inputs.npz"),
                                  out=str(root / f"out{ranks}.pt"), tp=tp),
           timeout=LAUNCH_TIMEOUT_S, backend="gloo")
    out = torch.load(root / f"out{ranks}.pt", weights_only=False)
    np.testing.assert_allclose(out["probs"].numpy(), single, rtol=0,
                               atol=FORWARD_ATOL)
    np.testing.assert_allclose(out["probs"].numpy(), jax_single, rtol=0,
                               atol=FORWARD_ATOL)
    for shapes in out["local_shapes"]:
        for name, shape in shapes.items():
            spec = _spec_for_param(name, whole[name], tp)
            want = list(whole[name].shape)
            if "tp" in spec:
                want[spec.index("tp")] //= tp
            assert shape == want, name


def test_dryrun_multichip_over_gloo():
    line = dryrun_multichip(2, timeout=LAUNCH_TIMEOUT_S)
    assert line.startswith("dryrun_multichip ok: gloo")
