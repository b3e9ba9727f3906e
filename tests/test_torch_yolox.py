"""The port's YOLOX (busca_tpu_torch.models.yolox) and postprocess
(ops/nms.py::yolox_postprocess) against busca_tpu's on the CPU.

Two small models, each at 64x96 and 128x224: depth 0.33, width 0.125, one
class, with busca_tpu's ``init_variables`` carried to the port through
``yolox_state_dict_from_flax``; and width 0.25, two classes, with the
port's seeded init carried to busca_tpu through ``convert_yolox_state_dict``.
Every BN statistic and bias is drawn at random first, so that each one is
checked in its place.

Tolerances: raw head outputs and decoded rows within 1e-4 relative and 1e-4
absolute (float32 convolutions in two libraries; measured ~1e-6).  The
postprocess's rows and ``valid`` must be equal exactly: both packages
select, sort and gather the same float32 values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from busca_tpu.eval import detector as jdetector
from busca_tpu.models.yolox import YOLOX as JYOLOX
from busca_tpu.models.yolox import YoloxConfig as JConfig
from busca_tpu.models.yolox import convert_yolox_state_dict
from busca_tpu.ops.nms import yolox_postprocess as j_postprocess
from busca_tpu_torch.eval import detector as tdetector
from busca_tpu_torch.models.convert import yolox_state_dict_from_flax
from busca_tpu_torch.models.yolox import YOLOX, YoloxConfig
from busca_tpu_torch.ops.nms import nms_fixed_steps, yolox_postprocess

SIZES = [(64, 96), (128, 224)]
TOL = 1e-4
CONFIGS = {"w0.125_c1": (0.33, 0.125, 1), "w0.25_c2": (0.33, 0.25, 2)}
ROWS_800x1440 = 23_625  # 100x180 + 50x90 + 25x45 cells


def _randomize(variables, seed):
    """Every leaf redrawn: kernels normal/sqrt(fan_in), BN scales and
    variances in [0.5, 1.5], shifts, means and biases normal * 0.1."""
    rng = np.random.RandomState(seed)

    def draw(path, x):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(x.shape[:-1]))
            return (rng.randn(*x.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("weight", "running_var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (rng.randn(*x.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


@pytest.fixture(scope="module")
def models():
    """name -> (JAX config, JAX variables, port model)."""
    out = {}
    d, w, c = CONFIGS["w0.125_c1"]
    jcfg = JConfig(depth=d, width=w, num_classes=c)
    variables = _randomize(jax.tree_util.tree_map(
        np.asarray, jdetector.init_variables(jcfg, SIZES[0])), 1)
    tmod = YOLOX(YoloxConfig(depth=d, width=w, num_classes=c))
    tdetector.load_published_state_dict(tmod, yolox_state_dict_from_flax(
        variables), "YOLOX")
    out["w0.125_c1"] = (jcfg, variables, tmod.eval())

    d, w, c = CONFIGS["w0.25_c2"]
    tmod = YOLOX(YoloxConfig(depth=d, width=w, num_classes=c))
    tmod.init_weights(torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, t in list(tmod.named_parameters()) + list(
                tmod.named_buffers()):
            if name.endswith(("running_var", "bn.weight")):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            elif name.endswith(("running_mean", "bias")):
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)
    jcfg = JConfig(depth=d, width=w, num_classes=c)
    sd = {k: v.numpy() for k, v in tmod.state_dict().items()}
    out["w0.25_c2"] = (jcfg, convert_yolox_state_dict(sd, jcfg), tmod.eval())
    return out


@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_head_and_decode_match_jax(models, name, hw):
    jcfg, variables, tmod = models[name]
    x = np.random.RandomState(4).randn(1, *hw, 3).astype(np.float32)
    apply = jax.jit(JYOLOX(jcfg).apply, static_argnames=("decode",))
    jraw = apply(variables, jnp.asarray(x), decode=False)
    jrows = np.asarray(apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        traw = tmod(xt, decode=False)
        trows = tmod(xt).numpy()
    for (jr, jo, jc), (tr, to, tc) in zip(jraw, traw):
        for a, b in ((jr, tr), (jo, to), (jc, tc)):
            np.testing.assert_allclose(b.permute(0, 2, 3, 1).numpy(),
                                       np.asarray(a), rtol=TOL, atol=TOL)
    n = sum((hw[0] // s) * (hw[1] // s) for s in (8, 16, 32))
    assert trows.shape == (1, n, 5 + jcfg.num_classes)
    np.testing.assert_allclose(trows, jrows, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_state_dict_round_trip_is_exact(models, name):
    """port state dict -> flax -> port state dict, and flax -> port ->
    flax, both bit for bit."""
    jcfg, variables, tmod = models[name]
    sd = {k: v for k, v in tmod.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    back = yolox_state_dict_from_flax(convert_yolox_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jcfg))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    flax_back = convert_yolox_state_dict(
        {k: v.numpy() for k, v in yolox_state_dict_from_flax(
            variables).items()}, jcfg)
    flat_a = jax.tree_util.tree_leaves_with_path(flax_back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(leaf, flat_b[path])


def _predictions(seed, n=ROWS_800x1440, num_classes=2):
    """Seeded rows at the 800x1440 row count: clustered boxes (so that
    suppression chains form), obj and class scores on a coarse grid (many
    exact ties, class ties among them), and ~3000 rows above 0.1, more than
    pre_nms_topk."""
    rng = np.random.RandomState(seed)
    pred = np.zeros((n, 5 + num_classes), np.float32)
    centers = rng.uniform(0, 1400, (60, 2))
    sizes = rng.uniform(10, 120, (60, 2))
    cluster = rng.randint(0, 60, n)
    pred[:, 2:4] = sizes[cluster] * rng.uniform(0.9, 1.1, (n, 2))
    pred[:, :2] = centers[cluster] + rng.normal(0, 0.05, (n, 2)) * pred[:, 2:4]
    strong = rng.rand(n) < 0.13
    pred[:, 4] = np.where(strong, rng.randint(4, 21, n) / 20.0,
                          rng.randint(0, 4, n) / 40.0)
    pred[:, 5:] = rng.randint(6, 21, (n, num_classes)) / 20.0
    if num_classes > 1:
        ties = rng.rand(n) < 0.2
        pred[ties, 6] = pred[ties, 5]  # equal class scores: the first wins
    return pred


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("num_classes", [1, 2])
def test_postprocess_equals_jax(seed, num_classes):
    pred = _predictions(seed, num_classes=num_classes)
    kw = dict(conf_threshold=0.1, nms_threshold=0.7, max_outputs=256,
              pre_nms_topk=1024)
    score = pred[:, 4] * pred[:, 5:].max(1)
    assert (score >= 0.1).sum() > 1024
    want_rows, want_valid = j_postprocess(jnp.asarray(pred), num_classes,
                                          **kw)
    rows, valid = yolox_postprocess(torch.from_numpy(pred), num_classes,
                                    **kw)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
    assert 0 < int(valid.sum()) < 256
    # the enqueue-only form: the same rows once it has converged
    srows, svalid, converged = yolox_postprocess(
        torch.from_numpy(pred), num_classes, nms_steps=8, **kw)
    assert bool(converged)
    assert torch.equal(srows, rows) and torch.equal(svalid, valid)


def test_fixed_steps_flag_reports_an_unfinished_chain():
    """A chain of boxes each overlapping the next needs one step per link:
    too few steps leave the flag False; enough steps give nms's result."""
    from busca_tpu_torch.ops.nms import nms

    n = 12
    x = torch.arange(n, dtype=torch.float32) * 4.0
    boxes = torch.stack([x, torch.zeros(n), x + 10.0,
                         torch.full((n,), 10.0)], 1)
    scores = torch.linspace(1.0, 0.5, n)
    want_idx, want_valid = nms(boxes, scores, 0.4, 16)
    _, _, converged = nms_fixed_steps(boxes, scores, 0.4, 16, steps=2)
    assert not bool(converged)
    idx, valid, converged = nms_fixed_steps(boxes, scores, 0.4, 16,
                                            steps=n)
    assert bool(converged)
    assert torch.equal(idx, want_idx) and torch.equal(valid, want_valid)


def test_official_pth_loads_in_both_packages(models, tmp_path):
    """An official-layout ``.pth`` (the module's state dict, with
    ``num_batches_tracked``) through both packages' ``YoloxDetector.build``:
    the same weights land in both."""
    tmod = YOLOX(YoloxConfig.size("tiny")).init_weights(
        torch.Generator().manual_seed(5))
    sd = tmod.state_dict()
    assert "backbone.backbone.stem.conv.conv.weight" in sd
    assert "head.cls_preds.0.bias" in sd
    assert "backbone.C3_p4.m.0.conv1.bn.running_mean" in sd
    path = str(tmp_path / "yolox_tiny.pth")
    torch.save(sd, path)
    jdet = jdetector.YoloxDetector.build(size="tiny", ckpt_path=path,
                                         test_size=(64, 96))
    want = yolox_state_dict_from_flax(jdet.variables)
    # the official training envelope, which busca_tpu's loader cannot read
    # (ROADMAP Queue 3), loads in the port too
    enveloped = str(tmp_path / "yolox_tiny.pth.tar")
    torch.save({"model": sd, "start_epoch": 3}, enveloped)
    for p in (path, enveloped):
        tdet = tdetector.YoloxDetector.build(size="tiny", ckpt_path=p,
                                             test_size=(64, 96),
                                             device="cpu")
        got = tdet.model.state_dict()
        assert set(want) == {k for k in got
                             if not k.endswith("num_batches_tracked")}
        for k, v in want.items():
            assert torch.equal(got[k], v), k
            assert torch.equal(got[k], sd[k]), k
