"""TransCenter's published deformable decoder in the port against the plain
float32 reference of the benchmark (``benchmark/benchref/transcenter.py``:
plain torch, MSDA as Deformable DETR's ``grid_sample`` formula, loaded here
by path), on the CPU at ``TransCenterConfig.tiny(sampling="deformable")``.

The weights are seeded draws for every parameter, biases and LayerNorm
scales included; the offset biases are Deformable DETR's grid (head h
along its own direction, point p at p + 1 level pixels) and the offset
kernels are drawn, so samples leave the smaller levels.

Bounds:

- MSDA alone: 1e-5.  The port samples with explicit floors and
  ``index_select``; the reference through ``grid_sample``, whose
  coordinate ``((2 loc - 1 + 1) w - 1) / 2`` rounds apart from the port's
  ``loc w - 0.5`` in the last bits, and sums the levels in another order.
- The five maps: 1e-4.  The same samples are summed in another order
  through every layer, and each layer's sampling positions come from the
  previous layer's queries, so the last-bit gaps grow through the stack.
- Decoded detections after the score filter and the NMS: equal counts,
  boxes within 1e-3 canvas pixels.
- The port at ``dtype="bfloat16"`` must fall outside the maps' bound.
"""

import dataclasses
import math
import os
import sys

import numpy as np
import pytest
import torch

from busca_tpu_torch.eval.detector import TransCenterDetector
from busca_tpu_torch.models import transcenter as ttc
from busca_tpu_torch.ops.deform import multi_scale_deformable_attention
from test_torch_strongsort import one_torch_thread  # noqa: F401

sys.path.append(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark"))
from benchref import transcenter as ref  # noqa: E402

MSDA_TOL = 1e-5
MAP_TOL = 1e-4
BOX_TOL = 1e-3
IN_HW = (48, 80)  # levels 12x20, 6x10, 3x5, 2x3: SAME pads the first
OUT_THRESH = 0.3


def config(**kw):
    return ttc.TransCenterConfig.tiny(sampling="deformable", K=24,
                                      clip=True, **kw)


def reference_config(cfg) -> "ref.TransCenterConfig":
    names = {f.name for f in dataclasses.fields(ref.TransCenterConfig)}
    return ref.TransCenterConfig(**{k: v for k, v in
                                    dataclasses.asdict(cfg).items()
                                    if k in names})


def offset_grid(heads: int, levels: int, points: int) -> torch.Tensor:
    """Deformable DETR's offset bias: head h's direction, point p at p + 1
    level pixels along it."""
    theta = torch.arange(heads, dtype=torch.float32) * (2 * math.pi / heads)
    g = torch.stack([theta.cos(), theta.sin()], -1)
    g = g / g.abs().max(-1, keepdim=True).values
    g = g[:, None, None, :].repeat(1, levels, points, 1)
    return (g * torch.arange(1, points + 1, dtype=torch.float32)[
        None, None, :, None]).reshape(-1)


def random_state(cfg, seed=23) -> dict:
    gen = torch.Generator().manual_seed(seed)
    model = ttc.TransCenterDETR(cfg)
    state = {}
    for name, p in model.state_dict().items():
        z = torch.randn(p.shape, generator=gen)
        if name.endswith("offsets.bias"):
            val = offset_grid(cfg.dec_heads, 4, cfg.dec_n_points) + 0.3 * z
        elif p.dim() >= 2:
            val = z / math.sqrt(int(np.prod(p.shape[1:])))
            if name.endswith("offsets.weight"):
                val = val * 2.0
        elif name.startswith("level_embed_"):
            val = 0.02 * z
        elif name.endswith("weight"):  # LayerNorm scales
            val = 1.0 + 0.1 * z
        else:
            val = 0.1 * z
        state[name] = val
    state["hm_out.bias"] = torch.zeros_like(state["hm_out.bias"])
    state["wh_out.bias"] = torch.tensor([6.0, 10.0])
    return state


@pytest.fixture(scope="module")
def models():
    cfg = config()
    state = random_state(cfg)
    port = ttc.TransCenterDETR(cfg).eval()
    port.load_state_dict(state)
    plain = ref.TransCenterDETR(reference_config(cfg)).eval()
    plain.load_state_dict(state)
    return cfg, state, port, plain


def inputs(seed=5):
    rng = np.random.RandomState(seed)
    h, w = IN_HW
    return (torch.from_numpy(rng.randn(1, h, w, 3).astype(np.float32)),
            torch.from_numpy(rng.randn(1, h, w, 3).astype(np.float32)),
            torch.from_numpy(rng.rand(1, h // 4, w // 4, 1).astype(
                np.float32)))


def test_msda_matches_the_grid_sample_formula(one_torch_thread):  # noqa: F811
    """The port's MSDA against ``ms_deform_attn_core_pytorch`` at a ragged
    pyramid (a 1x1 level among them), locations in [-0.3, 1.3]."""
    rng = np.random.RandomState(3)
    shapes = [(7, 9), (4, 5), (2, 3), (1, 1)]
    b, heads, d, points, lq = 2, 4, 8, 3, 13
    value = torch.from_numpy(rng.randn(
        b, sum(h * w for h, w in shapes), heads, d).astype(np.float32))
    loc = torch.from_numpy(rng.uniform(-0.3, 1.3, (
        b, lq, heads, len(shapes), points, 2)).astype(np.float32))
    logits = torch.from_numpy(rng.randn(b, lq, heads, len(shapes) * points)
                              .astype(np.float32))
    w = logits.softmax(-1).reshape(b, lq, heads, len(shapes), points)
    got = multi_scale_deformable_attention(value, shapes, loc, w)
    want = ref.ms_deform_attn_core_pytorch(value, shapes, loc, w)
    assert got.shape == want.shape == (b, lq, heads * d)
    gap = float((got - want).abs().max())
    assert gap <= MSDA_TOL, gap
    assert float(want.abs().max()) > 0.1


def _map_gap(got, want) -> float:
    assert set(got) == set(want) == set(ttc.HEADS)
    gap = 0.0
    for k in want:
        assert got[k].shape == want[k].shape, k
        gap = max(gap, float((got[k].float() - want[k]).abs().max()))
    return gap


def test_samples_leave_the_levels(models):
    """The drawn offsets put some of the first layer's samples off the
    smaller levels (where both sides read zeros)."""
    cfg, _state, port, _plain = models
    seen = []
    orig = ttc.multi_scale_deformable_attention

    def spy(value, shapes, loc, w):
        seen.append(((loc < 0) | (loc > 1)).any(-1).float().mean().item())
        return orig(value, shapes, loc, w)

    ttc.multi_scale_deformable_attention = spy
    try:
        with torch.no_grad():
            port(*inputs())
    finally:
        ttc.multi_scale_deformable_attention = orig
    assert len(seen) == 2 * cfg.num_decoder_layers
    assert 0.0 < seen[0] < 0.9


def test_model_maps_match_the_reference(models,
                                        one_torch_thread):  # noqa: F811
    _cfg, _state, port, plain = models
    args = inputs()
    with torch.no_grad():
        got, want = port(*args), plain(*args)
    gap = _map_gap(got, want)
    assert gap <= MAP_TOL, gap
    assert float(want["hm"].abs().max()) > 0.1


def test_bf16_port_falls_outside_the_bound(models,
                                           one_torch_thread):  # noqa: F811
    """The maps' bound catches a lower precision: the port's model in
    bf16 on the same weights."""
    cfg, state, _port, plain = models
    low = ttc.TransCenterDETR(dataclasses.replace(cfg, dtype="bfloat16"))
    low.load_state_dict(state)
    args = inputs()
    with torch.no_grad():
        gap = _map_gap(low.eval()(*args), plain(*args))
    assert gap > MAP_TOL, gap


def test_detections_match_the_reference(models,
                                        one_torch_thread):  # noqa: F811
    """Two frames through the port's ``TransCenterDetector`` (letterbox,
    model, decode with top-K and clip, score filter, NMS) and the
    reference's: the second frame with the first's boxes fed back as
    priors and the first's canvas as the previous frame."""
    cfg, state, _port, plain = models
    det = TransCenterDetector(cfg, state_dict=state, test_size=IN_HW,
                              out_thresh=OUT_THRESH, device="cpu")
    rdet = ref.RefTransCenter(plain, IN_HW, OUT_THRESH)
    rng = np.random.RandomState(9)
    frames = [rng.randint(0, 256, (60, 90, 3)).astype(np.uint8)
              for _ in range(2)]
    pre, pos, counts = None, None, []
    for frame in frames:
        out = det.detect(frame, current_pos=pos)
        boxes, scores = rdet.detect(frame, pre, pos)
        assert len(out.boxes_tlbr) == len(boxes) > 0
        np.testing.assert_allclose(out.boxes_tlbr, boxes * out.scale,
                                   rtol=0, atol=BOX_TOL)
        np.testing.assert_allclose(out.scores, scores, rtol=0, atol=MAP_TOL)
        pre = rdet.canvas(frame)[0]
        pos = out.boxes_tlbr.astype(np.float32)
        counts.append(len(boxes))
    assert counts[1] > 0
