"""TransCenter detector family: dual-frame PVTv2 + local multi-scale decoder.

Port of ``busca_tpu.models.transcenter`` (NHWC at every public boundary, the
same parameter names as the flax tree, so that
:func:`busca_tpu_torch.models.convert.transcenter_state_dict_from_flax` is
mechanical):

- **PVTv2 pyramid encoder** (PVTv2-b2 by default: dims (64, 128, 320, 512),
  heads (1, 2, 5, 8), depths (3, 4, 6, 3), MLP ratios (8, 8, 4, 4), spatial
  reduction (8, 4, 2, 1)) over the current and the previous frame with
  shared weights.  The two frames go through it as one batch of 2.
- **Dense center queries** at stride ``down_ratio`` (4), refined by
  ``num_decoder_layers`` decoder layers of current-frame and previous-frame
  :class:`LocalMultiScaleAttention` plus an FFN.  The attention's 36-term
  weighted-tap sum is :func:`busca_tpu_torch.ops.lma.local_tap_sum`, which
  on the card is kernel K2.
- **Tracker feedback** as a Gaussian prior heatmap (``pre_hm``) embedded into
  the queries; **CenterNet-style heads** and :func:`generic_decode`.

``sampling="deformable"`` (multi-scale deformable attention,
``busca_tpu/ops/deform.py``) is not ported yet and raises.

Every LayerNorm uses flax's epsilon, 1e-6 (torch's default is 1e-5).  The
spatial-reduction convolution pads like flax's ``"SAME"``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from busca_tpu_torch.ops.lma import local_tap_sum

LN_EPS = 1e-6  # flax.linen.LayerNorm's default
HM_BIAS = -4.6  # sigmoid ~ 0.01 prior (the CenterNet focal-loss init)
FFN_RATIO = 4  # the decoder FFN's hidden width over the model width
DEFORMABLE_TODO = (
    "sampling='deformable' (multi-scale deformable attention, "
    "busca_tpu/ops/deform.py) is not ported yet: ROADMAP.md Queue 1, "
    "item 19 (Slice 5, the deformable detectors)"
)


def _layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv1x1(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 convolution on an NHWC tensor, as the matrix product it is."""
    return F.linear(x, conv.weight.flatten(1), conv.bias)


def same_padding(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA ``"SAME"`` padding of one axis: ``(low, high)``."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


# ---------------------------------------------------------------------------
# PVTv2 backbone
# ---------------------------------------------------------------------------

class OverlapPatchEmbed(nn.Module):
    """Strided-conv patch embedding (PVTv2's overlapping patches)."""

    def __init__(self, in_ch: int, dim: int, patch: int = 7, stride: int = 4):
        super().__init__()
        self.proj = nn.Conv2d(in_ch, dim, patch, stride, patch // 2)
        self.norm = _layer_norm(dim)

    def forward(self, x):  # [B, H, W, in] -> [B, H/s, W/s, dim]
        return self.norm(_nhwc(self.proj(_nchw(x))))


class SRAttention(nn.Module):
    """PVTv2 spatial-reduction attention: keys/values from a sr_ratio-strided
    reduction of the feature map, queries dense."""

    def __init__(self, dim: int, heads: int, sr_ratio: int = 1):
        super().__init__()
        self.dim, self.heads, self.sr_ratio = dim, heads, sr_ratio
        self.q = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.sr_norm = _layer_norm(dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, hw: Tuple[int, int]):
        b, n, c = x.shape
        h, w = hw
        head_dim = self.dim // self.heads
        q = self.q(x)
        if self.sr_ratio > 1:
            s = self.sr_ratio
            ph, pw = same_padding(h, s, s), same_padding(w, s, s)
            xr = F.pad(_nchw(x.reshape(b, h, w, c)), (*pw, *ph))
            xr = self.sr(xr).flatten(2).transpose(1, 2)
            xr = self.sr_norm(xr)
        else:
            xr = x
        k, v = self.kv(xr).chunk(2, dim=-1)

        def heads_split(t):
            return t.reshape(b, -1, self.heads, head_dim).transpose(1, 2)

        q, k, v = heads_split(q), heads_split(k), heads_split(v)
        attn = (q @ k.transpose(-2, -1)) / math.sqrt(head_dim)
        out = attn.softmax(dim=-1) @ v
        out = out.transpose(1, 2).reshape(b, n, self.dim)
        return self.proj(out)


class MixFFN(nn.Module):
    """PVTv2 feed-forward with a 3x3 depthwise conv between the linears."""

    def __init__(self, dim: int, ratio: int):
        super().__init__()
        hidden = dim * ratio
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = nn.Conv2d(hidden, hidden, 3, 1, 1, groups=hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, hw: Tuple[int, int]):
        b, n, _ = x.shape
        h, w = hw
        x = self.fc1(x)
        xr = self.dwconv(_nchw(x.reshape(b, h, w, -1)))
        x = F.gelu(xr.flatten(2).transpose(1, 2))
        return self.fc2(x)


class PVTv2Stage(nn.Module):
    def __init__(self, in_ch: int, dim: int, heads: int, depth: int,
                 mlp_ratio: int, sr_ratio: int, patch: int, stride: int):
        super().__init__()
        self.depth = depth
        self.embed = OverlapPatchEmbed(in_ch, dim, patch, stride)
        for i in range(depth):
            setattr(self, f"norm1_{i}", _layer_norm(dim))
            setattr(self, f"attn_{i}", SRAttention(dim, heads, sr_ratio))
            setattr(self, f"norm2_{i}", _layer_norm(dim))
            setattr(self, f"ffn_{i}", MixFFN(dim, mlp_ratio))
        self.norm = _layer_norm(dim)

    def forward(self, x):
        x = self.embed(x)
        b, h, w, c = x.shape
        t = x.reshape(b, h * w, c)
        for i in range(self.depth):
            t = t + getattr(self, f"attn_{i}")(
                getattr(self, f"norm1_{i}")(t), (h, w))
            t = t + getattr(self, f"ffn_{i}")(
                getattr(self, f"norm2_{i}")(t), (h, w))
        return self.norm(t).reshape(b, h, w, c)


class PVTv2(nn.Module):
    """4-stage pyramid; returns NHWC features at strides 4/8/16/32."""

    def __init__(self, dims=(64, 128, 320, 512), heads=(1, 2, 5, 8),
                 depths=(3, 4, 6, 3), mlp_ratios=(8, 8, 4, 4),
                 sr_ratios=(8, 4, 2, 1)):
        super().__init__()
        for s in range(4):
            setattr(self, f"stage{s}", PVTv2Stage(
                3 if s == 0 else dims[s - 1], dims[s], heads[s], depths[s],
                mlp_ratios[s], sr_ratios[s],
                patch=7 if s == 0 else 3, stride=4 if s == 0 else 2,
            ))

    def forward(self, x) -> List[torch.Tensor]:
        feats = []
        for s in range(4):
            x = getattr(self, f"stage{s}")(x)
            feats.append(x)
        return feats


# ---------------------------------------------------------------------------
# Local multi-scale decoder over dense center queries
# ---------------------------------------------------------------------------

class LocalMultiScaleAttention(nn.Module):
    """Multi-scale attention over a fixed dilated 3x3 support per level.

    Each level's values are bilinearly upsampled to the query grid; the 3x3
    level-space neighbourhood becomes 9 shifts with a dilation equal to the
    level's stride ratio; per-query weights over (level, tap, head) are
    softmaxed over level x tap.  The weighted sum is
    :func:`~busca_tpu_torch.ops.lma.local_tap_sum` (kernel K2 on the card).
    """

    def __init__(self, dim: int, heads: int = 8, levels: int = 4):
        super().__init__()
        self.dim, self.heads, self.levels = dim, heads, levels
        self.weights = nn.Linear(dim, heads * levels * 9)
        for lvl in range(levels):
            setattr(self, f"value_{lvl}", nn.Linear(dim, dim))
        self.proj = nn.Linear(dim, dim)

    def forward(self, queries, level_maps: Sequence[torch.Tensor]):
        """queries ``[B, H4, W4, C]``; level_maps: ``[B, h_l, w_l, C]``."""
        b, h4, w4, _ = queries.shape
        w = self.weights(queries).reshape(b, h4, w4, self.heads,
                                          self.levels * 9).softmax(dim=-1)
        vs, dils = [], []
        for lvl, fmap in enumerate(level_maps):
            v = getattr(self, f"value_{lvl}")(fmap)
            if v.shape[1] != h4 or v.shape[2] != w4:
                v = _nhwc(F.interpolate(_nchw(v), size=(h4, w4),
                                        mode="bilinear", align_corners=False))
            vs.append(v)
            dils.append(max(h4 // max(fmap.shape[1], 1), 1))
        vals = torch.stack(vs, dim=1)  # [B, L, H4, W4, C]
        out = torch.stack([
            local_tap_sum(vals[i].contiguous(), w[i].contiguous(),
                          tuple(dils), self.heads)
            for i in range(b)
        ])
        return self.proj(out.reshape(b, h4 * w4, self.dim))


class DecoderLayer(nn.Module):
    """Current-frame attention -> previous-frame attention -> FFN, pre-LN
    residuals.  ``sampling`` is ``"local"`` or ``"local_pallas"``: in the
    port both are the same :class:`LocalMultiScaleAttention`."""

    def __init__(self, dim: int, heads: int, levels: int = 4,
                 sampling: str = "local"):
        super().__init__()
        if sampling not in ("local", "local_pallas"):
            raise NotImplementedError(DEFORMABLE_TODO)
        self.ln1 = _layer_norm(dim)
        self.cross_cur = LocalMultiScaleAttention(dim, heads, levels)
        self.ln2 = _layer_norm(dim)
        self.cross_pre = LocalMultiScaleAttention(dim, heads, levels)
        self.ln3 = _layer_norm(dim)
        self.fc1 = nn.Linear(dim, dim * FFN_RATIO)
        self.fc2 = nn.Linear(dim * FFN_RATIO, dim)

    def forward(self, q, mem_cur, mem_pre, shapes):
        """q ``[B, H4*W4, C]``; mem_*: per-level ``[B, h_l, w_l, C]``;
        shapes: the levels' ``(h, w)``, the first being the query grid."""
        b, _, c = q.shape
        h4, w4 = shapes[0]
        q = q + self.cross_cur(self.ln1(q).reshape(b, h4, w4, c), mem_cur)
        q = q + self.cross_pre(self.ln2(q).reshape(b, h4, w4, c), mem_pre)
        h = self.fc2(F.gelu(self.fc1(self.ln3(q))))
        return q + h


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TransCenterConfig:
    """Hyperparameter surface of mot17_private.py / mot20_private.py.

    ``for_dataset("mot17"/"mot20")`` applies the per-dataset overrides (K,
    clip).  ``sampling``: "local" (default) or "local_pallas", the same math
    here; "deformable" is not ported yet.
    """

    dims: Tuple[int, ...] = (64, 128, 320, 512)
    heads: Tuple[int, ...] = (1, 2, 5, 8)
    depths: Tuple[int, ...] = (3, 4, 6, 3)
    mlp_ratios: Tuple[int, ...] = (8, 8, 4, 4)
    sr_ratios: Tuple[int, ...] = (8, 4, 2, 1)
    hidden_dim: int = 256
    num_decoder_layers: int = 6
    dec_n_points: int = 9
    dec_heads: int = 8
    down_ratio: int = 4
    num_classes: int = 1
    K: int = 300
    clip: bool = False
    reid_dim: int = 64
    dtype: str = "float32"
    sampling: str = "local"

    @classmethod
    def for_dataset(cls, name: str, **kw) -> "TransCenterConfig":
        n = name.upper()
        if n in ("MOT17", "MOT-2017", "MOT16", "MOT-2016"):
            return cls(K=300, clip=False, **kw)
        if n in ("MOT20", "MOT-2020"):
            return cls(K=500, clip=True, **kw)
        raise ValueError(f"invalid dataset name: {name}")

    @classmethod
    def tiny(cls, **kw) -> "TransCenterConfig":
        """Test-size variant (same topology, small dims/depths)."""
        defaults = dict(
            dims=(8, 16, 32, 64),
            heads=(1, 2, 4, 8),
            depths=(1, 1, 1, 1),
            mlp_ratios=(2, 2, 2, 2),
            hidden_dim=32,
            num_decoder_layers=2,
            dec_heads=4,
            dec_n_points=4,
            K=16,
            reid_dim=8,
        )
        defaults.update(kw)
        return cls(**defaults)


HEADS = ("hm", "reg", "wh", "tracking", "reid")


class TransCenterDETR(nn.Module):
    """curr + pre frames (+ prior heatmap) -> {hm, reg, wh, tracking, reid}."""

    def __init__(self, config: TransCenterConfig = TransCenterConfig()):
        super().__init__()
        cfg = self.config = config
        if cfg.dtype != "float32":
            raise NotImplementedError("the port runs TransCenter in float32")
        if cfg.sampling not in ("local", "local_pallas"):
            raise NotImplementedError(DEFORMABLE_TODO)
        hid = cfg.hidden_dim
        self.pvt = PVTv2(cfg.dims, cfg.heads, cfg.depths, cfg.mlp_ratios,
                         cfg.sr_ratios)
        for lvl in range(4):
            setattr(self, f"input_proj_{lvl}", nn.Conv2d(cfg.dims[lvl], hid, 1))
        self.query_proj = nn.Conv2d(cfg.dims[0], hid, 1)
        self.pre_hm_embed = nn.Conv2d(1, hid, 3, 1, 1)
        for i in range(cfg.num_decoder_layers):
            setattr(self, f"dec_{i}", DecoderLayer(
                hid, cfg.dec_heads, 4, sampling=cfg.sampling))
        self.dec_norm = _layer_norm(hid)
        out_ch = {"hm": cfg.num_classes, "reg": 2, "wh": 2, "tracking": 2,
                  "reid": cfg.reid_dim}
        for name in HEADS:
            setattr(self, f"{name}_conv", nn.Conv2d(hid, hid, 3, 1, 1))
            setattr(self, f"{name}_out", nn.Conv2d(hid, out_ch[name], 1))

    def init_weights(self, generator: torch.Generator):
        """Seeded random weights with flax's initialisers: lecun-normal
        (truncated at 2 sigma) kernels, zero biases, unit LayerNorm scales,
        zero attention-weight kernels, and the -4.6 ``hm`` bias.
        ``generator`` is a CPU ``torch.Generator``."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if p.dim() >= 2 and not name.endswith(".weights.weight"):
                    fan_in = int(np.prod(p.shape[1:]))
                    std = math.sqrt(1.0 / fan_in) / .87962566103423978
                    val = torch.empty(p.shape)
                    nn.init.trunc_normal_(val, 0.0, std, -2 * std, 2 * std,
                                          generator=generator)
                elif p.dim() == 1 and name.endswith("weight"):  # LayerNorm
                    val = torch.ones(p.shape)
                elif name == "hm_out.bias":
                    val = torch.full(p.shape, HM_BIAS)
                else:
                    val = torch.zeros(p.shape)
                p.copy_(val.to(p.device))
        return self

    def forward(self, curr, pre, pre_hm) -> Dict[str, torch.Tensor]:
        """Args:
          curr/pre: ``[B, H, W, 3]`` normalized frames.
          pre_hm: ``[B, H/down, W/down, 1]`` Gaussian prior heatmap rendered
            from the tracker's ``pre_cts`` (zeros when no priors).
        Returns:
          dict of NHWC maps at stride ``down_ratio``.
        """
        cfg = self.config
        b = curr.shape[0]
        feats = self.pvt(torch.cat([curr, pre]))  # shared weights
        mem = [conv1x1(getattr(self, f"input_proj_{lvl}"), f)
               for lvl, f in enumerate(feats)]
        mem_cur = [m[:b] for m in mem]
        mem_pre = [m[b:] for m in mem]
        shapes = [(f.shape[1], f.shape[2]) for f in feats]

        f0 = feats[0][:b]
        _, h4, w4, _ = f0.shape
        q = conv1x1(self.query_proj, f0) + _nhwc(self.pre_hm_embed(
            _nchw(pre_hm)))
        q = q.reshape(b, h4 * w4, cfg.hidden_dim)
        for i in range(cfg.num_decoder_layers):
            q = getattr(self, f"dec_{i}")(q, mem_cur, mem_pre, shapes)
        fmap = _nchw(self.dec_norm(q).reshape(b, h4, w4, cfg.hidden_dim))

        out = {}
        for name in HEADS:
            x = F.relu(getattr(self, f"{name}_conv")(fmap))
            out[name] = _nhwc(getattr(self, f"{name}_out")(x))
        return out


# ---------------------------------------------------------------------------
# generic_decode (static top-K peak extraction)
# ---------------------------------------------------------------------------

def generic_decode(output: Dict[str, torch.Tensor], k: int = 300) -> dict:
    """Peak-NMS + top-K decode of CenterNet-style maps.

    3x3 max-pool peak suppression on the (already sigmoid-clamped) heatmap,
    top-K over (y, x, class) with ties taken in index order (a stable
    descending sort, as ``lax.top_k`` orders them), sub-pixel ``reg`` offset
    and ``wh`` box size.  Returns output-plane ``bboxes`` [B, K, 4]
    (x1 y1 x2 y2), ``scores``, ``clses``, ``cts`` and the ``tracking``
    displacement at each peak.
    """
    hm = output["hm"]  # [B, H, W, C]
    b, h, w, c = hm.shape
    peak = _nhwc(F.max_pool2d(_nchw(hm), 3, stride=1, padding=1))
    hm = torch.where((peak - hm).abs() < 1e-9, hm, torch.zeros_like(hm))

    flat = hm.reshape(b, h * w * c)
    scores, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    scores, idx = scores[:, :k], idx[:, :k]
    cls = (idx % c).to(torch.int32)
    pix = idx // c
    ys = (pix // w).to(torch.float32)
    xs = (pix % w).to(torch.float32)

    def gather_map(m):  # [B, H, W, D] -> [B, K, D]
        d = m.shape[-1]
        return m.reshape(b, h * w, d).gather(
            1, pix[..., None].expand(b, pix.shape[1], d))

    reg = gather_map(output["reg"])
    wh = gather_map(output["wh"])
    cx = xs + reg[..., 0]
    cy = ys + reg[..., 1]
    bboxes = torch.stack([
        cx - wh[..., 0] / 2.0,
        cy - wh[..., 1] / 2.0,
        cx + wh[..., 0] / 2.0,
        cy + wh[..., 1] / 2.0,
    ], dim=-1)
    return {
        "scores": scores,
        "clses": cls,
        "bboxes": bboxes,
        "cts": torch.stack([cx, cy], dim=-1),
        "tracking": gather_map(output["tracking"]),
    }


def render_prior_heatmap(
    pre_cts: Optional[np.ndarray],
    hm_hw: Tuple[int, int],
    sigma: float = 2.0,
) -> np.ndarray:
    """Gaussian splat of prior centers -> ``[H, W, 1]`` float32 heatmap (the
    ``pre_hm: true`` mechanism: tracker positions become a soft spatial prior
    for the next frame's queries)."""
    h, w = hm_hw
    out = np.zeros((h, w, 1), np.float32)
    if pre_cts is None or len(pre_cts) == 0:
        return out
    ys, xs = np.mgrid[0:h, 0:w]
    for cx, cy in pre_cts:
        g = np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / (2.0 * sigma**2))
        out[..., 0] = np.maximum(out[..., 0], g.astype(np.float32))
    return out
