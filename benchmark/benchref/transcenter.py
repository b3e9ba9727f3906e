"""The plain float32 reference of TransCenter with its deformable decoder:
PVTv2-b2 over the current and the previous frame, the input projections
and level embeddings, dense queries with the tracker's prior heatmap
embedded, six decoder layers of multi-scale deformable attention (MSDA)
over each frame's memory and an FFN, the CenterNet heads, ``generic_decode``
with the dataset's top-K and clip, the sigmoid clamp, the score filter and
the NMS (``benchref.nms``).

Plain torch in float32 with TF32 off (:func:`plain_float32`), NCHW
convolutions through cuDNN, and MSDA as Deformable DETR's own pure-PyTorch
``ms_deform_attn_core_pytorch`` (``F.grid_sample`` per level, bilinear,
``align_corners=False``, zero padding, grid = 2 * loc - 1), independent of
the program's ``index_select`` sampler.  It imports nothing of the program
(``busca_tpu_torch``), of ``busca_tpu`` or of JAX, and its parameter names
are the program's (``models/transcenter.py``), so one state dict loads on
both.  Both the repository's tests and the benchmark's check load it.

Departures from the published TransCenter (Xu et al., TransCenter:
Transformers with Dense Representations for Multiple-Object Tracking; its
PVTv2-b2 backbone from Wang et al., PVT v2), which the program shares:

- the decoder: dense queries are the first stage's features through a 1x1
  projection plus a 3x3 embedding of the prior heatmap; each of the six
  pre-LN layers attends to the current frame's memory, then to the
  previous frame's, then runs an FFN of 4x the width (published: a
  deformable encoder over both frames' features and separate detection
  and tracking query streams); one reference point per query, its own
  pixel centre, on every level;
- the memory: the four PVTv2 stages' outputs through 1x1 projections plus
  a learned level embedding, no deformable encoder;
- the heads: one 3x3 convolution, ReLU and a 1x1 output per map (hm, reg,
  wh, tracking, reid), at stride 4, with no upsampling path;
- PVTv2's spatial-reduction convolution pads as XLA's "SAME" where a level
  is not a multiple of its reduction ratio (published: no padding; at
  640x1088 every level divides, so nothing is padded);
- the peak test keeps a pixel equal to its 3x3 max-pool (CenterNet's), and
  the top-K takes ties in index order (a stable sort);
- the detections go through greedy IoU NMS at 0.7, as BUSCA's TransCenter
  adapter pipes them through YOLOX's postprocess.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchref.crop import (
    IMAGENET_MEAN_RGB,
    IMAGENET_STD_RGB,
    letterbox,
    normalize_canvas,
)
from benchref.nms import nms

LN_EPS = 1e-6
FFN_RATIO = 4
NMS_IOU = 0.7
HEADS = ("hm", "reg", "wh", "tracking", "reid")


def plain_float32():
    """Float32 products with no TF32, in matrix products and in cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class TransCenterConfig:
    """PVTv2-b2 and the decoder at the published widths; ``K`` and ``clip``
    are the dataset preset's (MOT20: 500, clipped)."""

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
    K: int = 500
    clip: bool = True
    reid_dim: int = 64


def _ln(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


def _tokens(x: torch.Tensor) -> torch.Tensor:  # [B, C, H, W] -> [B, HW, C]
    return x.flatten(2).transpose(1, 2)


def _map(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return t.transpose(1, 2).reshape(t.shape[0], -1, h, w)


# --------------------------------------------------------------- PVTv2 --
class OverlapPatchEmbed(nn.Module):
    def __init__(self, in_ch, dim, patch, stride):
        super().__init__()
        self.proj = nn.Conv2d(in_ch, dim, patch, stride, patch // 2)
        self.norm = _ln(dim)

    def forward(self, x):  # NCHW -> normalized tokens, h, w
        x = self.proj(x)
        return self.norm(_tokens(x)), x.shape[2], x.shape[3]


class SRAttention(nn.Module):
    """PVTv2's spatial-reduction attention."""

    def __init__(self, dim, heads, sr_ratio):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr_ratio
        self.q = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.sr_norm = _ln(dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, h, w):
        b, n, c = x.shape
        d = c // self.heads
        q = self.q(x).reshape(b, n, self.heads, d).permute(0, 2, 1, 3)
        if self.sr_ratio > 1:
            s = self.sr_ratio
            # "SAME": the total padding ceil(n / s) * s - n, low half first
            ph, pw = -(-h // s) * s - h, -(-w // s) * s - w
            xr = F.pad(_map(x, h, w), (pw // 2, pw - pw // 2, ph // 2,
                                       ph - ph // 2))
            xr = self.sr_norm(_tokens(self.sr(xr)))
        else:
            xr = x
        kv = self.kv(xr).reshape(b, -1, 2, self.heads, d).permute(
            2, 0, 3, 1, 4)
        attn = (q @ kv[0].transpose(-2, -1)) * d ** -0.5
        out = attn.softmax(-1) @ kv[1]
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class MixFFN(nn.Module):
    def __init__(self, dim, ratio):
        super().__init__()
        hidden = dim * ratio
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = nn.Conv2d(hidden, hidden, 3, 1, 1, groups=hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, h, w):
        x = _tokens(self.dwconv(_map(self.fc1(x), h, w)))
        return self.fc2(F.gelu(x))


class PVTv2Stage(nn.Module):
    def __init__(self, in_ch, dim, heads, depth, mlp_ratio, sr_ratio, patch,
                 stride):
        super().__init__()
        self.depth = depth
        self.embed = OverlapPatchEmbed(in_ch, dim, patch, stride)
        for i in range(depth):
            setattr(self, f"norm1_{i}", _ln(dim))
            setattr(self, f"attn_{i}", SRAttention(dim, heads, sr_ratio))
            setattr(self, f"norm2_{i}", _ln(dim))
            setattr(self, f"ffn_{i}", MixFFN(dim, mlp_ratio))
        self.norm = _ln(dim)

    def forward(self, x):  # NCHW -> NCHW
        t, h, w = self.embed(x)
        for i in range(self.depth):
            t = t + getattr(self, f"attn_{i}")(
                getattr(self, f"norm1_{i}")(t), h, w)
            t = t + getattr(self, f"ffn_{i}")(
                getattr(self, f"norm2_{i}")(t), h, w)
        return _map(self.norm(t), h, w)


class PVTv2(nn.Module):
    def __init__(self, cfg: TransCenterConfig):
        super().__init__()
        for s in range(4):
            setattr(self, f"stage{s}", PVTv2Stage(
                3 if s == 0 else cfg.dims[s - 1], cfg.dims[s], cfg.heads[s],
                cfg.depths[s], cfg.mlp_ratios[s], cfg.sr_ratios[s],
                7 if s == 0 else 3, 4 if s == 0 else 2))

    def forward(self, x) -> List[torch.Tensor]:
        feats = []
        for s in range(4):
            x = getattr(self, f"stage{s}")(x)
            feats.append(x)
        return feats


# ---------------------------------------------------------------- MSDA --
def ms_deform_attn_core_pytorch(value, value_spatial_shapes,
                                sampling_locations, attention_weights):
    """Deformable DETR's pure-PyTorch MSDA (models/ops/functions/
    ms_deform_attn_func.py): value ``[N, S, M, D]``, locations ``[N, Lq,
    M, L, P, 2]`` in [0, 1], weights ``[N, Lq, M, L, P]`` -> ``[N, Lq, M *
    D]``."""
    n, _, m, d = value.shape
    _, lq, m, nl, p, _ = sampling_locations.shape
    value_list = value.split([h * w for h, w in value_spatial_shapes], dim=1)
    sampling_grids = 2 * sampling_locations - 1
    sampling_value_list = []
    for lid, (h, w) in enumerate(value_spatial_shapes):
        value_l = value_list[lid].flatten(2).transpose(1, 2).reshape(
            n * m, d, h, w)
        grid_l = sampling_grids[:, :, :, lid].transpose(1, 2).flatten(0, 1)
        sampling_value_list.append(F.grid_sample(
            value_l, grid_l, mode="bilinear", padding_mode="zeros",
            align_corners=False))
    attention_weights = attention_weights.transpose(1, 2).reshape(
        n * m, 1, lq, nl * p)
    output = (torch.stack(sampling_value_list, dim=-2).flatten(-2)
              * attention_weights).sum(-1).view(n, m * d, lq)
    return output.transpose(1, 2).contiguous()


class DeformableCrossAttention(nn.Module):
    """MSDA: each query samples ``points`` positions per head and level at
    offsets (in level pixels) from its reference point, weighted by a
    softmax over level x point."""

    def __init__(self, dim, heads, points, levels):
        super().__init__()
        self.dim, self.heads, self.points, self.levels = (dim, heads, points,
                                                          levels)
        self.value = nn.Linear(dim, dim)
        self.offsets = nn.Linear(dim, heads * levels * points * 2)
        self.weights = nn.Linear(dim, heads * levels * points)
        self.proj = nn.Linear(dim, dim)

    def forward(self, query, ref, memory, shapes):
        b, lq, _ = query.shape
        nh, nl, npt = self.heads, self.levels, self.points
        value = self.value(memory).view(b, -1, nh, self.dim // nh)
        off = self.offsets(query).view(b, lq, nh, nl, npt, 2)
        w = F.softmax(self.weights(query).view(b, lq, nh, nl * npt),
                      -1).view(b, lq, nh, nl, npt)
        normalizer = torch.tensor([[wl, hl] for hl, wl in shapes],
                                  dtype=query.dtype, device=query.device)
        loc = (ref[:, :, None, None, None, :]
               + off / normalizer[None, None, None, :, None, :])
        return self.proj(ms_deform_attn_core_pytorch(value, shapes, loc, w))


class DecoderLayer(nn.Module):
    def __init__(self, dim, heads, points, levels=4):
        super().__init__()
        self.ln1 = _ln(dim)
        self.cross_cur = DeformableCrossAttention(dim, heads, points, levels)
        self.ln2 = _ln(dim)
        self.cross_pre = DeformableCrossAttention(dim, heads, points, levels)
        self.ln3 = _ln(dim)
        self.fc1 = nn.Linear(dim, dim * FFN_RATIO)
        self.fc2 = nn.Linear(dim * FFN_RATIO, dim)

    def forward(self, q, ref, mem_cur, mem_pre, shapes):
        q = q + self.cross_cur(self.ln1(q), ref, mem_cur, shapes)
        q = q + self.cross_pre(self.ln2(q), ref, mem_pre, shapes)
        return q + self.fc2(F.gelu(self.fc1(self.ln3(q))))


def reference_points(h: int, w: int, device) -> torch.Tensor:
    """Each query's pixel centre over the grid, ``[h * w, 2]`` (x, y) in
    [0, 1] (Deformable DETR's ``get_reference_points`` at valid ratio 1)."""
    ref_y, ref_x = torch.meshgrid(
        torch.linspace(0.5, h - 0.5, h, dtype=torch.float32, device=device),
        torch.linspace(0.5, w - 0.5, w, dtype=torch.float32, device=device),
        indexing="ij")
    return torch.stack([ref_x.reshape(-1) / w, ref_y.reshape(-1) / h], -1)


class TransCenterDETR(nn.Module):
    """curr + pre frames ``[B, H, W, 3]`` and the prior heatmap ``[B, H/4,
    W/4, 1]`` (NHWC, the program's boundary) -> the five maps, NHWC at
    stride 4."""

    def __init__(self, cfg: TransCenterConfig = TransCenterConfig()):
        super().__init__()
        self.config = cfg
        hid = cfg.hidden_dim
        self.pvt = PVTv2(cfg)
        for lvl in range(4):
            setattr(self, f"input_proj_{lvl}", nn.Conv2d(cfg.dims[lvl], hid,
                                                         1))
            setattr(self, f"level_embed_{lvl}",
                    nn.Parameter(torch.zeros(hid)))
        self.query_proj = nn.Conv2d(cfg.dims[0], hid, 1)
        self.pre_hm_embed = nn.Conv2d(1, hid, 3, 1, 1)
        for i in range(cfg.num_decoder_layers):
            setattr(self, f"dec_{i}", DecoderLayer(
                hid, cfg.dec_heads, cfg.dec_n_points))
        self.dec_norm = _ln(hid)
        out_ch = {"hm": cfg.num_classes, "reg": 2, "wh": 2, "tracking": 2,
                  "reid": cfg.reid_dim}
        for name in HEADS:
            setattr(self, f"{name}_conv", nn.Conv2d(hid, hid, 3, 1, 1))
            setattr(self, f"{name}_out", nn.Conv2d(hid, out_ch[name], 1))

    def features(self, curr, pre, pre_hm) -> torch.Tensor:
        """The decoder's output map ``[B, C, H/4, W/4]``."""
        b = curr.shape[0]
        x = torch.cat([curr, pre]).permute(0, 3, 1, 2)
        feats = self.pvt(x)
        shapes = [tuple(f.shape[2:]) for f in feats]
        mem = torch.cat([
            _tokens(getattr(self, f"input_proj_{lvl}")(f))
            + getattr(self, f"level_embed_{lvl}")
            for lvl, f in enumerate(feats)], 1)
        h4, w4 = shapes[0]
        ref = reference_points(h4, w4, curr.device)[None].expand(
            b, h4 * w4, 2)
        q = _tokens(self.query_proj(feats[0][:b])
                    + self.pre_hm_embed(pre_hm.permute(0, 3, 1, 2)))
        for i in range(self.config.num_decoder_layers):
            q = getattr(self, f"dec_{i}")(q, ref, mem[:b], mem[b:], shapes)
        return _map(self.dec_norm(q), h4, w4)

    def forward(self, curr, pre, pre_hm) -> Dict[str, torch.Tensor]:
        fmap = self.features(curr, pre, pre_hm)
        return {name: getattr(self, f"{name}_out")(F.relu(getattr(
            self, f"{name}_conv")(fmap))).permute(0, 2, 3, 1)
            for name in HEADS}


# -------------------------------------------------------------- decode --
def generic_decode(output: Dict[str, torch.Tensor], k: int) -> dict:
    """CenterNet's peak decode of NHWC maps (``hm`` already sigmoided):
    peaks equal to their 3x3 max-pool, the top ``k`` (ties in index order),
    the sub-pixel ``reg`` offset and the ``wh`` size -> output-plane boxes
    ``[B, k, 4]``, scores and classes."""
    hm = output["hm"].permute(0, 3, 1, 2)
    b, c, h, w = hm.shape
    hm = hm * (F.max_pool2d(hm, 3, stride=1, padding=1) == hm)
    flat = hm.permute(0, 2, 3, 1).reshape(b, h * w * c)
    scores, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    scores, idx = scores[:, :k], idx[:, :k]
    pix = idx // c
    ys, xs = (pix // w).to(torch.float32), (pix % w).to(torch.float32)

    def at(name):
        m = output[name]
        return m.reshape(b, h * w, m.shape[-1]).gather(
            1, pix[..., None].expand(-1, -1, m.shape[-1]))

    reg, wh = at("reg"), at("wh")
    cx, cy = xs + reg[..., 0], ys + reg[..., 1]
    boxes = torch.stack([cx - wh[..., 0] / 2, cy - wh[..., 1] / 2,
                         cx + wh[..., 0] / 2, cy + wh[..., 1] / 2], -1)
    return {"bboxes": boxes, "scores": scores, "clses": idx % c}


def boxes_to_center_priors(boxes_tlbr: Optional[np.ndarray],
                           down_ratio: int) -> Optional[np.ndarray]:
    """The tracker's boxes (tlbr, canvas pixels) -> their centres at
    stride ``down_ratio`` (BUSCA's adapters/TransCenter/models/
    transcenter.py:104-127)."""
    if boxes_tlbr is None or len(boxes_tlbr) == 0:
        return None
    return (boxes_tlbr[:, :2] + boxes_tlbr[:, 2:]) / 2.0 / down_ratio


def render_prior_heatmap(pre_cts: Optional[np.ndarray],
                         hm_hw: Tuple[int, int],
                         sigma: float = 2.0) -> np.ndarray:
    """The prior centres splatted as Gaussians, their maximum per pixel ->
    ``[H, W, 1]`` float32."""
    h, w = hm_hw
    out = np.zeros((h, w, 1), np.float32)
    if pre_cts is None or len(pre_cts) == 0:
        return out
    ys, xs = np.mgrid[0:h, 0:w]
    for cx, cy in pre_cts:
        g = np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / (2.0 * sigma ** 2))
        out[..., 0] = np.maximum(out[..., 0], g.astype(np.float32))
    return out


class RefTransCenter:
    """The reference detector: the plain letterbox (zero fill), ImageNet
    normalization, the model, the decode and the NMS, one frame at a
    time."""

    def __init__(self, model: TransCenterDETR, test_size: Tuple[int, int],
                 out_thresh: float):
        self.model = model
        self.device = next(model.parameters()).device
        self.test_size = tuple(test_size)
        self.out_thresh = float(out_thresh)
        self._mean = torch.tensor(IMAGENET_MEAN_RGB, device=self.device)
        self._std = torch.tensor(IMAGENET_STD_RGB, device=self.device)
        self._boxes = {}

    def canvas(self, frame) -> Tuple[torch.Tensor, float]:
        f = torch.as_tensor(np.asarray(frame)).to(self.device)
        return letterbox(f, self.test_size, 0, self._boxes)

    def prior(self, current_pos: Optional[np.ndarray]) -> torch.Tensor:
        """The prior heatmap of the tracker's boxes (canvas pixels), their
        centres clamped to the canvas."""
        th, tw = self.test_size
        down = self.model.config.down_ratio
        cts = boxes_to_center_priors(
            None if current_pos is None else np.asarray(current_pos), down)
        if cts is not None:
            cts[:, 0] = np.clip(cts[:, 0], 0, (tw - 1) / down)
            cts[:, 1] = np.clip(cts[:, 1], 0, (th - 1) / down)
        return torch.from_numpy(render_prior_heatmap(
            cts, (th // down, tw // down))).to(self.device)

    def inputs(self, canvas, pre_canvas, current_pos):
        def norm(c):
            return normalize_canvas(torch.as_tensor(c).to(self.device),
                                    self._mean, self._std)[None]

        return norm(canvas), norm(pre_canvas), self.prior(current_pos)[None]

    def maps(self, canvas, pre_canvas, current_pos) -> Dict[str, torch.Tensor]:
        plain_float32()
        with torch.no_grad():
            return self.model(*self.inputs(canvas, pre_canvas, current_pos))

    def postprocess(self, out: Dict[str, torch.Tensor]):
        """The maps -> ``(boxes [n, 4] canvas pixels, scores [n])``."""
        cfg = self.model.config
        out = dict(out, hm=torch.clamp(torch.sigmoid(out["hm"]), 1e-4,
                                       1 - 1e-4))
        dec = generic_decode(out, cfg.K)
        boxes = dec["bboxes"][0] * cfg.down_ratio
        scores = dec["scores"][0]
        scores = torch.where((dec["clses"][0] == 0)
                             & (scores >= self.out_thresh), scores,
                             torch.full_like(scores, -math.inf))
        if cfg.clip:
            th, tw = self.test_size
            hi = torch.tensor([tw - 1, th - 1, tw - 1, th - 1],
                              dtype=boxes.dtype, device=boxes.device)
            boxes = torch.minimum(boxes.clamp(min=0.0), hi)
        idx, valid = nms(boxes, scores, NMS_IOU, cfg.K)
        idx = idx[valid].long()
        return boxes[idx], scores[idx]

    def detect(self, frame, pre_canvas=None,
               current_pos: Optional[np.ndarray] = None):
        """One frame (uint8 BGR) -> ``(boxes_tlbr [n, 4] frame pixels,
        scores [n])`` float64; ``pre_canvas`` None takes the frame's own
        canvas (a stream's first frame)."""
        canvas, r = self.canvas(frame)
        boxes, scores = self.postprocess(self.maps(
            canvas, canvas if pre_canvas is None else pre_canvas,
            current_pos))
        return (boxes.cpu().numpy().astype(np.float64) / r,
                scores.cpu().numpy().astype(np.float64))

