"""Frozen copy of ``busca_tpu_torch/models/yolox.py`` at commit c2c24f5, part of the
benchmark's plain reference (it imports nothing of the program; edits
to the program do not reach it).  One change: every float32 convolution
here runs through cuDNN, the stock layer, not the im2col GEMM that the
docstring below describes for the program.

YOLOX detector in PyTorch (port of ``busca_tpu.models.yolox``).

The reference's canonical tracker (ByteTrack) runs a YOLOX-X detector
(adapters/ByteTrack/tools/track.py, exps/*): CSPDarknet backbone (Focus
stem, CSP stages, SPP), PAFPN neck, decoupled head, and the grid decode to
``[B, N, 5 + num_classes]`` rows of ``(cx, cy, w, h, obj, cls...)`` that
feed ``ops.nms.yolox_postprocess``.

Sizes via the standard (depth, width) multipliers:
  yolox-tiny (0.33, 0.375) / -s (0.33, 0.50) / -m (0.67, 0.75) /
  -l (1.0, 1.0) / -x (1.33, 1.25).

The modules keep the official YOLOX attribute names, so ``state_dict()`` has
the official checkpoint key layout (``backbone.backbone.stem.conv.conv.
weight``, ``backbone.C3_p4.m.0.conv1.bn.running_mean``, ``head.stems.0...``,
``head.cls_preds.0.bias``) and an official ``.pth`` loads with
``load_state_dict``.  Tensors are NCHW; BatchNorm runs in eval mode with the
official eps, 1e-3.  The Focus stem is the official strided-slice form
(concat order tl, bl, tr, br); busca_tpu computes the same linear map as
0/1 selection einsums, exactly.

``YoloxConfig.dtype`` ("float32" or "bfloat16") is every convolution's
compute dtype, with flax's ``nn.Conv(dtype=...)`` rule on float32 parameters
(``models/precision.py``); BatchNorm keeps its float32 statistics and
affine and returns the input's dtype (busca_tpu's ``BatchNorm``), and the
decode runs in the head's dtype, as busca_tpu's does.

On the card a float32 YOLOX convolves through PyTorch's own im2col + cuBLAS
path, not cuDNN (``precision.gemm_conv2d``): with TF32 off, cuDNN's choice
for a batch of four 800x1440 frames took about 2.5x four single frames'
time, and it picks its algorithm by batch size, so a lockstep batch's rows
would drift from the single-frame step's; the GEMM path is faster at both
sizes and gives each frame the same rows in any batch.
bf16 convolutions keep cuDNN.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchref.precision import Conv2d, compute_dtype

BN_EPS = 1e-3
BN_MOMENTUM = 0.03
# the official head's prior probability for the obj/cls biases
# (yolo_head.py ``initialize_biases``)
PRIOR_PROB = 1e-2


def _round_repeats(n: int, depth: float) -> int:
    return max(round(n * depth), 1)


class ConvBnAct(nn.Module):
    """Conv (no bias) + BatchNorm + SiLU: the official ``BaseConv``."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1,
                 act: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        # busca_tpu/models/yolox.py:48-57: nn.Conv(dtype=...); the BN's
        # float32 statistics return the input's dtype (reid.py:141-143)
        self.conv = Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2,
                           bias=False, dtype=dtype)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = nn.SiLU() if act else nn.Identity()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class Focus(nn.Module):
    """Space-to-depth stem: (C, H, W) -> (4C, H/2, W/2) -> ConvBnAct."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        # busca_tpu/models/yolox.py:116 casts the image to the compute
        # dtype (xd) before its exact 0/1 space-to-depth selections; here
        # the convolution's own cast of the selected pixels is the same
        self.conv = ConvBnAct(cin * 4, cout, kernel, dtype=dtype)

    def forward(self, x):
        tl = x[..., ::2, ::2]
        bl = x[..., 1::2, ::2]
        tr = x[..., ::2, 1::2]
        br = x[..., 1::2, 1::2]
        return self.conv(torch.cat([tl, bl, tr, br], 1))


class Bottleneck(nn.Module):
    def __init__(self, cin: int, cout: int, shortcut: bool = True,
                 expansion: float = 0.5, dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = int(cout * expansion)
        self.conv1 = ConvBnAct(cin, hidden, 1, dtype=dtype)
        self.conv2 = ConvBnAct(hidden, cout, 3, dtype=dtype)
        self.use_add = shortcut and cin == cout

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return y + x if self.use_add else y


class SPPBottleneck(nn.Module):
    """SPP with 5/9/13 max pools, computed as chained 5x5 pools (SPPF):
    max is associative and the -inf padding keeps the borders equal."""

    def __init__(self, cin: int, cout: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = cin // 2
        self.conv1 = ConvBnAct(cin, hidden, 1, dtype=dtype)
        self.conv2 = ConvBnAct(hidden * 4, cout, 1, dtype=dtype)

    def forward(self, x):
        x = self.conv1(x)
        pools = [x]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], 5, 1, 2))
        return self.conv2(torch.cat(pools, 1))


class CSPLayer(nn.Module):
    def __init__(self, cin: int, cout: int, n: int = 1,
                 shortcut: bool = True, expansion: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = int(cout * expansion)
        self.conv1 = ConvBnAct(cin, hidden, 1, dtype=dtype)
        self.conv2 = ConvBnAct(cin, hidden, 1, dtype=dtype)
        self.conv3 = ConvBnAct(2 * hidden, cout, 1, dtype=dtype)
        self.m = nn.Sequential(*[Bottleneck(hidden, hidden, shortcut, 1.0,
                                            dtype) for _ in range(n)])

    def forward(self, x):
        main = self.m(self.conv1(x))
        return self.conv3(torch.cat([main, self.conv2(x)], 1))


class CSPDarknet(nn.Module):
    def __init__(self, depth: float = 0.33, width: float = 0.50,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        w = lambda c: int(c * width)  # noqa: E731
        d = lambda n: _round_repeats(n, depth)  # noqa: E731
        dt = dict(dtype=dtype)
        self.stem = Focus(3, w(64), 3, **dt)
        self.dark2 = nn.Sequential(ConvBnAct(w(64), w(128), 3, 2, **dt),
                                   CSPLayer(w(128), w(128), d(3), **dt))
        self.dark3 = nn.Sequential(ConvBnAct(w(128), w(256), 3, 2, **dt),
                                   CSPLayer(w(256), w(256), d(9), **dt))
        self.dark4 = nn.Sequential(ConvBnAct(w(256), w(512), 3, 2, **dt),
                                   CSPLayer(w(512), w(512), d(9), **dt))
        self.dark5 = nn.Sequential(
            ConvBnAct(w(512), w(1024), 3, 2, **dt),
            SPPBottleneck(w(1024), w(1024), **dt),
            CSPLayer(w(1024), w(1024), d(3), shortcut=False, **dt))

    def forward(self, x):
        x = self.dark2(self.stem(x))
        c3 = self.dark3(x)
        c4 = self.dark4(c3)
        c5 = self.dark5(c4)
        return c3, c4, c5


def _upsample2x(x):
    """Nearest-neighbour x2 (busca_tpu's ``jnp.repeat`` on both axes)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class PAFPN(nn.Module):
    def __init__(self, depth: float = 0.33, width: float = 0.50,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        w = lambda c: int(c * width)  # noqa: E731
        d = lambda n: _round_repeats(n, depth)  # noqa: E731
        dt = dict(dtype=dtype)
        self.backbone = CSPDarknet(depth, width, **dt)
        self.lateral_conv0 = ConvBnAct(w(1024), w(512), 1, **dt)
        self.C3_p4 = CSPLayer(2 * w(512), w(512), d(3), shortcut=False, **dt)
        self.reduce_conv1 = ConvBnAct(w(512), w(256), 1, **dt)
        self.C3_p3 = CSPLayer(2 * w(256), w(256), d(3), shortcut=False, **dt)
        self.bu_conv2 = ConvBnAct(w(256), w(256), 3, 2, **dt)
        self.C3_n3 = CSPLayer(2 * w(256), w(512), d(3), shortcut=False, **dt)
        self.bu_conv1 = ConvBnAct(w(512), w(512), 3, 2, **dt)
        self.C3_n4 = CSPLayer(2 * w(512), w(1024), d(3), shortcut=False,
                              **dt)

    def forward(self, x):
        c3, c4, c5 = self.backbone(x)
        lat0 = self.lateral_conv0(c5)
        p4 = self.C3_p4(torch.cat([_upsample2x(lat0), c4], 1))
        red1 = self.reduce_conv1(p4)
        p3 = self.C3_p3(torch.cat([_upsample2x(red1), c3], 1))
        n3 = self.C3_n3(torch.cat([self.bu_conv2(p3), red1], 1))
        n4 = self.C3_n4(torch.cat([self.bu_conv1(n3), lat0], 1))
        return p3, n3, n4


class YOLOXHead(nn.Module):
    def __init__(self, num_classes: int = 1, width: float = 0.50,
                 in_channels: Sequence[int] = (256, 512, 1024),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        w = int(256 * width)
        dt = dict(dtype=dtype)
        self.stems = nn.ModuleList()
        self.cls_convs = nn.ModuleList()
        self.reg_convs = nn.ModuleList()
        self.cls_preds = nn.ModuleList()
        self.reg_preds = nn.ModuleList()
        self.obj_preds = nn.ModuleList()
        for c in in_channels:
            self.stems.append(ConvBnAct(int(c * width), w, 1, **dt))
            self.cls_convs.append(nn.Sequential(ConvBnAct(w, w, 3, **dt),
                                                ConvBnAct(w, w, 3, **dt)))
            self.reg_convs.append(nn.Sequential(ConvBnAct(w, w, 3, **dt),
                                                ConvBnAct(w, w, 3, **dt)))
            # busca_tpu/models/yolox.py:321-326: the predictions'
            # nn.Conv(dtype=...) adds its bias in the compute dtype
            self.cls_preds.append(Conv2d(w, num_classes, 1, **dt))
            self.reg_preds.append(Conv2d(w, 4, 1, **dt))
            self.obj_preds.append(Conv2d(w, 1, 1, **dt))

    def forward(self, features):
        """Per level ``(reg [B, 4, h, w], obj [B, 1, h, w], cls [B, C, h,
        w])``."""
        outputs = []
        for lvl, feat in enumerate(features):
            x = self.stems[lvl](feat)
            cls_x = self.cls_convs[lvl](x)
            reg_x = self.reg_convs[lvl](x)
            outputs.append((self.reg_preds[lvl](reg_x),
                            self.obj_preds[lvl](reg_x),
                            self.cls_preds[lvl](cls_x)))
        return outputs


@dataclasses.dataclass(frozen=True)
class YoloxConfig:
    depth: float = 0.33
    width: float = 0.50
    num_classes: int = 1
    strides: Tuple[int, ...] = (8, 16, 32)
    dtype: str = "float32"

    @classmethod
    def size(cls, name: str, **kw) -> "YoloxConfig":
        table = {
            "tiny": (0.33, 0.375),
            "s": (0.33, 0.50),
            "m": (0.67, 0.75),
            "l": (1.0, 1.0),
            "x": (1.33, 1.25),
        }
        d, w = table[name]
        return cls(depth=d, width=w, **kw)


class YOLOX(nn.Module):
    """Full detector: PAFPN features -> decoupled head -> decoded rows."""

    def __init__(self, config: YoloxConfig = YoloxConfig()):
        super().__init__()
        self.config = config
        dtype = compute_dtype(config.dtype)
        self.backbone = PAFPN(config.depth, config.width, dtype)
        self.head = YOLOXHead(config.num_classes, config.width, dtype=dtype)
        self._grids = {}
        for m in self.modules():
            if isinstance(m, Conv2d):
                m.cudnn = True  # the stock layer: cuDNN (TF32 off), not the im2col GEMM

    def init_weights(self, generator: torch.Generator) -> "YOLOX":
        """Seeded random weights: lecun-normal (truncated at 2 sigma)
        convolution kernels and prediction biases of zero, as busca_tpu's
        flax init; unit BN scales, zero BN shifts and running means, unit
        running variances; the obj/cls biases at the official prior,
        -log((1 - 0.01) / 0.01).  ``generator`` is a CPU
        ``torch.Generator``."""
        prior = -math.log((1 - PRIOR_PROB) / PRIOR_PROB)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if p.dim() == 4:
                    fan_in = int(np.prod(p.shape[1:]))
                    std = math.sqrt(1.0 / fan_in) / .87962566103423978
                    val = torch.empty(p.shape)
                    nn.init.trunc_normal_(val, 0.0, std, -2 * std, 2 * std,
                                          generator=generator)
                elif name.endswith("bn.weight"):
                    val = torch.ones(p.shape)
                elif name.startswith(("head.obj_preds", "head.cls_preds")):
                    val = torch.full(p.shape, prior)
                else:
                    val = torch.zeros(p.shape)
                p.copy_(val.to(p.device))
            for name, b in self.named_buffers():
                if name.endswith("running_var"):
                    b.fill_(1.0)
                elif name.endswith("running_mean"):
                    b.zero_()
        return self

    @torch.no_grad()
    def calibrate_random_weights(self, x: torch.Tensor, obj_bias: float,
                                 cls_bias: float,
                                 box_hw: Tuple[float, float]) -> "YOLOX":
        """Make randomly initialized weights give detections, for smoke runs
        and tests.  Random convolutions shrink the signal layer by layer
        until the head sees zeros, so every BN's running statistics are set
        to the batch statistics of one forward over ``x`` ``[B, 3, H, W]``
        (each layer's output then has zero mean and at most unit variance on
        ``x``); the obj and cls biases are set to ``obj_bias`` and
        ``cls_bias``, and each level's (w, h) biases to log(size / stride)
        for boxes of ``box_hw`` (H, W) input pixels."""
        def measure(bn, args):
            # set before the BN runs, so that later layers see its output
            # as it will be; the floor (the layer's mean variance) keeps a
            # near-constant channel from amplifying other inputs' changes
            x = args[0].to(torch.float32)
            var = x.var((0, 2, 3), unbiased=False)
            bn.running_mean.copy_(x.mean((0, 2, 3)))
            bn.running_var.copy_(var + var.mean())

        hooks = [m.register_forward_pre_hook(measure)
                 for m in self.modules() if isinstance(m, nn.BatchNorm2d)]
        was_training = self.training
        self.eval()
        try:
            self.head(self.backbone(x))
        finally:
            for h in hooks:
                h.remove()
            self.train(was_training)
        for lvl, stride in enumerate(self.config.strides):
            self.head.obj_preds[lvl].bias.fill_(obj_bias)
            self.head.cls_preds[lvl].bias.fill_(cls_bias)
            reg = self.head.reg_preds[lvl].bias
            reg[2] = math.log(box_hw[1] / stride)
            reg[3] = math.log(box_hw[0] / stride)
        return self

    def forward(self, x, decode: bool = True):
        """``x``: ``[B, 3, H, W]`` normalized RGB, H and W divisible by 32.
        Returns the decoded rows ``[B, N, 5 + C]``, or with ``decode=False``
        the head's raw per-level outputs."""
        raw = self.head(self.backbone(x))
        if not decode:
            return raw
        return decode_outputs(raw, self.config.strides, self._grids)


def _grid(h: int, w: int, device, cache=None,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``[h * w, 2]`` (x, y) cell coordinates, row-major, in ``dtype``."""
    key = (h, w, str(device), dtype)
    if cache is not None and key in cache:
        return cache[key]
    gy, gx = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    grid = torch.stack([gx, gy], -1).reshape(h * w, 2).to(dtype)
    if cache is not None:
        cache[key] = grid
    return grid


def decode_outputs(raw, strides: Sequence[int], grids=None) -> torch.Tensor:
    """Grid-decode head outputs to ``[B, N, 5 + C]``:
    ``xy = (pred + grid) * stride``, ``wh = exp(pred) * stride``, sigmoid
    obj/cls; the rows of each level in row-major (y, x) order.  ``grids``:
    an optional dict caching the cell grids by shape and device.  The decode
    runs in the head's dtype: in bf16, xy near x = 1400 lands on a spacing
    of 8 canvas pixels, as in busca_tpu."""
    rows: List[torch.Tensor] = []
    for (reg, obj, cls), stride in zip(raw, strides):
        b, _, h, w = reg.shape
        out = torch.cat([reg, obj, cls], 1).permute(0, 2, 3, 1).reshape(
            b, h * w, -1)
        # busca_tpu/models/yolox.py:378: the grid cast to reg.dtype, so a
        # bf16 head decodes (reg + grid) * stride in bf16
        grid = _grid(h, w, reg.device, grids, reg.dtype)
        xy = (out[..., :2] + grid) * stride
        wh = torch.exp(out[..., 2:4]) * stride
        rows.append(torch.cat([xy, wh, torch.sigmoid(out[..., 4:])], -1))
    return torch.cat(rows, 1)
