"""CenterTrack detector: DLA-34 with a DCNv2 decoder (port of
``busca_tpu.models.centertrack``).

The published DLASeg (CenterTrack's ``dla.py``): the DLA-34 trunk
(hierarchical ``Tree`` stages with ``Root`` fusion) whose stem sums three
7x7 convolutions, of the current image, the previous image
(``pre_img_layer``) and the prior heatmap (``pre_hm_layer``); the ``DLAUp``
decoder of iterative ``IDAUp`` stages, then a final ``ida_up``, where every
projection and node convolution is DCNv2 (``ops/deform.py``) and every
upsample a grouped ``ConvTranspose2d(o, o, 2f, stride=f, padding=f // 2,
groups=o)`` with the bilinear ``fill_up_weights`` init; and the CenterNet
heads ``hm``/``reg``/``wh``/``tracking`` at stride 4.  At DLA-34 the decoder
holds 16 DCN blocks: 12 in ``dla_up``, 4 in ``ida_up``.

The modules are NCHW and keep the published attribute names, so
``state_dict()`` has the published checkpoint's keys (``base.level3.tree1.
tree1.conv1.weight``, ``dla_up.ida_0.proj_1.conv.conv_offset_mask.weight``,
``ida_up.up_2.weight``, ``hm.2.bias``) and a published ``.pth`` loads with
``load_state_dict(strict=True)``.  The MobileNetV2 backbone (the reference
adapter's alternate) keeps busca_tpu's module names.

``CenterTrackConfig.sampling`` selects the decoder's DCN: ``"deformable"``
(exact DCNv2, the default and the published checkpoints' semantics),
``"windowed"`` (gather-free shifted sums, exact wherever ``|offset| <=
dcn_window``) or ``"local"`` (offsets pinned to the tap grid).  All three
read the same parameters.

``CenterTrackConfig.dtype`` ("float32" or "bfloat16") is every layer's
compute dtype, with flax's rules on float32 parameters
(``models/precision.py``): convolutions cast their input and weights, a
BatchNorm computes in float32 and returns the compute dtype, and the DCN
samples and contracts in float32 as busca_tpu's does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from busca_tpu_torch.models.precision import Conv2d, compute_dtype, product
from busca_tpu_torch.ops.deform import (
    deform_conv2d,
    deform_conv2d_windowed,
    local_modulated_conv2d,
)

HM_BIAS = -4.6  # sigmoid ~ 0.01 prior (the CenterNet focal-loss init)
SAMPLINGS = ("deformable", "windowed", "local")
HEADS = ("hm", "reg", "wh", "tracking")


class BatchNorm2d(nn.BatchNorm2d):
    """Eval-mode BatchNorm as flax's ``nn.BatchNorm(dtype=...)``: the input
    promoted to float32, normalized with the running statistics, the output
    in the compute dtype."""

    def __init__(self, num_features: int, dtype: torch.dtype = torch.float32):
        super().__init__(num_features)
        self.compute_dtype = dtype

    def forward(self, x):
        y = F.batch_norm(x.to(torch.float32), self.running_mean,
                         self.running_var, self.weight, self.bias, False,
                         0.0, self.eps)
        return y.to(self.compute_dtype)


def conv_bn_relu(cin: int, cout: int, kernel: int, stride: int,
                 dtype: torch.dtype) -> nn.Sequential:
    """The published ``_conv_level``/stem: conv (no bias), BN, ReLU; keys
    ``0.weight`` and ``1.*``."""
    return nn.Sequential(
        Conv2d(cin, cout, kernel, stride, kernel // 2, bias=False,
               dtype=dtype),
        BatchNorm2d(cout, dtype), nn.ReLU())


class BasicBlock(nn.Module):
    """DLA basic residual block (two 3x3 convolutions)."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, stride, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(cout, dtype)
        self.conv2 = Conv2d(cout, cout, 3, 1, 1, bias=False, dtype=dtype)
        self.bn2 = BatchNorm2d(cout, dtype)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + residual)


class Root(nn.Module):
    """DLA root: concatenated children -> 1x1 conv, BN (+ the first child
    when ``residual``), ReLU."""

    def __init__(self, cin: int, cout: int, residual: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(cin, cout, 1, bias=False, dtype=dtype)
        self.bn = BatchNorm2d(cout, dtype)
        self.residual = residual

    def forward(self, children: List[torch.Tensor]):
        x = self.bn(self.conv(torch.cat(children, 1)))
        if self.residual:
            x = x + children[0]
        return F.relu(x)


class Tree(nn.Module):
    """DLA hierarchical aggregation tree (the published ``Tree``)."""

    def __init__(self, levels: int, cin: int, cout: int, stride: int = 1,
                 level_root: bool = False, root_dim: int = 0,
                 root_residual: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * cout
        if level_root:
            root_dim += cin
        if levels == 1:
            self.tree1 = BasicBlock(cin, cout, stride, dtype)
            self.tree2 = BasicBlock(cout, cout, 1, dtype)
            self.root = Root(root_dim, cout, root_residual, dtype)
        else:
            self.tree1 = Tree(levels - 1, cin, cout, stride, root_dim=0,
                              root_residual=root_residual, dtype=dtype)
            self.tree2 = Tree(levels - 1, cout, cout,
                              root_dim=root_dim + cout,
                              root_residual=root_residual, dtype=dtype)
        self.levels = levels
        self.level_root = level_root
        self.stride = stride
        if cin != cout:
            self.project = nn.Sequential(
                Conv2d(cin, cout, 1, bias=False, dtype=dtype),
                BatchNorm2d(cout, dtype))
        else:
            self.project = None

    def forward(self, x, residual=None, children=None):
        children = [] if children is None else children
        bottom = (F.max_pool2d(x, self.stride, self.stride)
                  if self.stride > 1 else x)
        residual = self.project(bottom) if self.project is not None \
            else bottom
        if self.level_root:
            children.append(bottom)
        x1 = self.tree1(x, residual)
        if self.levels == 1:
            return self.root([self.tree2(x1), x1] + children)
        children.append(x1)
        return self.tree2(x1, children=children)


class DLABase(nn.Module):
    """The DLA trunk with CenterTrack's input fusion: the previous image's
    and the prior heatmap's stems summed into the image stem."""

    def __init__(self, channels: Sequence[int], levels: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ch = list(channels)
        self.base_layer = conv_bn_relu(3, ch[0], 7, 1, dtype)
        self.pre_img_layer = conv_bn_relu(3, ch[0], 7, 1, dtype)
        self.pre_hm_layer = conv_bn_relu(1, ch[0], 7, 1, dtype)
        self.level0 = conv_bn_relu(ch[0], ch[0], 3, 1, dtype)
        self.level1 = conv_bn_relu(ch[0], ch[1], 3, 2, dtype)
        for i in range(2, 6):
            setattr(self, f"level{i}", Tree(
                levels[i], ch[i - 1], ch[i], 2, level_root=i > 2,
                dtype=dtype))

    def forward(self, x, pre_img=None, pre_hm=None) -> List[torch.Tensor]:
        y = self.base_layer(x)
        if pre_img is not None:
            y = y + self.pre_img_layer(pre_img)
        if pre_hm is not None:
            y = y + self.pre_hm_layer(pre_hm)
        outs = []
        for i in range(6):
            y = getattr(self, f"level{i}")(y)
            outs.append(y)
        return outs  # strides 1, 2, 4, 8, 16, 32


class DCN(nn.Module):
    """The published DCNv2 ``DCN`` module: a 3x3 offset/mask convolution
    (27 channels: (dy, dx) for 9 taps, then 9 mask logits) over the input,
    and the deformable convolution's ``weight`` and ``bias``."""

    def __init__(self, cin: int, cout: int, sampling: str = "deformable",
                 window: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        if sampling not in SAMPLINGS:
            raise ValueError(f"sampling must be one of {SAMPLINGS}, not "
                             f"{sampling!r}")
        self.weight = nn.Parameter(torch.zeros(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.conv_offset_mask = Conv2d(cin, 27, 3, 1, 1, dtype=dtype)
        self.sampling = sampling
        self.window = window

    def forward(self, x):
        om = self.conv_offset_mask(x)
        offset = om[:, :18]
        mask = torch.sigmoid(om[:, 18:])
        if self.sampling == "local":
            return local_modulated_conv2d(x, self.weight, mask, self.bias)
        if self.sampling == "windowed":
            return deform_conv2d_windowed(x, offset, self.weight, mask,
                                          self.bias, window=self.window)
        return deform_conv2d(x, offset, self.weight, mask, self.bias)


class DeformConv(nn.Module):
    """The published ``DeformConv``: DCN, then BN and ReLU (``conv`` +
    ``actf``)."""

    def __init__(self, cin: int, cout: int, sampling: str = "deformable",
                 window: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = DCN(cin, cout, sampling, window, dtype)
        self.actf = nn.Sequential(BatchNorm2d(cout, dtype), nn.ReLU())

    def forward(self, x):
        return self.actf(self.conv(x))


def bilinear_up_kernel(k: int) -> np.ndarray:
    """The published ``fill_up_weights`` bilinear kernel of size ``k``."""
    f = int(np.ceil(k / 2.0))
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    v = 1.0 - np.abs(np.arange(k) / f - c)
    return (v[:, None] * v[None, :]).astype(np.float32)


class UpConv(nn.ConvTranspose2d):
    """The grouped learned upsample ``ConvTranspose2d(o, o, 2f, stride=f,
    padding=f // 2, groups=o, bias=False)`` in the compute dtype."""

    def __init__(self, channels: int, factor: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(channels, channels, 2 * factor, stride=factor,
                         padding=factor // 2, groups=channels, bias=False)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return product(lambda a, k: F.conv_transpose2d(
            a, k, None, self.stride, self.padding, 0, self.groups),
            x.to(dt), self.weight.to(dt))


class IDAUp(nn.Module):
    """Iterative deep aggregation (the published ``IDAUp``): each level past
    ``startp`` is projected to width ``o`` by a DCN block, upsampled by its
    ``up_f`` factor to the previous level's stride and fused with it by a
    DCN node."""

    def __init__(self, o: int, channels: Sequence[int], up_f: Sequence[int],
                 sampling: str = "deformable", window: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(1, len(channels)):
            setattr(self, f"proj_{i}", DeformConv(channels[i], o, sampling,
                                                  window, dtype))
            setattr(self, f"node_{i}", DeformConv(o, o, sampling, window,
                                                  dtype))
            setattr(self, f"up_{i}", UpConv(o, int(up_f[i]), dtype))

    def forward(self, layers: List[torch.Tensor], startp: int, endp: int):
        for i in range(startp + 1, endp):
            k = i - startp
            y = getattr(self, f"up_{k}")(getattr(self, f"proj_{k}")(
                layers[i]))
            layers[i] = getattr(self, f"node_{k}")(y + layers[i - 1])


class DLAUp(nn.Module):
    """The published ``DLAUp``: ``ida_i`` stages fuse the deepest levels
    into ever shallower scales.  ``channels`` are the whole pyramid's;
    returns the aggregated scales from ``first_level`` down."""

    def __init__(self, channels: Sequence[int], first_level: int,
                 sampling: str = "deformable", window: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.first_level = first_level
        chans = list(channels)
        n = len(chans)
        # each level's stride; a stage brings the levels past startp to
        # startp's stride
        strides = [2 ** i for i in range(n)]
        for i in range(n - first_level - 1):
            startp = n - i - 2
            up_f = [s // strides[startp] for s in strides[startp:]]
            setattr(self, f"ida_{i}", IDAUp(chans[startp], chans[startp:],
                                            up_f, sampling, window, dtype))
            chans[startp + 1:] = [chans[startp]] * (n - startp - 1)
            strides[startp + 1:] = [strides[startp]] * (n - startp - 1)

    def forward(self, layers: List[torch.Tensor]) -> List[torch.Tensor]:
        layers = list(layers)
        n = len(layers)
        out = [layers[-1]]
        for i in range(n - self.first_level - 1):
            getattr(self, f"ida_{i}")(layers, n - i - 2, n)
            out.insert(0, layers[-1])
        return out


def relu6(x):
    return torch.clamp(F.relu(x), max=6.0)


class InvertedResidual(nn.Module):
    """MobileNetV2 inverted residual: expand 1x1, depthwise 3x3, linear 1x1,
    ReLU6 (busca_tpu's module names)."""

    def __init__(self, cin: int, cout: int, stride: int = 1, expand: int = 6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = cin * expand
        self.expand = expand
        if expand != 1:
            self.expand_conv = Conv2d(cin, hidden, 1, bias=False, dtype=dtype)
            self.expand_bn = BatchNorm2d(hidden, dtype)
        self.dw_conv = Conv2d(hidden, hidden, 3, stride, 1, groups=hidden,
                              bias=False, dtype=dtype)
        self.dw_bn = BatchNorm2d(hidden, dtype)
        self.project_conv = Conv2d(hidden, cout, 1, bias=False, dtype=dtype)
        self.project_bn = BatchNorm2d(cout, dtype)
        self.use_res = stride == 1 and cin == cout

    def forward(self, x):
        y = x
        if self.expand != 1:
            y = relu6(self.expand_bn(self.expand_conv(y)))
        y = relu6(self.dw_bn(self.dw_conv(y)))
        y = self.project_bn(self.project_conv(y))
        return y + x if self.use_res else y


# (expand t, channels c, repeats n, stride s): the published V2 table
MOBILENET_V2 = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
MOBILENET_OUTS = (1, 2, 4, 6)  # stages whose output is a pyramid level


def mobilenet_width(ch: int, width_mult: float) -> int:
    return max(int(ch * width_mult + 0.5), 4)


class MobileNetV2Backbone(nn.Module):
    """MobileNetV2 pyramid (strides 4, 8, 16, 32) with the CenterTrack
    pre_img / pre_hm stem fusion."""

    def __init__(self, width_mult: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = lambda ch: mobilenet_width(ch, width_mult)  # noqa: E731
        for name, cin in (("stem", 3), ("pre_img_stem", 3),
                          ("pre_hm_stem", 1)):
            setattr(self, f"{name}_conv", Conv2d(cin, c(32), 3, 2, 1,
                                                 bias=False, dtype=dtype))
            setattr(self, f"{name}_bn", BatchNorm2d(c(32), dtype))
        cin, idx, self.outs = c(32), 0, []
        for si, (t, ch, n, s) in enumerate(MOBILENET_V2):
            for i in range(n):
                setattr(self, f"block{idx}", InvertedResidual(
                    cin, c(ch), s if i == 0 else 1, t, dtype))
                cin, idx = c(ch), idx + 1
            if si in MOBILENET_OUTS:
                self.outs.append(idx - 1)
        self.num_blocks = idx
        self.channels = [c(MOBILENET_V2[si][1]) for si in MOBILENET_OUTS]

    def _stem(self, name, x):
        return relu6(getattr(self, f"{name}_bn")(
            getattr(self, f"{name}_conv")(x)))

    def forward(self, x, pre_img=None, pre_hm=None) -> List[torch.Tensor]:
        y = self._stem("stem", x)
        if pre_img is not None:
            y = y + self._stem("pre_img_stem", pre_img)
        if pre_hm is not None:
            y = y + self._stem("pre_hm_stem", pre_hm)
        outs = []
        for idx in range(self.num_blocks):
            y = getattr(self, f"block{idx}")(y)
            if idx in self.outs:
                outs.append(y)
        return outs  # strides 4, 8, 16, 32


@dataclasses.dataclass(frozen=True)
class CenterTrackConfig:
    backbone: str = "dla"  # "dla" (DLA-34) or "mobilenet" (MobileNetV2)
    channels: Tuple[int, ...] = (16, 32, 64, 128, 256, 512)
    levels: Tuple[int, ...] = (1, 1, 1, 2, 2, 1)
    width_mult: float = 1.0  # mobilenet width multiplier
    head_dim: int = 256
    down_ratio: int = 4
    num_classes: int = 1
    K: int = 100
    dtype: str = "float32"
    # "deformable" = exact DCNv2 (published checkpoints); "windowed" =
    # gather-free shifted sums, exact wherever |offset| <= dcn_window;
    # "local" = offsets pinned to the tap grid
    sampling: str = "deformable"
    dcn_window: int = 3

    @classmethod
    def tiny(cls, **kw) -> "CenterTrackConfig":
        """Test-size variant (the DLA topology at small widths)."""
        defaults = dict(
            channels=(4, 8, 8, 16, 16, 32),
            levels=(1, 1, 1, 1, 1, 1),
            width_mult=0.125,
            head_dim=16,
            K=8,
        )
        defaults.update(kw)
        return cls(**defaults)


class CenterTrackNet(nn.Module):
    """(image, pre_img, pre_hm) NCHW -> {hm, reg, wh, tracking} NCHW maps
    at stride ``down_ratio``: the published DLASeg."""

    def __init__(self, config: CenterTrackConfig = CenterTrackConfig()):
        super().__init__()
        cfg = self.config = config
        dtype = compute_dtype(cfg.dtype)
        if cfg.backbone == "mobilenet":
            self.base = MobileNetV2Backbone(cfg.width_mult, dtype)
            pyramid = self.base.channels
            self.first_level = 0
        else:
            self.base = DLABase(cfg.channels, cfg.levels, dtype)
            pyramid = list(cfg.channels)
            self.first_level = int(np.log2(cfg.down_ratio))
        n = len(pyramid)
        self.dla_up = DLAUp(pyramid, self.first_level, cfg.sampling,
                            cfg.dcn_window, dtype)
        # DLAUp's scales below the deepest, at their aggregated widths
        scales = pyramid[self.first_level:n - 1]
        self.ida_up = IDAUp(scales[0], scales,
                            [2 ** i for i in range(len(scales))],
                            cfg.sampling, cfg.dcn_window, dtype)
        out_ch = {"hm": cfg.num_classes, "reg": 2, "wh": 2, "tracking": 2}
        for name in HEADS:
            setattr(self, name, nn.Sequential(
                Conv2d(scales[0], cfg.head_dim, 3, 1, 1, dtype=dtype),
                nn.ReLU(),
                Conv2d(cfg.head_dim, out_ch[name], 1, dtype=dtype)))
        with torch.no_grad():
            self.hm[2].bias.fill_(HM_BIAS)

    def init_weights(self, generator: torch.Generator):
        """Seeded random weights with busca_tpu's initialisers:
        lecun-normal convolution kernels (truncated at 2 sigma; he-normal
        for the DCN weights), zero biases, zero offset/mask convolutions,
        the bilinear upsampling kernels, unit BN scales and variances, and
        the -4.6 ``hm`` bias.  ``generator`` is a CPU ``torch.Generator``."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                owner = self.get_submodule(name.rsplit(".", 1)[0])
                if isinstance(owner, UpConv):
                    val = torch.from_numpy(np.ascontiguousarray(
                        np.broadcast_to(bilinear_up_kernel(p.shape[-1]),
                                        p.shape)))
                elif "conv_offset_mask" in name:
                    val = torch.zeros(p.shape)
                elif p.dim() >= 2:
                    fan_in = int(np.prod(p.shape[1:]))
                    gain = 2.0 if isinstance(owner, DCN) else 1.0
                    std = math.sqrt(gain / fan_in) / .87962566103423978
                    val = torch.empty(p.shape)
                    nn.init.trunc_normal_(val, 0.0, std, -2 * std, 2 * std,
                                          generator=generator)
                elif name == "hm.2.bias":
                    val = torch.full(p.shape, HM_BIAS)
                elif isinstance(owner, nn.BatchNorm2d) and \
                        name.endswith("weight"):
                    val = torch.ones(p.shape)
                else:
                    val = torch.zeros(p.shape)
                p.copy_(val.to(p.device))
            for m in self.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.reset_running_stats()
        return self

    def forward(self, x, pre_img=None, pre_hm=None) -> Dict[str, torch.Tensor]:
        """Args:
          x / pre_img: ``[B, 3, H, W]`` normalized images.
          pre_hm: ``[B, 1, H, W]`` prior heatmap at input resolution.
        Returns:
          dict of ``[B, D, H/down, W/down]`` maps.
        """
        pyramid = self.base(x, pre_img, pre_hm)
        outs = self.dla_up(pyramid)
        y = outs[:len(outs) - 1]
        self.ida_up(y, 0, len(y))
        return {name: getattr(self, name)(y[-1]) for name in HEADS}
