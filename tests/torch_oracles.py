"""Shared torch oracle models for parity tests.

These are standard published architectures (ResNet-50 bottleneck stacks,
post-LN Transformer blocks, multidimensional sinusoidal positional encodings)
assembled from stock ``torch.nn`` primitives — written here independently as
test oracles for the Flax implementations.
"""

import numpy as np
import torch
import torch.nn as tnn


class TorchBottleneck(tnn.Module):
    def __init__(self, in_ch, planes, stride=1):
        super().__init__()
        out_ch = planes * 4
        self.conv1 = tnn.Conv2d(in_ch, planes, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(planes)
        self.conv2 = tnn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = tnn.BatchNorm2d(planes)
        self.conv3 = tnn.Conv2d(planes, out_ch, 1, bias=False)
        self.bn3 = tnn.BatchNorm2d(out_ch)
        self.relu = tnn.ReLU()
        if stride != 1 or in_ch != out_ch:
            self.downsample = tnn.Sequential(
                tnn.Conv2d(in_ch, out_ch, 1, stride, bias=False),
                tnn.BatchNorm2d(out_ch),
            )
        else:
            self.downsample = None

    def forward(self, x):
        idn = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            idn = self.downsample(x)
        return self.relu(out + idn)


class TorchGhostResNet50(tnn.Module):
    """ResNet-50 with the GHOST head: max pool, red linear, L2-norm feats."""

    def __init__(self, num_classes=299, red=4, layers_cfg=(3, 4, 6, 3)):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = tnn.BatchNorm2d(64)
        self.relu = tnn.ReLU()
        self.maxpool = tnn.MaxPool2d(3, 2, 1)
        layers = []
        in_ch = 64
        for stage, (planes, blocks) in enumerate(
            zip((64, 128, 256, 512), layers_cfg)
        ):
            stride = 1 if stage == 0 else 2
            stage_blocks = []
            for b in range(blocks):
                stage_blocks.append(
                    TorchBottleneck(in_ch, planes, stride if b == 0 else 1)
                )
                in_ch = planes * 4
            layers.append(tnn.Sequential(*stage_blocks))
        self.layer1, self.layer2, self.layer3, self.layer4 = layers
        self.pool = tnn.AdaptiveMaxPool2d((1, 1))
        self.red = tnn.Linear(2048, 2048 // red)
        self.fc = tnn.Linear(2048 // red, num_classes)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = self.pool(x).flatten(1)
        fc7 = self.red(x)
        logits = self.fc(fc7)
        feats = torch.nn.functional.normalize(fc7, p=2, dim=1)
        return logits, feats

    def reference_state_dict(self):
        """State dict with the reference's ``reid_encoder.model.*`` layout."""
        out = {}
        for k, v in self.state_dict().items():
            out[f"reid_encoder.model.{k}"] = v.detach().numpy()
        return out


class TorchPostLNLayer(tnn.Module):
    """Post-LN encoder block (BUSCA layer arrangement)."""

    def __init__(self, d_model, nhead, ff, activation="gelu"):
        super().__init__()
        self.self_attn = tnn.MultiheadAttention(
            d_model, nhead, dropout=0.0, batch_first=True
        )
        self.linear1 = tnn.Linear(d_model, ff)
        self.linear2 = tnn.Linear(ff, d_model)
        self.norm1 = tnn.LayerNorm(d_model)
        self.norm2 = tnn.LayerNorm(d_model)
        self.act = {"gelu": tnn.GELU(), "relu": tnn.ReLU()}[activation]

    def forward(self, src):
        a, w = self.self_attn(src, src, src, average_attn_weights=False)
        src = self.norm1(src + a)
        f = self.linear2(self.act(self.linear1(src)))
        src = self.norm2(src + f)
        return src, w


def oracle_pe3d(xy, size, t, d_model):
    """PositionalEncoding3D evaluated at integer coords (numpy, f64)."""
    ch = int(np.ceil(d_model / 6) * 2)
    if ch % 2:
        ch += 1
    inv_freq = 1.0 / (10000 ** (np.arange(0, ch, 2, dtype=np.float64) / ch))

    def axis(p):
        ang = np.asarray(p, dtype=np.float64)[..., None] * inv_freq
        return np.stack([np.sin(ang), np.cos(ang)], axis=-1).reshape(
            *ang.shape[:-1], ch
        )

    full = np.concatenate([axis(xy), axis(size), axis(t)], axis=-1)
    return full[..., :d_model]


def oracle_distance_values(bbox, ref):
    xmin, ymin, xmax, ymax = ref[..., 0], ref[..., 1], ref[..., 2], ref[..., 3]
    w_ref, h_ref = xmax - xmin + 1, ymax - ymin + 1
    cxr, cyr = 0.5 * (xmin + xmax), 0.5 * (ymin + ymax)
    xmin, ymin, xmax, ymax = bbox[..., 0], bbox[..., 1], bbox[..., 2], bbox[..., 3]
    w, h = xmax - xmin + 1, ymax - ymin + 1
    cx, cy = 0.5 * (xmin + xmax), 0.5 * (ymin + ymax)
    xy = np.log(np.sqrt(((cx - cxr) / w) ** 2 + ((cy - cyr) / h) ** 2) + 1e-3)
    size = np.log(w / w_ref + 1e-3) + np.log(h / h_ref + 1e-3)
    return xy, size


def oracle_spatial_buckets(bbox, ref, max_dist=105):
    xy, size = oracle_distance_values(bbox, ref)
    xyb = np.trunc(np.clip(xy * 15.0, -max_dist, max_dist)).astype(int) + max_dist
    szb = np.trunc(np.clip(size * 15.0, -max_dist, max_dist)).astype(int) + max_dist
    return xyb, szb


# ---------------------------------------------------------------------------
# CenterTrack DLA-34 / DLASeg oracle (canonical published naming, so the
# converter parity test doubles as a converter test for real checkpoints).
# DCNv2 forward is written here from the op definition (bilinear sampling
# with per-corner zero padding); naming follows the published CenterTrack
# model layout: base.*, dla_up.ida_K.{proj,up,node}_i, ida_up.*, heads
# hm/reg/wh/tracking as Sequential(conv3x3, ReLU, conv1x1).
# ---------------------------------------------------------------------------


def _torch_dcn_sample(x, offset, mask, weight, bias):
    """DCNv2 forward: x [B,C,H,W], offset [B,18,H,W] interleaved (dy, dx)
    per tap, mask [B,9,H,W] (already sigmoided), weight [O,C,3,3]."""
    b, c, h, w = x.shape
    cout = weight.shape[0]
    gy = torch.arange(h, dtype=x.dtype)
    gx = torch.arange(w, dtype=x.dtype)
    out = torch.zeros(b, cout, h, w, dtype=x.dtype)
    for tap in range(9):
        ky, kx = tap // 3, tap % 3
        py = gy.view(1, h, 1) + (ky - 1) + offset[:, 2 * tap]
        px = gx.view(1, 1, w) + (kx - 1) + offset[:, 2 * tap + 1]
        # bilinear sample with per-corner zero padding
        y0 = torch.floor(py)
        x0 = torch.floor(px)
        fy = (py - y0).unsqueeze(1)
        fx = (px - x0).unsqueeze(1)
        acc = torch.zeros(b, c, h, w, dtype=x.dtype)
        for dy, wy in ((0, 1 - fy), (1, fy)):
            for dx, wx in ((0, 1 - fx), (1, fx)):
                iy = (y0 + dy).long()
                ix = (x0 + dx).long()
                ok = ((iy >= 0) & (iy < h) & (ix >= 0) & (ix < w))
                iyc = iy.clamp(0, h - 1)
                ixc = ix.clamp(0, w - 1)
                flat = (iyc * w + ixc).view(b, 1, -1).expand(b, c, -1)
                v = torch.gather(x.reshape(b, c, -1), 2, flat)
                v = v.view(b, c, h, w) * ok.unsqueeze(1).to(x.dtype)
                acc = acc + wy * wx * v
        acc = acc * mask[:, tap : tap + 1]
        out = out + torch.einsum(
            "bchw,oc->bohw", acc, weight[:, :, ky, kx]
        )
    return out + bias.view(1, -1, 1, 1)


class TorchDCN(tnn.Module):
    """The DCN module of the published DCNv2 extension: self-predicted
    offset+mask conv (zero-init), weight/bias of the deformable conv."""

    def __init__(self, chi, cho):
        super().__init__()
        self.weight = tnn.Parameter(torch.randn(cho, chi, 3, 3) * 0.1)
        self.bias = tnn.Parameter(torch.zeros(cho))
        self.conv_offset_mask = tnn.Conv2d(chi, 27, 3, padding=1)

    def forward(self, x):
        om = self.conv_offset_mask(x)
        o1, o2, m = torch.chunk(om, 3, dim=1)
        offset = torch.cat((o1, o2), dim=1)
        mask = torch.sigmoid(m)
        return _torch_dcn_sample(x, offset, mask, self.weight, self.bias)


class TorchDeformConv(tnn.Module):
    """DeformConv of the published pose_dla_dcn: DCN -> BN -> ReLU
    (``conv`` + ``actf``)."""

    def __init__(self, chi, cho):
        super().__init__()
        self.conv = TorchDCN(chi, cho)
        self.actf = tnn.Sequential(tnn.BatchNorm2d(cho), tnn.ReLU())

    def forward(self, x):
        return self.actf(self.conv(x))


def _fill_up_weights(up):
    w = up.weight.data
    f = int(np.ceil(w.size(2) / 2.0))
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    for i in range(w.size(2)):
        for j in range(w.size(3)):
            w[:, 0, i, j] = (1 - abs(i / f - c)) * (1 - abs(j / f - c))


class TorchIDAUp(tnn.Module):
    def __init__(self, o, channels, up_f):
        super().__init__()
        for i in range(1, len(channels)):
            c = channels[i]
            f = int(up_f[i])
            setattr(self, "proj_" + str(i), TorchDeformConv(c, o))
            setattr(self, "node_" + str(i), TorchDeformConv(o, o))
            up = tnn.ConvTranspose2d(
                o, o, f * 2, stride=f, padding=f // 2,
                output_padding=0, groups=o, bias=False,
            )
            _fill_up_weights(up)
            setattr(self, "up_" + str(i), up)

    def forward(self, layers, startp, endp):
        for i in range(startp + 1, endp):
            upsample = getattr(self, "up_" + str(i - startp))
            project = getattr(self, "proj_" + str(i - startp))
            layers[i] = upsample(project(layers[i]))
            node = getattr(self, "node_" + str(i - startp))
            layers[i] = node(layers[i] + layers[i - 1])


class TorchDLAUp(tnn.Module):
    def __init__(self, startp, channels, scales):
        super().__init__()
        self.startp = startp
        channels = list(channels)
        in_channels = list(channels)
        scales = np.array(scales, dtype=int)
        for i in range(len(channels) - 1):
            j = -i - 2
            setattr(
                self, "ida_{}".format(i),
                TorchIDAUp(channels[j], in_channels[j:],
                           scales[j:] // scales[j]),
            )
            scales[j + 1:] = scales[j]
            in_channels[j + 1:] = [channels[j] for _ in channels[j + 1:]]

    def forward(self, layers):
        out = [layers[-1]]
        for i in range(len(layers) - self.startp - 1):
            ida = getattr(self, "ida_{}".format(i))
            ida(layers, len(layers) - i - 2, len(layers))
            out.insert(0, layers[-1])
        return out


class TorchDLABasicBlock(tnn.Module):
    def __init__(self, inplanes, planes, stride=1):
        super().__init__()
        self.conv1 = tnn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(planes)
        self.relu = tnn.ReLU(inplace=True)
        self.conv2 = tnn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = tnn.BatchNorm2d(planes)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + residual)


class TorchDLARoot(tnn.Module):
    def __init__(self, in_channels, out_channels, residual=False):
        super().__init__()
        self.conv = tnn.Conv2d(in_channels, out_channels, 1, bias=False)
        self.bn = tnn.BatchNorm2d(out_channels)
        self.relu = tnn.ReLU(inplace=True)
        self.residual = residual

    def forward(self, *children):
        x = self.bn(self.conv(torch.cat(children, 1)))
        if self.residual:
            x = x + children[0]
        return self.relu(x)


class TorchDLATree(tnn.Module):
    def __init__(self, levels, in_channels, out_channels, stride=1,
                 level_root=False, root_dim=0, root_residual=False):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * out_channels
        if level_root:
            root_dim += in_channels
        if levels == 1:
            self.tree1 = TorchDLABasicBlock(in_channels, out_channels, stride)
            self.tree2 = TorchDLABasicBlock(out_channels, out_channels, 1)
        else:
            self.tree1 = TorchDLATree(
                levels - 1, in_channels, out_channels, stride,
                root_dim=0, root_residual=root_residual,
            )
            self.tree2 = TorchDLATree(
                levels - 1, out_channels, out_channels,
                root_dim=root_dim + out_channels,
                root_residual=root_residual,
            )
        if levels == 1:
            self.root = TorchDLARoot(root_dim, out_channels, root_residual)
        self.level_root = level_root
        self.levels = levels
        self.downsample = tnn.MaxPool2d(stride, stride) if stride > 1 else None
        self.project = None
        if in_channels != out_channels:
            self.project = tnn.Sequential(
                tnn.Conv2d(in_channels, out_channels, 1, bias=False),
                tnn.BatchNorm2d(out_channels),
            )

    def forward(self, x, residual=None, children=None):
        children = [] if children is None else children
        bottom = self.downsample(x) if self.downsample else x
        residual = self.project(bottom) if self.project else bottom
        if self.level_root:
            children.append(bottom)
        x1 = self.tree1(x, residual)
        if self.levels == 1:
            x2 = self.tree2(x1)
            x = self.root(x2, x1, *children)
        else:
            children.append(x1)
            x = self.tree2(x1, children=children)
        return x


def _conv_level(inp, planes, kernel=3, stride=1):
    return tnn.Sequential(
        tnn.Conv2d(inp, planes, kernel, stride, kernel // 2, bias=False),
        tnn.BatchNorm2d(planes),
        tnn.ReLU(inplace=True),
    )


class TorchDLA(tnn.Module):
    """dla34 trunk with CenterTrack's pre_img/pre_hm stem fusion."""

    def __init__(self, levels, channels):
        super().__init__()
        self.channels = channels
        self.base_layer = _conv_level(3, channels[0], 7)
        self.pre_img_layer = _conv_level(3, channels[0], 7)
        self.pre_hm_layer = _conv_level(1, channels[0], 7)
        self.level0 = _conv_level(channels[0], channels[0])
        self.level1 = _conv_level(channels[0], channels[1], stride=2)
        self.level2 = TorchDLATree(
            levels[2], channels[1], channels[2], 2, level_root=False)
        self.level3 = TorchDLATree(
            levels[3], channels[2], channels[3], 2, level_root=True)
        self.level4 = TorchDLATree(
            levels[4], channels[3], channels[4], 2, level_root=True)
        self.level5 = TorchDLATree(
            levels[5], channels[4], channels[5], 2, level_root=True)

    def forward(self, x, pre_img=None, pre_hm=None):
        x = self.base_layer(x)
        if pre_img is not None:
            x = x + self.pre_img_layer(pre_img)
        if pre_hm is not None:
            x = x + self.pre_hm_layer(pre_hm)
        y = []
        for i in range(6):
            x = getattr(self, "level{}".format(i))(x)
            y.append(x)
        return y


class TorchDLASeg(tnn.Module):
    """The published CenterTrack DLASeg with canonical checkpoint naming."""

    def __init__(self, levels=(1, 1, 1, 2, 2, 1),
                 channels=(16, 32, 64, 128, 256, 512),
                 head_conv=256, num_classes=1, down_ratio=4):
        super().__init__()
        self.first_level = int(np.log2(down_ratio))
        self.last_level = 5
        self.base = TorchDLA(levels, channels)
        channels = list(channels)
        scales = [2 ** i for i in range(len(channels[self.first_level:]))]
        self.dla_up = TorchDLAUp(
            self.first_level, channels[self.first_level:], scales)
        out_channel = channels[self.first_level]
        self.ida_up = TorchIDAUp(
            out_channel, channels[self.first_level:self.last_level],
            [2 ** i for i in range(self.last_level - self.first_level)],
        )
        heads = {"hm": num_classes, "reg": 2, "wh": 2, "tracking": 2}
        for head, classes in heads.items():
            fc = tnn.Sequential(
                tnn.Conv2d(out_channel, head_conv, 3, padding=1, bias=True),
                tnn.ReLU(inplace=True),
                tnn.Conv2d(head_conv, classes, 1, bias=True),
            )
            if head == "hm":
                fc[-1].bias.data.fill_(-4.6)
            setattr(self, head, fc)

    def forward(self, x, pre_img=None, pre_hm=None):
        x = self.base(x, pre_img, pre_hm)
        x = self.dla_up(x)
        y = []
        for i in range(self.last_level - self.first_level):
            y.append(x[i].clone())
        self.ida_up(y, 0, len(y))
        return {h: getattr(self, h)(y[-1])
                for h in ("hm", "reg", "wh", "tracking")}


def bf16_scale_ulps(got, want):
    """max |got - want| in bf16 ulps of the output's scale (the ulp of
    max |want|: 2 ** (floor(log2 max|want|) - 7)), and the share of values
    that are equal.  Both are taken as float32 arrays."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7) if scale > 0 else 2.0 ** -133
    diff = np.abs(got - want)
    return float(diff.max() / ulp), float((diff == 0).mean())
