"""ReID appearance encoder: the GHOST ResNet-50 (port of
``busca_tpu.models.reid``).

Architecture of the reference ``resnet50(neck=0, red=4, pool='max')``
(busca/reid/resnet.py): 7x7/2 stem + BN + ReLU + 3x3/2 max-pool, bottleneck
stages [3, 4, 6, 3], global max pool, ``red`` linear 2048 -> 512, classifier
``fc``, and the L2-normalized 512-d feature (``output_option='plain'``).

The load-bearing quirk: BatchNorm normalizes with the statistics of the
current batch at inference (GHOST domain adaptation, busca/network.py:
554-556), with padded lanes masked out of the statistics.  :class:`BatchNorm`
is written as plain tensor ops; ``nn.BatchNorm2d`` in train mode would
mutate its running statistics and cannot mask lanes.

Inputs are NHWC ``[N, H, W, 3]`` like the JAX module; the convolutions run in
NCHW.  ``dtype`` is busca_tpu's ``ReIDResNet(dtype=...)``: the input is cast
to it, the convolutions compute in it (flax ``nn.Conv(dtype=...)``, see
``models/precision.py``), BatchNorm keeps float32 statistics and returns the
input's dtype, and the pooled features go back to float32 before the
float32 ``red`` and ``fc`` linears.  Module and parameter names are the
reference's, so a reference state dict (``reid_encoder.model.*`` of
``model_busca.pth``) loads directly.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from busca_tpu_torch.models.precision import Conv2d
from busca_tpu_torch.models.transformer import TorchLinear

PRETRAINED_SIZE = (384, 128)  # (H, W) crop size the weights were trained with


class BatchNorm(nn.Module):
    """BatchNorm with torch-train-mode statistics and optional masking.

    ``use_batch_stats`` (the default): biased mean/var of the current batch;
    ``sample_mask`` excludes samples from the statistics while still
    normalizing them:

    - ``[N]`` weights: one statistics group over the weighted samples;
    - ``[N, G]`` one-hot group weights (zero rows = padded): statistics per
      group, each sample normalized with its own group's statistics (rows
      with no weight take group 0).

    With ``use_batch_stats=False`` the stored running statistics are used
    (torch eval mode).  Works on ``[N, C, ...]`` activations.

    Training differentiates through the statistics as busca_tpu's does: the
    variance is E[x^2] - E[x]^2 clamped at 0 (``jnp.maximum(var, 0.0)``),
    so the gradients match JAX's.  Nothing updates the running statistics:
    busca_tpu's train step applies ``{"params": ...}`` only.

    ``calib``: None, or a list to which every batch-statistics forward
    appends its ``(count, sum_x, sum_x2)`` over the weighted samples
    (busca_tpu's ``bn_calib`` collection, ``_sow_calib``); set by
    :func:`collect_bn_calibration`.
    """

    def __init__(self, features: int, eps: float = 1e-5,
                 use_batch_stats: bool = True):
        super().__init__()
        self.features, self.eps = features, eps
        self.use_batch_stats = use_batch_stats
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))
        self.calib = None

    def _affine(self, x, mean, inv):
        """``(x - mean) * inv * weight + bias`` with ``mean``/``inv`` either
        ``[C]`` or ``[N, C]``."""
        shape = (-1, self.features) + (1,) * (x.dim() - 2)
        lead = x.shape[0] if mean.dim() == 2 else 1
        mean = mean.reshape((lead,) + shape[1:])
        inv = inv.reshape((lead,) + shape[1:])
        w = self.weight.reshape(shape[1:])
        b = self.bias.reshape(shape[1:])
        return (x.to(torch.float32) - mean) * inv * w + b

    def _record(self, count, sum_x, sum_x2):
        self.calib.append(tuple(t.detach().to("cpu", torch.float64)
                                for t in (count, sum_x, sum_x2)))

    def forward(self, x: torch.Tensor,
                sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        xf = x.to(torch.float32)
        if not self.use_batch_stats:
            mean, var = self.running_mean, self.running_var
        elif sample_mask is None:
            axes = (0,) + tuple(range(2, x.dim()))
            mean = xf.mean(dim=axes)
            var = (xf * xf).mean(dim=axes) - mean * mean
            if self.calib is not None:  # busca_tpu/models/reid.py:109-112
                n = float(x.numel() // self.features)
                self._record(torch.full((), n), mean * n,
                             (var + mean * mean) * n)
        else:
            spatial_axes = tuple(range(2, x.dim()))
            spatial = 1
            for s in x.shape[2:]:
                spatial *= s
            if spatial_axes:
                s1 = xf.sum(dim=spatial_axes)  # [N, C]
                s2 = (xf * xf).sum(dim=spatial_axes)
            else:
                s1, s2 = xf, xf * xf
            w = sample_mask.to(torch.float32)
            if w.dim() == 1:
                denom = torch.clamp(w.sum() * spatial, min=1.0)
                mean = (w @ s1) / denom
                var = (w @ s2) / denom - mean * mean
                if self.calib is not None:
                    self._record(w.sum() * spatial, w @ s1, w @ s2)
            else:
                denom_g = torch.clamp(w.sum(0) * spatial, min=1.0)  # [G]
                mean_g = (w.t() @ s1) / denom_g[:, None]  # [G, C]
                ex2_g = (w.t() @ s2) / denom_g[:, None]
                var_g = torch.clamp(ex2_g - mean_g * mean_g, min=0.0)
                inv_g = torch.reciprocal(torch.sqrt(var_g + self.eps))
                ids = torch.argmax(w, dim=-1)  # zero rows -> group 0
                if self.calib is not None:
                    m = w.sum(1)  # a sample's multiplicity
                    self._record(m.sum() * spatial, m @ s1, m @ s2)
                y = self._affine(x, mean_g[ids], inv_g[ids])
                return y.to(x.dtype)
        var = torch.clamp(var, min=0.0)
        inv = torch.reciprocal(torch.sqrt(var + self.eps))
        # busca_tpu/models/reid.py:141-143: float32 statistics and affine,
        # the result in the input's dtype
        return self._affine(x, mean, inv).to(x.dtype)


@contextlib.contextmanager
def collect_bn_calibration(module: nn.Module):
    """Record the calibration aggregates of every :class:`BatchNorm` under
    ``module`` while the block runs: yields ``{name: [(count, sum_x,
    sum_x2), ...]}``, one entry per batch-statistics forward, float64 on
    the host.  Outside the block nothing is recorded and nothing costs."""
    bns = {name: m for name, m in module.named_modules()
           if isinstance(m, BatchNorm)}
    out = {name: [] for name in bns}
    for name, m in bns.items():
        m.calib = out[name]
    try:
        yield out
    finally:
        for m in bns.values():
            m.calib = None


def _conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1,
          padding: int = 0, dtype: torch.dtype = torch.float32) -> Conv2d:
    # busca_tpu/models/reid.py:161-170: nn.Conv(dtype=...) casts the input
    # and the kernel
    return Conv2d(in_ch, out_ch, kernel, stride, padding, bias=False,
                  dtype=dtype)


class Bottleneck(nn.Module):
    """torch-style bottleneck: 1x1 -> 3x3(stride) -> 1x1(x4), post-add
    ReLU; ``downsample`` = [conv, bn] (reference keys ``downsample.0/1``)."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, use_batch_stats: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out_ch = planes * 4
        self.conv1 = _conv(in_ch, planes, 1, dtype=dtype)
        self.bn1 = BatchNorm(planes, use_batch_stats=use_batch_stats)
        self.conv2 = _conv(planes, planes, 3, stride, 1, dtype=dtype)
        self.bn2 = BatchNorm(planes, use_batch_stats=use_batch_stats)
        self.conv3 = _conv(planes, out_ch, 1, dtype=dtype)
        self.bn3 = BatchNorm(out_ch, use_batch_stats=use_batch_stats)
        self.downsample = (
            nn.ModuleList([
                _conv(in_ch, out_ch, 1, stride, dtype=dtype),
                BatchNorm(out_ch, use_batch_stats=use_batch_stats),
            ])
            if has_downsample else None
        )

    def forward(self, x, sample_mask=None):
        out = torch.relu(self.bn1(self.conv1(x), sample_mask))
        out = torch.relu(self.bn2(self.conv2(out), sample_mask))
        out = self.bn3(self.conv3(out), sample_mask)
        identity = x
        if self.downsample is not None:
            conv, bn = self.downsample
            identity = bn(conv(x), sample_mask)
        return torch.relu(out + identity)


class ReIDResNet(nn.Module):
    """GHOST ResNet-50 feature extractor; ``forward`` returns
    ``(logits, feats)`` like the reference (busca/reid/resnet.py:266-334)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 299, red: int = 4,
                 use_batch_stats: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.red_factor = red
        self.compute_dtype = dtype
        self.conv1 = _conv(3, 64, 7, 2, 3, dtype=dtype)
        self.bn1 = BatchNorm(64, use_batch_stats=use_batch_stats)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        in_ch = 64
        for stage, (planes, blocks) in enumerate(
            zip((64, 128, 256, 512), layers)
        ):
            stride = 1 if stage == 0 else 2
            stage_blocks = []
            for block in range(blocks):
                s = stride if block == 0 else 1
                has_ds = block == 0 and (s != 1 or in_ch != planes * 4)
                stage_blocks.append(
                    Bottleneck(in_ch, planes, s, has_ds, use_batch_stats,
                               dtype)
                )
                in_ch = planes * 4
            # ModuleList, not Sequential: blocks take the sample mask too
            setattr(self, f"layer{stage + 1}", nn.ModuleList(stage_blocks))
        self.red = TorchLinear(2048, 2048 // red) if red and red != 1 else None
        self.fc = TorchLinear(2048 // (red or 1), num_classes)

    def forward(self, x: torch.Tensor,
                sample_mask: Optional[torch.Tensor] = None,
                output_option: str = "plain"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``x``: ``[N, H, W, 3]`` normalized NHWC crops; ``sample_mask``:
        ``[N]`` or ``[N, G]`` BN statistics weights."""
        # busca_tpu/models/reid.py:225: x.astype(dtype) at entry
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2).contiguous()
        x = torch.relu(self.bn1(self.conv1(x), sample_mask))
        x = self.maxpool(x)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in stage:
                x = block(x, sample_mask)
        # busca_tpu/models/reid.py:259: the pooled features back to float32
        fc7 = x.amax(dim=(2, 3)).to(torch.float32)  # [N, 2048]
        if self.red is not None:
            fc7 = self.red(fc7)
        logits = self.fc(fc7)
        if output_option == "plain":
            norm = torch.clamp(fc7.norm(dim=-1, keepdim=True), min=1e-12)
            feats = fc7 / norm
        elif output_option == "norm":
            feats = fc7
        else:
            raise ValueError(f"unsupported output_option: {output_option!r}")
        return logits, feats
