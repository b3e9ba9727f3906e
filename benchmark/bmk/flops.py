"""Operations and bytes from shapes, and the card's published peaks: the
arithmetic of ``step_mfu`` and ``kernel.k1_roofline``.

``conv_flops`` is a frozen copy of ``chip_smoke.py::conv_flops`` at commit
c2c24f5; the other counts run the benchmark's reference models on meta
tensors under ``torch.utils.flop_counter.FlopCounterMode`` (two operations
per multiply-add), so they cost no device time and follow the shapes each
forward ran at.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAKS = {
    "float32": 67e12,     # outside the tensor cores (TF32 off)
    "tf32": 495e12,
    "bfloat16": 989e12,
    "hbm_bytes_per_s": 3.35e12,
}


def conv_flops(model, x):
    """float32 operations of one forward: 2 * Cin/groups * k^2 * Cout *
    Hout * Wout per convolution, read from the output shapes with forward
    hooks."""
    import torch

    total = [0]

    def hook(mod, _inp, out):
        k = mod.kernel_size[0] * mod.kernel_size[1]
        total[0] += (2 * mod.in_channels // mod.groups * k
                     * out.shape[1] * out.shape[2] * out.shape[3]
                     * out.shape[0])

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return total[0]


def _count(model, *inputs) -> int:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(*inputs)
    return int(fc.get_total_flops())


@functools.lru_cache(maxsize=None)
def yolox_flops(size: str, num_classes: int, test_hw: Tuple[int, int]) -> int:
    """Operations of one YOLOX forward of one canvas of ``test_hw``."""
    import torch

    from benchref.yolox import YOLOX, YoloxConfig

    with torch.device("meta"):
        model = YOLOX(YoloxConfig.size(size, num_classes=num_classes)).eval()
        x = torch.empty(1, 3, *test_hw)
    return _count(model, x)


@functools.lru_cache(maxsize=None)
def reid_flops_per_crop(layers: Tuple[int, ...], num_classes: int,
                        crop_hw: Tuple[int, int]) -> int:
    """Operations of the ReID ResNet on one crop (its convolutions and its
    linears)."""
    import torch

    from benchref.reid import ReIDResNet

    with torch.device("meta"):
        model = ReIDResNet(layers=tuple(layers),
                           num_classes=num_classes).eval()
        x = torch.empty(1, *crop_hw, 3)
    return _count(model, x)


def transformer_flops_per_track(num_layer: int, d_model: int, ff_size: int,
                                tokens: int) -> int:
    """Operations of BUSCA's Transformer on one track's ``tokens`` tokens:
    per layer the q, k, v and output projections, the two attention
    products and the two feed-forward linears."""
    s, d = tokens, d_model
    per_layer = 2 * s * 4 * d * d + 2 * 2 * s * s * d + 2 * 2 * s * d * ff_size
    return num_layer * per_layer


def busca_call_flops(busca: dict, tracks: int, mem_len: int, units: int,
                     crop_hw: Sequence[int]) -> int:
    """Operations of one association model call: the ReID ResNet on every
    memory crop of every track row and on each candidate unit, and the
    Transformer on every track row (memory, separator, candidates and the
    bad-candidate token)."""
    per_crop = reid_flops_per_crop(tuple(busca["reid_layers"]),
                                   int(busca["reid_num_classes"]),
                                   tuple(crop_hw))
    tokens = mem_len + 1 + int(busca["num_candidates"]) + 1
    per_track = transformer_flops_per_track(
        int(busca["num_layer"]), int(busca["trans_dim"]),
        int(busca["ff_size"]), tokens)
    return per_crop * (tracks * mem_len + units) + per_track * tracks


def k1_bytes(frame_hw: Tuple[int, int], boxes: np.ndarray,
             out_elems: int) -> int:
    """Bytes one K1 launch must move at least: each frame pixel that a valid
    box's cutout covers, read once (uint8, 3 channels), the float32 boxes,
    and the float32 output, written once."""
    h, w = frame_hw
    covered = np.zeros((h, w), bool)
    for x1, y1, x2, y2 in np.asarray(boxes, np.float64).reshape(-1, 4):
        xa, ya = max(int(np.floor(x1)), 0), max(int(np.floor(y1)), 0)
        xb, yb = min(int(np.ceil(x2)), w), min(int(np.ceil(y2)), h)
        if xb > xa and yb > ya:
            covered[ya:yb, xa:xb] = True
    return int(covered.sum()) * 3 + boxes.size * 4 + out_elems * 4


def k1_least_seconds(frame_hw, boxes, out_elems: int) -> float:
    """A K1 launch's least time: the larger of its bytes over the memory
    rate and its float32 operations (about 20 per output element: four taps,
    their weights, the pad test and the rounding) over the float32 rate."""
    t_bytes = k1_bytes(frame_hw, boxes, out_elems) / PEAKS["hbm_bytes_per_s"]
    t_ops = out_elems * 20 / PEAKS["float32"]
    return max(t_bytes, t_ops)
