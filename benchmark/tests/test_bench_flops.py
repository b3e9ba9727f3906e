"""Operation and byte counts of ``bmk.flops``."""

import numpy as np
import pytest
import torch

from bmk import flops


def test_yolox_x_at_mot20_size_matches_conv_flops_and_a_hand_count():
    from benchref.yolox import YOLOX, YoloxConfig

    with torch.device("meta"):
        model = YOLOX(YoloxConfig.size("x", num_classes=1)).eval()
        x = torch.empty(1, 3, 896, 1600)
    total = flops.yolox_flops("x", 1, (896, 1600))
    assert total == flops.conv_flops(model, x)
    # the Focus stem: 4 x 3 channels -> int(64 * 1.25) = 80, 3x3, on the
    # 448 x 800 space-to-depth image
    stem = model.backbone.backbone.stem.conv.conv
    seen = {}

    def hook_fn(_m, _i, out):
        seen["hw"] = tuple(out.shape[2:])

    hook = stem.register_forward_hook(hook_fn)
    flops.conv_flops(model, x)
    hook.remove()
    assert seen["hw"] == (448, 800)
    assert 2 * 12 * 9 * 80 * 448 * 800 == 6_193_152_000
    assert flops.conv_flops(stem, torch.empty(1, 12, 448, 800,
                                              device="meta")) == 6_193_152_000
    assert 9.0e11 < total < 1.1e12


def test_resnet50_per_384x128_crop():
    per_crop = flops.reid_flops_per_crop((3, 4, 6, 3), 299, (384, 128))
    # the smoke's count for 96 crops, convolutions and the two linears:
    # 768.9 GFLOP
    assert per_crop * 96 == pytest.approx(768.9e9, rel=1e-3)


def test_busca_call_counts_every_crop_and_track():
    b = {"reid_layers": [3, 4, 6, 3], "reid_num_classes": 299,
         "num_candidates": 5, "num_layer": 4, "trans_dim": 512,
         "ff_size": 1024}
    per_crop = flops.reid_flops_per_crop((3, 4, 6, 3), 299, (384, 128))
    one = flops.busca_call_flops(b, 1, 11, 8, (384, 128))
    two = flops.busca_call_flops(b, 2, 11, 8, (384, 128))
    assert two - one == 11 * per_crop + flops.transformer_flops_per_track(
        4, 512, 1024, 11 + 1 + 5 + 1)


def smoke_boxes(rng, n, h, w):
    """``chip_smoke.py::smoke_boxes`` (phase 2's crops)."""
    boxes = []
    for i in range(n):
        bw, bh = rng.uniform(20, 300), rng.uniform(40, 600)
        if i % 8 == 1:
            x1, y1 = rng.uniform(-bw * 0.6, 0), rng.uniform(-bh * 0.6, 0)
        elif i % 8 == 2:
            x1, y1 = rng.uniform(w - bw * 0.4, w), rng.uniform(h - bh * 0.4, h)
        else:
            x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
        boxes.append([x1, y1, x1 + bw, y1 + bh])
    boxes[3] = [-500.0, -400.0, -100.0, -10.0]
    boxes[4] = [w + 10.0, 100.0, w + 200.0, 500.0]
    boxes[5] = [300.0, 300.0, 300.0, 700.0]
    boxes[6] = [500.5, 200.2, 500.9, 200.7]
    return boxes


def test_k1_bytes_reproduce_the_kernel_table():
    """PERF.md's kernel table: 64 crops of a 1080x1920 frame to 384x128
    (phase 2, seed 1) need 42.3 MB, a 0.0126 ms bound."""
    rng = np.random.RandomState(1)
    rng.randint(0, 256, (1080, 1920, 3), dtype=np.uint8)
    boxes = np.asarray(smoke_boxes(rng, 64, 1080, 1920), np.float32)
    out = 64 * 384 * 128 * 3
    nbytes = flops.k1_bytes((1080, 1920), boxes, out)
    assert round(nbytes / 1e6, 1) == 42.3
    assert round(flops.k1_least_seconds((1080, 1920), boxes, out) * 1e3,
                 4) == 0.0126
