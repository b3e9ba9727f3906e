#!/usr/bin/env python3
"""Smoke run of the PyTorch port (busca_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each failure exits non-zero before the result line):
1. the card (nvidia-smi name and power limit), torch/CUDA versions, and the
   build of kernels K1 and K2 from busca_tpu_torch/csrc/ (one nvcc each,
   started together), with their ptxas reports;
2. K1 against its plain torch version on the card, exactly: a seeded
   1080x1920 frame, 64 boxes (inside, partly outside, wholly outside,
   degenerate), every flag combination of the crop op; the detectors'
   letterbox shapes (one full-frame box, 1080x1920 -> 612x1088 for
   TransCenter, -> 800x1422 for YOLOX); and the pad
   path at 2160x3840 (values 200-255, boxes across each edge, one covering
   the frame, whose region total passes 2**32); max |diff|, exact share,
   times of the op, the kernel alone and the plain version, and the bound;
3. K2 against its plain torch version, in float32 and in bfloat16 (bf16
   level maps and weights, a float32 accumulator, a bf16 output): over the
   level maps at their own resolutions (the decoder's call) at the MOT17
   pyramid (query 160x272; levels 160x272, 80x136, 40x68, 20x34; C=256, 8
   heads; softmaxed weights) and at a ragged pyramid, and over levels
   stacked at the query size at the MOT17 shape (all exact); max |diff|,
   exact share, times (also of the upsample + stack + K2 chain the decoder
   ran before) and bound;
4. an association drive at 1080p: 16 tracks with full 11-crop memories and
   30 detections, all cropped through K1, scored by the full-width model
   (ResNet-50, d=512, 4 layers) with random seeded weights, in float32
   (TF32 off) and in bf16 (the CLI's default, bf16 products reduced in
   float32); the probability rows must be finite and sum to 1, a small
   request in float32 must agree with the same model on the CPU, and the
   bf16 probabilities must keep the float32 argmax where its margin is
   above 0.05 and lie within 0.12 of them (tests/test_bf16.py's bars);
5. the ByteTrack main path with BUSCA in bf16: ``run_synthetic`` base vs
   BUSCA on the dropout sequence rendered at 1080x1920, with K1's launch
   count read around it;
6. the TransCenter loop: the full-width detector (PVTv2-b2, 6 decoder
   layers, 640x1088, random seeded weights with a calibrated head) against
   the same model on the CPU at 128x224 on all five maps, then
   ``track_frames_with_detector`` with TransCenterByteTracker + BUSCA over
   the dropout sequence at 1080x1920, with K1's and K2's launch counts read
   around it (K2: exactly 12 per frame), the detector step's time, peak
   memory and profile by kernel kind; then the same in bf16 (the detector's
   bf16 config and BUSCA in bf16), its maps held against the float32
   model's on the card, K2's bf16 launches counted;
7. the YOLOX-X loop, the canonical ByteTrack + BUSCA path: the full-width
   detector (depth 1.33, width 1.25, one class, 800x1440) with seeded random
   weights calibrated on the sequence (BN statistics, head biases), against
   the same model on the CPU at 128x224 on the raw head outputs and the
   decoded rows; then ``track_frames_with_detector`` with ByteTracker +
   BUSCA in bf16 over the dropout sequence at 1080x1920, pipelined
   (``put_frame``/``detect_async``) and serial, which must agree frame by
   frame, with K1's launches read around the pipelined run; the step's time,
   peak memory, profile by kernel kind and float32 operation count; a check
   that ``detect_async`` enqueues without a host sync and returns before its
   step ends; then the bf16 YOLOX-X step (the detector's bf16 config): its
   time and profile, and its decoded rows held against the float32 step's;
8. the ``kernels`` JSON line, then the result line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

FRAME_HW = (1080, 1920)
CROP_HW = (384, 128)
N_BOXES = 64
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense
K1_TOL = 0.0  # K1 equals its plain version bit for bit
PROB_TOL = 1e-3  # card vs CPU probabilities, float32 with TF32 off
# bf16 BUSCA against float32 (tests/test_bf16.py's bars): the argmax kept
# where the float32 margin is above BF16_MARGIN, |delta p| <= BF16_PROB_BAR
BF16_MARGIN, BF16_PROB_BAR = 0.05, 0.12
LETTERBOX_HW = (612, 1088)  # 1080x1920 into the 640x1088 test size
YX_LETTERBOX_HW = (800, 1422)  # 1080x1920 into YOLOX's 800x1440
PAD_FRAME_HW = (2160, 3840)  # K1's pad path: a 4K frame of values 200-255
# the flags both main paths crop with (BUSCA crops, the letterbox)
K1_MAIN_KW = dict(normalize=False, bgr_input=True, rgb_output=False,
                  quantize_uint8=True)
# K2: the levels' (h, w) (the first is the query grid), C, heads: the MOT17
# decoder pyramid and a ragged one (SAME-padded sizes, no whole-number ratio)
K2_PYRAMIDS = {"mot17": ([(160, 272), (80, 136), (40, 68), (20, 34)], 256, 8),
               "ragged": ([(13, 17), (7, 9), (4, 5), (2, 3)], 32, 4)}
K2_TOL = 1e-5
TC_TEST_SIZE = (640, 1088)
TC_CPU_SIZE = (128, 224)  # every PVT stage divides: no SAME padding
TC_MAP_TOL = 1e-3  # card vs CPU maps, float32 with TF32 off
# bf16 vs float32 maps on the card, max |diff| over the map's scale
TC_BF16_TOL = 0.1
TC_FRAMES = 20
# The random detector's scores all sit near sigmoid(-4.6) ~ 0.01, below
# BYTE's fixed 0.1 score floor, and its boxes are a few pixels wide.  The
# smoke scales the hm head's output weights by 3 and sets its bias to -1, so
# that some 20-30 peaks per frame score above 0.6 and a few of them flicker
# across it, and sets the wh bias to (12, 30) output cells: 48x120 canvas
# pixels, 85x212 in the 1080p frame (PERF.md section 4).  A stronger gain
# lets the tracker's priors raise more peaks over the threshold each frame.
TC_HM_GAIN, TC_HM_BIAS, TC_WH_BIAS = 3.0, -1.0, (12.0, 30.0)
# every detection above 0.6 is first-round (> 0.5) and starts a track
# (>= 0.6 = track_thresh + 0.1)
TC_OUT_THRESH, TC_TRACK_THRESH = 0.6, 0.5
YX_TEST_SIZE = (800, 1440)
YX_CPU_SIZE = (128, 224)
YX_TOL = 1e-3  # card vs CPU, relative and absolute, float32 with TF32 off
# bf16 vs float32 decoded rows on the card, max |diff| / (1 + |want|), on
# the weights with the backbone's BN variances times YX_BF16_DAMP (the CPU
# at 128x224: 0.017; undamped, the random net's rows differ by O(1))
YX_BF16_DAMP, YX_BF16_TOL = 2.0, 0.05
YX_FRAMES = 20
# The random YOLOX-X is calibrated on the sequence's frames
# (YoloxDetector.calibrate_random_weights): BN statistics measured on them,
# cls bias 4 (class score ~0.98), boxes of 200x80 canvas pixels (270x108 in
# the 1080p frame).  Then, for the first of YX_OBJ_GAINS (a scale of the
# obj weights, which spreads the objectness) that leaves at most
# YX_MAX_DETS detections above YX_CONF on the first frame, the obj bias is
# the least (found by bisection) that leaves YX_FIRST_DETS of them at or
# above the score that starts a track (track_thresh + 0.1), so that the
# frames give some 10-30 detections, a few of them flickering across the
# thresholds.
YX_CLS_BIAS, YX_BOX_HW = 4.0, (200.0, 80.0)
YX_OBJ_GAINS, YX_FIRST_DETS, YX_MAX_DETS = (1, 2, 4, 8, 16, 32), 15, 20
YX_CONF, YX_TRACK_THRESH = 0.3, 0.5


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def cuda_time_ms(fn, reps=20, warmup=3):
    """Mean ms per call over ``reps`` calls, timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_time_ms(fn, reps=20, warmup=3):
    """Mean device ms per call of ``fn`` with the host's time taken out: a
    sleep kernel holds the stream while the host queues the ``reps`` calls,
    so the CUDA events time the device's work alone.  (Back to back, as
    :func:`cuda_time_ms` times, a call that queues less work than its host
    code takes is timed at the host's rate.)  Fails if the hold ended before
    the calls were queued."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # hold for three times the calls' wall time, at up to 2e9 cycles/s
    torch.cuda._sleep(int(3 * wall_s * 2e9) + 1000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    held = not start.query()
    torch.cuda.synchronize()
    check(held, "the stream hold ended before the timed calls were queued")
    return start.elapsed_time(end) / reps


def smoke_boxes(rng, n, h, w):
    """ltrb boxes: mostly inside, some partly outside, two wholly outside,
    two degenerate."""
    boxes = []
    for i in range(n):
        bw, bh = rng.uniform(20, 300), rng.uniform(40, 600)
        if i % 8 == 1:      # partly outside (left/top)
            x1, y1 = rng.uniform(-bw * 0.6, 0), rng.uniform(-bh * 0.6, 0)
        elif i % 8 == 2:    # partly outside (right/bottom)
            x1, y1 = rng.uniform(w - bw * 0.4, w), rng.uniform(h - bh * 0.4, h)
        else:
            x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
        boxes.append([x1, y1, x1 + bw, y1 + bh])
    boxes[3] = [-500.0, -400.0, -100.0, -10.0]          # wholly outside
    boxes[4] = [w + 10.0, 100.0, w + 200.0, 500.0]      # wholly outside
    boxes[5] = [300.0, 300.0, 300.0, 700.0]             # degenerate width
    boxes[6] = [500.5, 200.2, 500.9, 200.7]             # floor/ceil 1x1
    return boxes


def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi unavailable"
    print(card)  # as nvidia-smi prints it: name, power limit
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    from concurrent.futures import ThreadPoolExecutor

    from busca_tpu_torch.ops import crop_cuda, lma_cuda

    libs = {"K1": crop_cuda.LIBRARY, "K2": lma_cuda.LIBRARY}
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(libs)) as pool:
        builds = dict(zip(libs, pool.map(lambda lib: lib.build(),
                                         libs.values())))
    for tag, (secs, report) in builds.items():
        print(f"{tag} build: {secs:.2f} s "
              f"({os.path.relpath(libs[tag].library_path())})")
        print(report)
    print(f"K1 + K2 builds in parallel: {time.perf_counter() - t0:.2f} s")


def hold_against_plain(label, op, plain, kernel_alone, counter, tol, shape,
                       timed=True):
    """Hold one kernel against its plain torch version on the same inputs.

    Checks the op's output (on the card, of ``shape``, finite, max |diff|
    to ``plain()`` within ``tol``) and prints max |diff| and the exact
    share.  When ``timed``, also times the op, ``kernel_alone()`` (the
    kernel on prepared inputs) and the plain version back to back
    (:func:`cuda_time_ms`), and the op and the kernel on the device alone
    (:func:`device_time_ms`).  The launches made
    here are taken back off ``counter.launches``: only the main path's
    count.  Returns the fields for the ``kernels`` line."""
    import torch

    launches0 = counter.launches
    got = op()
    want = plain()
    torch.cuda.synchronize()
    check(tuple(got.shape) == tuple(shape) and got.is_cuda,
          f"{label} shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), f"{label} non-finite")
    diff = (got - want).abs()
    err = float(diff.max())
    exact = float((diff == 0).float().mean())
    print(f"{label} vs plain: max|diff| {err:.3g} exact {exact * 100:.4f}% "
          f"(tol {tol:.3g})")
    check(err <= tol, f"{label} disagrees with plain: {err} > {tol}")
    out = {"max_abs_err": err}
    if timed:
        out["ms"] = cuda_time_ms(op)
        out["kernel_ms"] = cuda_time_ms(kernel_alone)
        out["plain_ms"] = cuda_time_ms(plain, reps=5, warmup=1)
        out["device_ms"] = device_time_ms(op)
        out["kernel_device_ms"] = device_time_ms(kernel_alone)
    counter.launches = launches0
    return out


def bound_ms(frame_hw, boxes_np, n_out_elems):
    """Least time for the crop op at these inputs: bytes (the frame pixels
    the valid boxes cover, the boxes, the float32 output) over the memory
    rate, or float32 operations (~20 per output element) over the float32
    rate, whichever is larger."""
    import numpy as np

    h, w = frame_hw
    covered = np.zeros((h, w), bool)
    for x1, y1, x2, y2 in boxes_np:
        xa, ya = max(int(np.floor(x1)), 0), max(int(np.floor(y1)), 0)
        xb, yb = min(int(np.ceil(x2)), w), min(int(np.ceil(y2)), h)
        if xb > xa and yb > ya:
            covered[ya:yb, xa:xb] = True
    nbytes = covered.sum() * 3 + boxes_np.size * 4 + n_out_elems * 4
    ops = n_out_elems * 20
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), int(nbytes)


def k1_inputs(device, seed, boxes_fn, frame_hw=FRAME_HW, low=0):
    """A seeded uint8 frame on ``device`` with values in ``low``..255 and
    its boxes, on the host and on ``device``."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    h, w = frame_hw
    frame = torch.from_numpy(
        rng.randint(low, 256, (h, w, 3), dtype=np.uint8)).to(device)
    boxes_np = np.asarray(boxes_fn(rng, h, w), np.float32)
    return frame, boxes_np, torch.from_numpy(boxes_np).to(device)


def k1_case(device, seed, boxes_fn, out_hw, frame_hw=FRAME_HW, low=0):
    """:func:`k1_inputs` and the kernel-alone buffers: the output and the
    scratch."""
    from busca_tpu_torch.ops import crop_cuda

    frame, boxes_np, boxes = k1_inputs(device, seed, boxes_fn, frame_hw, low)
    out, scratch = crop_cuda.buffers(len(boxes_np), out_hw, device)
    return frame, boxes_np, boxes, scratch, out


def hold_k1(label, frame, boxes, scratch, out, kw, timed):
    from busca_tpu_torch.ops import crop_cuda
    from busca_tpu_torch.ops.crop import crop_resize_normalize_plain
    from busca_tpu_torch.ops.crop_cuda import crop_resize_cuda

    out_hw = tuple(out.shape[1:3])
    return hold_against_plain(
        label,
        lambda: crop_resize_cuda(frame, boxes, out_hw, **kw),
        lambda: crop_resize_normalize_plain(frame, boxes, out_hw, **kw),
        lambda: crop_cuda.launch(frame, boxes, scratch, out, **kw),
        crop_resize_cuda, K1_TOL, out.shape, timed=timed)


def report_k1(label, result, frame_hw, boxes_np, out):
    """Adds K1's bound at this case to ``result`` and prints the case's op,
    kernel-alone, plain and bound times."""
    result["bound_ms"], bound_by, nbytes = bound_ms(frame_hw, boxes_np,
                                                    out.numel())
    print(f"K1 {label}: op {result['ms']:.4f} ms (kernel alone "
          f"{result['kernel_ms']:.4f} ms), plain {result['plain_ms']:.4f} "
          f"ms back to back; on the device alone op "
          f"{result['device_ms']:.4f} ms, kernel "
          f"{result['kernel_device_ms']:.4f} ms; bound "
          f"{result['bound_ms']:.4f} ms by {bound_by} "
          f"({nbytes / 1e6:.1f} MB)")
    return bound_by


def phase_k1(device):
    frame, boxes_np, boxes, scratch, out = k1_case(
        device, 1, lambda rng, h, w: smoke_boxes(rng, N_BOXES, h, w),
        CROP_HW)
    result = None
    for normalize in (False, True):
        for quantize in (True, False):
            for rgb_output in (False, True):
                kw = dict(normalize=normalize, bgr_input=True,
                          rgb_output=rgb_output, quantize_uint8=quantize)
                main = kw == K1_MAIN_KW
                held = hold_k1(f"K1 normalize={normalize} quantize="
                               f"{quantize} rgb={rgb_output}", frame, boxes,
                               scratch, out, kw, timed=main)
                if main:
                    result = held
    bound_by = report_k1(f"at N={N_BOXES} {FRAME_HW} -> {CROP_HW}", result,
                         FRAME_HW, boxes_np, out)
    print("K1: no single PyTorch call computes this crop, so no library "
          "time")
    return {
        "name": "crop_resize (K1)",
        "route": "cuda",
        "source": "busca_tpu_torch/csrc/crop_resize.cu",
        "replaces": "busca_tpu/ops/crop_pallas.py:50",
        **result,
        "bound_by": bound_by,
        "library_ms": None,
    }


def phase_k1_letterbox(device, out_hw, label):
    """K1 at a detector's letterbox shape: one full-frame box, 1080x1920 ->
    ``out_hw`` (612x1088 for TransCenter, 800x1422 for YOLOX), quantized,
    not normalized."""
    frame, boxes_np, boxes, scratch, out = k1_case(
        device, 3, lambda rng, h, w: [[0.0, 0.0, float(w), float(h)]],
        out_hw)
    result = hold_k1(f"K1 at the {label} letterbox shape {FRAME_HW} -> "
                     f"{out_hw}", frame, boxes, scratch, out,
                     K1_MAIN_KW, timed=True)
    report_k1(f"{label} letterbox", result, FRAME_HW, boxes_np, out)
    return result


def pad_path_boxes(rng, h, w):
    """Boxes across each edge and corner of the frame, one covering the
    frame and more, one inside, one wholly outside."""
    return [
        [-120.5, 0.37 * h, 180.2, 0.6 * h],           # left edge
        [0.39 * w, -90.6, 0.47 * w + 0.9, 400.1],     # top edge
        [w - 140.4, 0.55 * h, w + 110.8, 0.79 * h],   # right edge
        [0.65 * w, h - 260.3, 0.7 * w + 0.6, h + 140.9],  # bottom edge
        [-50.5, -60.5, 250.5, 500.5],                 # top-left corner
        [w - 240.0, h - 360.0, w + 60.0, h + 40.0],   # bottom-right corner
        [-100.0, -50.0, w + 100.0, h + 50.0],         # covers the frame
        [0.26 * w + 0.5, 0.46 * h + 0.5, 0.31 * w + 0.5, 0.69 * h + 0.5],
        [-400.0, 100.0, -10.0, 300.0],                # wholly outside
    ]


def phase_k1_pad_path(device):
    """K1's pad sums at 2160x3840: every edge crossed, and a box covering the
    frame whose region total passes 2**32; exact against the plain
    version."""
    import torch

    frame, boxes_np, boxes, scratch, out = k1_case(
        device, 4, pad_path_boxes, CROP_HW, frame_hw=PAD_FRAME_HW, low=200)
    total = int(frame.to(torch.int64).sum())
    check(total > 2 ** 32, f"the covering box's total {total} <= 2**32")
    result = hold_k1(f"K1 pad path {PAD_FRAME_HW} -> {CROP_HW}, "
                     f"{len(boxes_np)} boxes, covering total {total}", frame,
                     boxes, scratch, out, K1_MAIN_KW, timed=True)
    report_k1("pad path", result, PAD_FRAME_HW, boxes_np, out)
    return result


def k2_bound_ms(level_hw, c, heads, dils, elem_bytes=4):
    """Least time for the tap sum over level maps: bytes (each level read
    once at its own resolution, the weights once, the output written once,
    ``elem_bytes`` each) over the memory rate, or float32 operations over
    the float32 rate, whichever is larger.  Operations, per channel, as the
    plain version computes them: an upsampled level interpolated once,
    x-lerps at h_l x W4 and y-lerps at H4 x W4 of 3 operations each, then a
    multiply and an add for every tap inside the grid."""
    (h4, w4), levels = level_hw[0], len(level_hw)
    nbytes = elem_bytes * (sum(h * w * c for h, w in level_hw)
                           + h4 * w4 * heads * levels * 9 + h4 * w4 * c)
    ops = 0
    for (h, w), d in zip(level_hw, dils):
        inside = (sum(max(h4 - abs(k) * d, 0) for k in (-1, 0, 1))
                  * sum(max(w4 - abs(k) * d, 0) for k in (-1, 0, 1)))
        ops += inside * c * 2
        if (h, w) != (h4, w4):
            ops += 3 * (h * w4 + h4 * w4) * c
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, ops


def k2_pyramid(device, level_hw, c, heads, seed=5, dtype="float32"):
    """Seeded level maps at their own resolutions and softmaxed weights, in
    ``dtype`` (bf16: the float32 draws rounded)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    h4, w4 = level_hw[0]
    dt = getattr(torch, dtype)
    levels = [torch.randn((h, w, c), generator=g).to(device, dt)
              for h, w in level_hw]
    wts = torch.randn((h4, w4, heads, len(level_hw) * 9),
                      generator=g).softmax(-1).to(device, dt)
    dils = tuple(max(h4 // h, 1) for h, _ in level_hw)
    return levels, wts, dils


def phase_k2_dtype(device, dtype):
    """K2 in ``dtype`` against its plain version at both pyramids and on
    stacked levels; times and bound at the MOT17 pyramid."""
    import torch
    import torch.nn.functional as F

    from busca_tpu_torch.ops import lma_cuda
    from busca_tpu_torch.ops.lma import (
        local_tap_sum,
        local_tap_sum_levels,
        local_tap_sum_levels_plain,
        local_tap_sum_plain,
        upsample_bilinear_plain,
    )
    from busca_tpu_torch.ops.lma_cuda import local_tap_sum_cuda

    result = None
    for name, (level_hw, c, heads) in K2_PYRAMIDS.items():
        levels, wts, dils = k2_pyramid(device, level_hw, c, heads,
                                       dtype=dtype)
        h4, w4 = level_hw[0]
        out = torch.empty((h4, w4, c), device=device, dtype=wts.dtype)
        # bf16 is exact too: the plain version rounds where the kernel does
        held = hold_against_plain(
            f"K2 {dtype} over the levels at {name} ({level_hw}, C={c}, "
            f"{heads} heads, dils {dils})",
            lambda: local_tap_sum_levels(levels, wts, dils, heads),
            lambda: local_tap_sum_levels_plain(levels, wts, dils),
            lambda: lma_cuda.launch(levels, wts, dils, heads, out),
            local_tap_sum_cuda, K2_TOL if dtype == "float32" else 0.0,
            out.shape, timed=name == "mot17")
        if name != "mot17":
            continue
        # the decoder's chain before: upsample with F.interpolate, stack,
        # then K2 on the stacked maps
        def chain():
            up = [v if v.shape[:2] == (h4, w4) else F.interpolate(
                v.permute(2, 0, 1)[None], size=(h4, w4), mode="bilinear",
                align_corners=False)[0].permute(1, 2, 0) for v in levels]
            return local_tap_sum(torch.stack(up), wts, dils, heads)

        launches0 = local_tap_sum_cuda.launches
        chain_ms = cuda_time_ms(chain)
        local_tap_sum_cuda.launches = launches0
        bms, bound_by, nbytes, ops = k2_bound_ms(level_hw, c, heads, dils,
                                                 wts.element_size())
        print(f"K2 {dtype} over the levels at {name}: op {held['ms']:.4f} ms "
              f"(kernel alone {held['kernel_ms']:.4f} ms; on the device "
              f"alone {held['device_ms']:.4f} / "
              f"{held['kernel_device_ms']:.4f} ms), plain "
              f"{held['plain_ms']:.4f} ms, the chain it replaces (interpolate"
              f" + stack + K2) {chain_ms:.4f} ms, bound {bms:.4f} ms by "
              f"{bound_by} ({nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP); "
              "no single PyTorch call computes this tap sum, so no library "
              "time")
        # the stacked counterpart of lma_pallas.local_tap_sum: every level
        # at the query size, through the same kernel, bit for bit
        vals = torch.stack([upsample_bilinear_plain(v, (h4, w4))
                            for v in levels])
        stacked = hold_against_plain(
            f"K2 {dtype} over stacked levels at {name} "
            f"({tuple(vals.shape)})",
            lambda: local_tap_sum(vals, wts, dils, heads),
            lambda: local_tap_sum_plain(vals, wts, dils),
            lambda: lma_cuda.launch(list(vals.unbind(0)), wts, dils, heads,
                                    out),
            local_tap_sum_cuda, 0.0, out.shape)
        print(f"K2 {dtype} over stacked levels at {name}: op "
              f"{stacked['ms']:.4f} ms (kernel alone "
              f"{stacked['kernel_ms']:.4f} ms), plain "
              f"{stacked['plain_ms']:.4f} ms")
        result = {**held, "bound_ms": bms, "bound_by": bound_by,
                  "library_ms": None, "chain_ms": chain_ms,
                  "stacked": stacked}
    return result


def phase_k2(device):
    """K2's ``kernels`` entry: the float32 case, with the bf16 case (the
    same kernel instantiated for bf16 inputs) under ``bf16``."""
    k2 = {
        "name": "local_tap_sum (K2)",
        "route": "cuda",
        "source": "busca_tpu_torch/csrc/local_tap_sum.cu",
        "replaces": "busca_tpu/ops/lma_pallas.py:60",
        **phase_k2_dtype(device, "float32"),
    }
    k2["bf16"] = phase_k2_dtype(device, "bfloat16")
    return k2


def make_track(Track, crops, tlwhs, score=0.9):
    t = Track(tlwhs[0], score, image=crops[0])
    for crop, tlwh in zip(crops[1:], tlwhs[1:]):
        t.images_mem.append(crop)
        t.tlwh_mem.append(tlwh)
        t.conf_mem.append(score)
    t._tlwh = tlwhs[-1].copy()
    t.activate(1)
    return t


def association_request(engine, rng, frame, n_tracks, n_dets):
    """16-track, 30-detection request at 1080p, its crops through K1 into
    ``engine``'s bank: (tracks, detections, Kalman candidates)."""
    import numpy as np

    from busca_tpu_torch.trackers.base import (
        KALMAN_CANDIDATE_CONF,
        Track,
        extract_uint8_crops,
    )

    h, w = frame.shape[:2]
    device = engine.device
    tracks = []
    for _ in range(n_tracks):
        x, y = rng.uniform(0, w - 200), rng.uniform(0, h - 400)
        tlwhs = [np.array([x + 3 * k, y + k, 80.0, 200.0])
                 for k in range(engine.seq_len)]
        crops = extract_uint8_crops(
            frame, [b[:2].tolist() + (b[:2] + b[2:]).tolist() for b in tlwhs],
            CROP_HW, bank=engine.bank, device=device)
        tracks.append(make_track(Track, crops, tlwhs))
    det_boxes = []
    for _ in range(n_dets):
        x, y = rng.uniform(-40, w - 100), rng.uniform(-40, h - 200)
        det_boxes.append([x, y, x + rng.uniform(40, 160),
                          y + rng.uniform(100, 400)])
    det_crops = extract_uint8_crops(frame, det_boxes, CROP_HW,
                                    bank=engine.bank, device=device)
    dets = [Track(np.array([b[0], b[1], b[2] - b[0], b[3] - b[1]]), 0.8, c)
            for b, c in zip(det_boxes, det_crops)]
    kal_crops = extract_uint8_crops(frame, [t.tlbr for t in tracks],
                                    CROP_HW, bank=engine.bank, device=device)
    kals = [Track(t.tlwh, np.float32(KALMAN_CANDIDATE_CONF), c)
            for t, c in zip(tracks, kal_crops)]
    return tracks, dets, kals


def time_associate(engine, request, label):
    """ms per ``associate`` (median of 5 after one warm call) and the
    request's probability matrix (``_score_prepped``: every row)."""
    import numpy as np
    import torch

    tracks, dets, kals = request

    def run():
        return engine.associate(tracks, dets, extra_kalman_candidates=kals)

    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        probs_matrix, reliable = run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    n_tracks, n_dets = len(tracks), len(dets)
    check(probs_matrix.shape == (n_tracks, n_dets + n_tracks),
          f"{label} probs matrix shape {probs_matrix.shape}")
    check(bool(reliable.all()), "full memories must be reliable")
    req = engine._prep_request(tracks, dets, extra_kalman_candidates=kals)
    probs = engine._score_prepped(req, True)
    row_sums = probs.sum(-1)
    check(np.isfinite(probs).all(), f"{label}: non-finite probabilities")
    check(np.allclose(row_sums, 1.0, atol=1e-5),
          f"{label}: probability rows do not sum to 1: {row_sums}")
    print(f"association {label} T={n_tracks} D={n_dets} (+{n_tracks} "
          f"Kalman) at {FRAME_HW[0]}x{FRAME_HW[1]}: {np.median(times):.2f} "
          f"ms median of {len(times)} "
          f"({', '.join(f'{t:.2f}' for t in times)}); rows finite, "
          f"max |sum-1| {np.abs(row_sums - 1).max():.2e}")
    return probs


def phase_association(device):
    """Returns the float32 engine and the bf16 one (the CLI's default),
    both from ``build_engine`` with seed 0: the same weights."""
    import numpy as np
    import torch

    from busca_tpu_torch.assoc.engine import AssociationEngine
    from busca_tpu_torch.eval.run import build_engine

    rng = np.random.RandomState(2)
    h, w = FRAME_HW
    frame = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
    engines = {}
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        engines[dtype], _ = build_engine(device=device, crop_hw=CROP_HW,
                                         seed=0, dtype=dtype)
        print(f"engine build (ResNet-50, d=512, 4 layers, {dtype}): "
              f"{time.perf_counter() - t0:.2f} s")
    engine, engine16 = engines["float32"], engines["bfloat16"]
    check(all(torch.equal(a, b) for a, b in zip(
        engine.model.state_dict().values(),
        engine16.model.state_dict().values())),
        "the float32 and bf16 engines' weights differ")
    n_tracks, n_dets, seq_len = 16, 30, engine.seq_len
    # one request per engine (each keeps its crops in its own bank), the
    # same boxes: the generator is reseeded
    probs = {}
    requests = {}
    for dtype, eng in engines.items():
        requests[dtype] = association_request(
            eng, np.random.RandomState(3), frame, n_tracks, n_dets)
        probs[dtype] = time_associate(eng, requests[dtype], dtype)

    # bf16 against float32 on the card: tests/test_bf16.py's bars
    p32, p16 = probs["float32"], probs["bfloat16"]
    srt = np.sort(p32, -1)
    confident = srt[:, -1] - srt[:, -2] > BF16_MARGIN
    same = (p16.argmax(-1) == p32.argmax(-1))[confident]
    dp = float(np.abs(p16 - p32).max())
    print(f"association bf16 vs float32 on the card: argmax equal on "
          f"{int(same.sum())} of {int(confident.sum())} rows whose float32 "
          f"margin > {BF16_MARGIN} ({len(p32)} rows); max |dp| {dp:.4g} "
          f"(bar {BF16_PROB_BAR})")
    check(bool(same.all()), "bf16 BUSCA changed a confident argmax")
    check(dp <= BF16_PROB_BAR, f"bf16 BUSCA |dp| {dp} > {BF16_PROB_BAR}")

    # the float32 model on the CPU, on a small request (2 tracks, 5 dets)
    tracks, dets, kals = requests["float32"]
    cpu_model = type(engine.model)(engine.config)
    cpu_model.load_state_dict(
        {k: v.cpu() for k, v in engine.model.state_dict().items()})
    cpu_engine = AssociationEngine(engine.config, cpu_model.eval(),
                                   seq_len=seq_len, crop_hw=CROP_HW)
    small = (tracks[:2], dets[:5])
    want = cpu_engine._score_prepped(cpu_engine._prep_request(
        *small, extra_kalman_candidates=kals[:2]), True)
    got = engine._score_prepped(engine._prep_request(
        *small, extra_kalman_candidates=kals[:2]), True)
    err = float(np.abs(got - want).max())
    print(f"card vs CPU probabilities (T=2, D=5): max|diff| {err:.3g} "
          f"(tol {PROB_TOL})")
    check(err <= PROB_TOL, f"card and CPU disagree: {err}")
    return engine, engine16


def phase_main_path(device, engine):
    import numpy as np

    from busca_tpu_torch.eval.run import run_synthetic
    from busca_tpu_torch.eval.synthetic import (
        SyntheticSequence,
        default_dropout_sequence,
    )
    from busca_tpu_torch.ops.crop_cuda import crop_resize_cuda
    from busca_tpu_torch.trackers.base import Track

    base = default_dropout_sequence(40)
    seq = SyntheticSequence(base.objects, num_frames=base.num_frames,
                            height=FRAME_HW[0], width=FRAME_HW[1],
                            seed=base.seed)

    class Args:
        tracker = "byte"
        num_frames = seq.num_frames
        crop_hw = CROP_HW

    third_rounds = [0]
    assoc = engine.associate

    def counted(*a, **k):
        third_rounds[0] += 1
        return assoc(*a, **k)

    engine.associate = counted
    # the card host has no cv2: set CMC off explicitly rather than let ECC
    # fall back to an identity warp
    kwargs = {"use_busca": True, "use_camera_motion_compensation": False}
    Track.reset_id_counter()
    crop_resize_cuda.launches = 0
    out = run_synthetic(Args, engine, kwargs, seq=seq)
    launches = crop_resize_cuda.launches
    engine.associate = assoc
    for tag in ("base", "busca"):
        m = out[tag]
        print(f"main path {tag} (BUSCA {engine.config.dtype}): MOTA "
              f"{m['mota']:.4f} IDF1 {m['idf1']:.4f} "
              f"HOTA {m['hota']:.4f} IDs {m['ids']} FP {m['fp']} "
              f"FN {m['fn']} {1e3 / m['fps']:.2f} ms/frame "
              f"({seq.height}x{seq.width}, {seq.num_frames} frames)")
        check(all(np.isfinite(m[k]) for k in ("mota", "idf1", "hota")),
              "non-finite metrics")
    print(f"main path: {third_rounds[0]} third rounds, K1 launches "
          f"{launches}")
    check(third_rounds[0] >= 1, "no third round ran")
    check(launches > 0, "the main path never launched K1")
    return launches


def calibrate_heads(model):
    """The smoke's head calibration of the random detector (see
    TC_HM_GAIN)."""
    import torch

    with torch.no_grad():
        model.hm_out.weight.mul_(TC_HM_GAIN)
        model.hm_out.bias.fill_(TC_HM_BIAS)
        model.wh_out.bias.copy_(torch.tensor(TC_WH_BIAS))


KERNEL_KINDS = (  # (kind, substrings of a kernel's name), first match wins
    ("K2 local_tap_sum", ("local_tap_sum",)),
    ("K1 crop_resize", ("crop_resize",)),
    # before matmul: cuDNN's implicit-GEMM convolutions carry "gemm"/"xmma"
    ("convolution", ("conv", "cudnn", "implicit", "winograd", "fprop")),
    ("matmul", ("gemm", "xmma", "cutlass", "cublas", "splitk")),
    ("max pool", ("max_pool", "pool2d")),
    ("upsample", ("upsample",)),
    ("softmax", ("softmax",)),
    ("layer norm", ("layer_norm", "layernorm")),
    ("sort", ("sort", "radix")),
)


def profile_step(step, step_ms, reps=3, label="detector step"):
    """Device time of ``reps`` calls of ``step`` by kernel kind
    (torch.profiler), and its idle share of ``step_ms``, the step's time
    measured without the profiler (whose own overhead stretches the
    profiled wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    by_kind = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.lower()
        kind = next((k for k, keys in KERNEL_KINDS
                     if any(key in name for key in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + \
            e.time_range.elapsed_us() / 1e3 / reps
    busy = sum(by_kind.values())
    if not busy:
        print(f"{label} profile: the profiler recorded no device time "
              "(not measured)")
        return
    parts = ", ".join(f"{k} {v:.2f} ms ({100 * v / busy:.1f}%)"
                      for k, v in sorted(by_kind.items(),
                                         key=lambda kv: -kv[1]))
    print(f"{label} profile (mean of {reps}): device busy "
          f"{busy:.2f} ms of the {step_ms:.2f} ms step, idle "
          f"{100 * (1 - busy / step_ms):.1f}%; {parts}")
    up = by_kind.get("upsample", 0.0)
    print(f"{label} profile: upsample {up:.2f} ms "
          f"({100 * up / busy:.1f}% of the device time)")


def check_against_cpu(det, device):
    """The float32 detector's five maps against the same model on the CPU
    at TC_CPU_SIZE."""
    import torch

    from busca_tpu_torch.models.transcenter import TransCenterDETR

    cpu_model = TransCenterDETR(det.config)
    cpu_model.load_state_dict(
        {k: v.cpu() for k, v in det.model.state_dict().items()})
    cpu_model.eval()
    g = torch.Generator().manual_seed(6)
    h, w = TC_CPU_SIZE
    down = det.config.down_ratio
    args = (torch.randn((1, h, w, 3), generator=g),
            torch.randn((1, h, w, 3), generator=g),
            torch.rand((1, h // down, w // down, 1), generator=g))
    with torch.no_grad():
        want = cpu_model(*args)
        got = det.model(*(a.to(device) for a in args))
    torch.cuda.synchronize()
    for k in want:
        check(got[k].shape == want[k].shape, f"map {k} shape")
        check(bool(torch.isfinite(got[k]).all()), f"map {k} non-finite")
        err = float((got[k].cpu() - want[k]).abs().max())
        print(f"TransCenter card vs CPU at {h}x{w}, map {k} "
              f"{tuple(got[k].shape)}: max|diff| {err:.3g} "
              f"(tol {TC_MAP_TOL})")
        check(err <= TC_MAP_TOL, f"card and CPU disagree on {k}: {err}")


def check_against_float32(det, ref, frame):
    """The bf16 detector's five maps against the float32 detector's (the
    same weights) on the card, at the test size on ``frame``'s canvas as its
    own previous frame: max |diff| over the float32 map's largest
    magnitude."""
    import torch

    from busca_tpu_torch.eval.detector import normalize_canvas

    canvas, _ = det.prep(torch.as_tensor(frame).to(det.device))
    x = normalize_canvas(canvas, det._mean, det._std)[None]
    down = det.config.down_ratio
    pre_hm = torch.zeros((1, TC_TEST_SIZE[0] // down,
                          TC_TEST_SIZE[1] // down, 1), device=det.device)
    with torch.no_grad():
        got = det.model(x, x, pre_hm)
        want = ref.model(x, x, pre_hm)
    for k in want:
        check(got[k].dtype == torch.bfloat16,
              f"bf16 map {k} is {got[k].dtype}")
        check(bool(torch.isfinite(got[k]).all()), f"bf16 map {k} non-finite")
        g, w = got[k].float(), want[k]
        share = float((g - w).abs().max() / w.abs().max())
        mean = float((g - w).abs().mean() / w.abs().mean())
        print(f"TransCenter bf16 vs float32 on the card at {TC_TEST_SIZE}, "
              f"map {k} {tuple(g.shape)}: max|diff| {share:.4g} of the "
              f"map's scale, mean |diff| {mean:.4g} of its mean |value| "
              f"(tol {TC_BF16_TOL})")
        check(share <= TC_BF16_TOL, f"bf16 map {k} off by {share} of scale")


def phase_transcenter(device, engine, k2_ms, dtype="float32", ref=None):
    """The TransCenter loop with the detector's config in ``dtype`` and
    BUSCA in ``engine``'s.  float32 is held against the same model on the
    CPU, bf16 against ``ref`` (the float32 detector) on the card.  Returns
    K1's and K2's launches over the loop, and the detector."""
    import numpy as np
    import torch

    from busca_tpu_torch.eval.detector import (
        TransCenterDetector,
        track_frames_with_detector,
    )
    from busca_tpu_torch.eval.run import make_tracker
    from busca_tpu_torch.eval.synthetic import (
        SyntheticSequence,
        default_dropout_sequence,
    )
    from busca_tpu_torch.models.transcenter import TransCenterConfig
    from busca_tpu_torch.ops.crop_cuda import crop_resize_cuda
    from busca_tpu_torch.ops.lma_cuda import local_tap_sum_cuda
    from busca_tpu_torch.trackers.base import Track

    cfg = TransCenterConfig.for_dataset("mot17", dtype=dtype)
    t0 = time.perf_counter()
    det = TransCenterDetector(cfg, test_size=TC_TEST_SIZE,
                              out_thresh=TC_OUT_THRESH, device=device, seed=0)
    calibrate_heads(det.model)
    n_params = sum(p.numel() for p in det.model.parameters())
    print(f"TransCenter {dtype} build (PVTv2-b2, hidden {cfg.hidden_dim}, "
          f"{cfg.num_decoder_layers} decoder layers, {cfg.dec_heads} heads, "
          f"K={cfg.K}, {n_params} parameters): "
          f"{time.perf_counter() - t0:.2f} s")
    down = cfg.down_ratio
    base = default_dropout_sequence(40)
    seq = SyntheticSequence(base.objects, num_frames=base.num_frames,
                            height=FRAME_HW[0], width=FRAME_HW[1],
                            seed=base.seed)
    frames = [seq.frame(t) for t in range(TC_FRAMES)]
    if ref is None:
        check_against_cpu(det, device)
    else:
        check_against_float32(det, ref, frames[0])

    # warm-up frame (cuDNN algorithm choice, allocator), then the steady
    # step time with CUDA events on a fixed canvas
    det.reset()
    det.out_thresh = 0.0  # the first frame's score spread, for the record
    probe = det.detect(frames[0])
    det.out_thresh = TC_OUT_THRESH
    top = np.sort(probe.scores)[::-1]
    print(f"TransCenter {dtype} first frame: {len(top)} detections after "
          f"NMS; every 5th of the "
          f"top 100 scores {np.round(top[:100:5], 3).tolist()}; above "
          + ", ".join(f"{th}: {int((top > th).sum())}"
                      for th in (0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)))
    frame0 = torch.as_tensor(frames[0]).to(device)
    canvas, _ = det.prep(frame0)
    pre_hm = torch.zeros((TC_TEST_SIZE[0] // down, TC_TEST_SIZE[1] // down,
                          1), device=device)
    step_ms = cuda_time_ms(lambda: det.step(canvas, canvas, pre_hm), reps=5,
                           warmup=1)
    print(f"TransCenter {dtype} detector step (forward, decode, NMS) at "
          f"{TC_TEST_SIZE}: {step_ms:.2f} ms")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    det.step(canvas, canvas, pre_hm)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"TransCenter {dtype} step peak memory: {peak / 1e6:.1f} MB "
          f"allocated, {(peak - held) / 1e6:.1f} MB above the "
          f"{held / 1e6:.1f} MB held before the step")

    # CMC off: the card host has no cv2
    tracker = make_tracker(
        "transcenter", {"use_busca": True, "track_thresh": TC_TRACK_THRESH,
                        "use_camera_motion_compensation": False},
        engine, CROP_HW)
    third_rounds = [0]
    assoc = engine.associate

    def counted(*a, **k):
        third_rounds[0] += 1
        return assoc(*a, **k)

    engine.associate = counted
    log = []
    det.reset()
    Track.reset_id_counter()
    crop_resize_cuda.launches = 0
    local_tap_sum_cuda.launches = 0
    res = track_frames_with_detector(det, tracker, frames,
                                     name="synthetic-1080p", det_log=log)
    k1_launches = crop_resize_cuda.launches
    k2_launches = local_tap_sum_cuda.launches
    engine.associate = assoc

    n_dets = [len(s) for _, _, s in log]
    n_tracks = [len(r[2]) for r in res.results]
    det_ms = res.stage_times["detector_s"] * 1e3 / res.num_frames
    trk_ms = res.stage_times["tracker_s"] * 1e3 / res.num_frames
    print(f"TransCenter {dtype} loop ({FRAME_HW[0]}x{FRAME_HW[1]}, "
          f"{res.num_frames} frames, out_thresh {TC_OUT_THRESH}, track_thresh "
          f"{TC_TRACK_THRESH}): detections per frame {n_dets} (mean "
          f"{np.mean(n_dets):.1f}); output tracks per frame {n_tracks}")
    print(f"TransCenter {dtype} loop: detector {det_ms:.2f} ms/frame, "
          f"tracker {trk_ms:.2f} ms/frame, total {1e3 / res.fps:.2f} ms/frame; "
          f"{third_rounds[0]} third rounds; K1 launches {k1_launches}, K2 "
          f"launches {k2_launches} (12 per frame: "
          f"{12 * res.num_frames}); K2 at {k2_ms:.4f} ms per launch is "
          f"{100 * 12 * k2_ms / det_ms:.1f}% of the detector's time")
    for _, boxes, scores in log:
        check(np.isfinite(boxes).all() and np.isfinite(scores).all(),
              "non-finite detections")
    profile_step(lambda: det.step(canvas, canvas, pre_hm), step_ms,
                 label=f"TransCenter {dtype} step")
    check(k2_launches == 12 * res.num_frames,
          f"K2 launched {k2_launches} times, not 12 per frame")
    check(k1_launches > 0, "the TransCenter loop never launched K1")
    check(third_rounds[0] >= 1, "no third round ran in the TransCenter loop")
    check(sum(n_tracks) > 0, "the TransCenter loop output no track")
    return k1_launches, k2_launches, det


def calibrate_yolox(det, frames):
    """The smoke's calibration of the random YOLOX (see YX_CLS_BIAS):
    returns the obj weights' gain and the obj bias it set."""
    import torch

    det.calibrate_random_weights(frames, 0.0, YX_CLS_BIAS, YX_BOX_HW)
    preds = det.model.head.obj_preds
    weights = [p.weight.detach().clone() for p in preds]

    def counts(gain, bias):
        with torch.no_grad():
            for p, w in zip(preds, weights):
                p.weight.copy_(w * gain)
                p.bias.fill_(bias)
        scores = det.detect(frames[0]).scores
        return (int((scores >= YX_TRACK_THRESH + 0.1).sum()),
                int((scores >= YX_CONF).sum()))

    for gain in YX_OBJ_GAINS:
        lo, hi = -100.0, 100.0  # the counts rise with the bias
        for _ in range(24):
            mid = (lo + hi) / 2
            if counts(gain, mid)[0] >= YX_FIRST_DETS:
                hi = mid
            else:
                lo = mid
        if counts(gain, hi)[1] <= YX_MAX_DETS:
            break
    return gain, hi


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


class SerialOnly:
    """Detector proxy hiding ``detect_async``: the loop runs serially."""

    def __init__(self, det):
        self.put_frame = det.put_frame
        self.detect = det.detect


def phase_yolox(device, engine):
    import numpy as np
    import torch

    from busca_tpu_torch.eval.detector import (
        YoloxDetector,
        normalize_canvas,
        track_frames_with_detector,
    )
    from busca_tpu_torch.eval.run import make_tracker
    from busca_tpu_torch.eval.synthetic import (
        SyntheticSequence,
        default_dropout_sequence,
    )
    from busca_tpu_torch.models.yolox import YoloxConfig, decode_outputs
    from busca_tpu_torch.ops.crop_cuda import crop_resize_cuda
    from busca_tpu_torch.trackers.base import Track

    cfg = YoloxConfig.size("x", num_classes=1)
    base = default_dropout_sequence(40)
    seq = SyntheticSequence(base.objects, num_frames=base.num_frames,
                            height=FRAME_HW[0], width=FRAME_HW[1],
                            seed=base.seed)
    frames = [seq.frame(t) for t in range(YX_FRAMES)]
    t0 = time.perf_counter()
    det = YoloxDetector(cfg, None, test_size=YX_TEST_SIZE,
                        conf_thresh=YX_CONF, device=device, seed=0)
    n_params = sum(p.numel() for p in det.model.parameters())
    torch.cuda.synchronize()
    print(f"YOLOX-X build (depth {cfg.depth}, width {cfg.width}, "
          f"{cfg.num_classes} class, {YX_TEST_SIZE[0]}x{YX_TEST_SIZE[1]}, "
          f"{n_params} parameters): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    gain, bias = calibrate_yolox(det, frames)
    torch.cuda.synchronize()
    print(f"YOLOX-X calibration on {len(frames)} frames: "
          f"{time.perf_counter() - t0:.2f} s; obj weights x{gain}, obj bias "
          f"{bias:.4f}, cls bias "
          f"{YX_CLS_BIAS}, boxes {YX_BOX_HW} canvas pixels")

    # the same model on the CPU, at a reduced test size, on a real canvas
    cpu_det = YoloxDetector(
        cfg, {k: v.cpu() for k, v in det.model.state_dict().items()},
        test_size=YX_CPU_SIZE, device="cpu")
    canvas_cpu, _ = cpu_det.prep(torch.as_tensor(frames[0]))
    x = normalize_canvas(canvas_cpu, cpu_det._mean, cpu_det._std).permute(
        2, 0, 1)[None]
    with torch.no_grad():
        want_raw = cpu_det.model(x, decode=False)
        got_raw = det.model(x.to(device), decode=False)
        want_rows = decode_outputs(want_raw, cfg.strides)
        got_rows = decode_outputs(got_raw, cfg.strides)
    torch.cuda.synchronize()
    pairs = [(f"level {lvl} {name}", g, w)
             for lvl, (gs, ws) in enumerate(zip(got_raw, want_raw))
             for name, g, w in zip(("reg", "obj", "cls"), gs, ws)]
    pairs.append(("decoded rows", got_rows, want_rows))
    for name, g, w in pairs:
        check(g.shape == w.shape, f"YOLOX {name} shape")
        check(bool(torch.isfinite(g).all()), f"YOLOX {name} non-finite")
        err = float(((g.cpu() - w).abs() / (1.0 + w.abs())).max())
        print(f"YOLOX-X card vs CPU at {YX_CPU_SIZE[0]}x{YX_CPU_SIZE[1]}, "
              f"{name} {tuple(g.shape)}: max |diff| / (1 + |want|) "
              f"{err:.3g} (tol {YX_TOL})")
        check(err <= YX_TOL, f"card and CPU disagree on YOLOX {name}: {err}")

    # the first frame's score spread, for the record
    det.conf_thresh = 0.0
    probe = det.detect(frames[0])
    det.conf_thresh = YX_CONF
    top = np.sort(probe.scores)[::-1]
    print(f"YOLOX first frame: {len(top)} detections after NMS at conf 0; "
          f"every 5th of the top 100 scores "
          f"{np.round(top[:100:5], 3).tolist()}; above "
          + ", ".join(f"{th}: {int((top > th).sum())}"
                      for th in (0.1, 0.3, 0.5, 0.6, 0.7, 0.8, 0.9)))

    # the enqueued step: no host sync, and back before the device is done
    det.detect(frames[1])  # warm: K1 built, letterbox box cached
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = det.detect_async(det.put_frame(frames[1]))
        returned_early = (handle.done is not None
                          and not handle.done.query())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    det.wait(handle)
    print(f"YOLOX detect_async under set_sync_debug_mode('error'): no host "
          f"sync; returned before its step ended: {returned_early}")
    check(returned_early, "detect_async waited for its step")

    # CMC off: the card host has no cv2
    kwargs = {"use_busca": True, "track_thresh": YX_TRACK_THRESH,
              "use_camera_motion_compensation": False}
    third_rounds = [0]
    assoc = engine.associate

    def counted(*a, **k):
        third_rounds[0] += 1
        return assoc(*a, **k)

    runs = {}
    engine.associate = counted
    try:
        for mode, d in (("pipelined", det), ("serial", SerialOnly(det))):
            third_rounds[0] = 0
            det.nms_fallbacks = 0
            log = []
            Track.reset_id_counter()
            tracker = make_tracker("byte", kwargs, engine, CROP_HW)
            crop_resize_cuda.launches = 0
            res = track_frames_with_detector(
                d, tracker, frames, name="synthetic-1080p", det_log=log)
            runs[mode] = (res, log, crop_resize_cuda.launches,
                          third_rounds[0], det.nms_fallbacks)
    finally:
        engine.associate = assoc
    for mode, (res, log, k1, rounds, fallbacks) in runs.items():
        n_dets = [len(s) for _, _, s in log]
        n_tracks = [len(r[2]) for r in res.results]
        det_ms = res.stage_times["detector_s"] * 1e3 / res.num_frames
        trk_ms = res.stage_times["tracker_s"] * 1e3 / res.num_frames
        print(f"YOLOX loop {mode} ({FRAME_HW[0]}x{FRAME_HW[1]}, "
              f"{res.num_frames} frames, conf {YX_CONF}, track_thresh "
              f"{YX_TRACK_THRESH}): detections per frame {n_dets}; "
              f"output tracks per frame {n_tracks}")
        print(f"YOLOX loop {mode}: detector {det_ms:.2f} ms/frame, tracker "
              f"{trk_ms:.2f} ms/frame, total {1e3 / res.fps:.2f} ms/frame; "
              f"{rounds} third rounds; K1 launches {k1}; NMS finished in "
              f"wait on {fallbacks} frames")
        for _, boxes, scores in log:
            check(np.isfinite(boxes).all() and np.isfinite(scores).all(),
                  "non-finite detections")
        check(rounds >= 1, f"no third round ran in the {mode} YOLOX loop")
        check(sum(n_tracks) > 0, f"the {mode} YOLOX loop output no track")
        check(k1 >= res.num_frames,
              f"{mode}: K1 launched {k1} times, under one per frame")
    piped, serial = runs["pipelined"][0], runs["serial"][0]
    for (fa, ta, ia, _), (fb, tb, ib, _) in zip(piped.results,
                                                serial.results):
        check(fa == fb and ia == ib, f"frame {fa}: pipelined and serial "
              "ids differ")
        check(np.array_equal(np.reshape(ta, (-1, 4)),
                             np.reshape(tb, (-1, 4))),
              f"frame {fa}: pipelined and serial boxes differ")
    print("YOLOX loop: pipelined and serial runs agree frame by frame")

    canvas, _ = det.prep(torch.as_tensor(frames[0]).to(device))
    step_ms = cuda_time_ms(lambda: det.step(canvas), reps=10, warmup=2)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    det.step(canvas)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    xin = normalize_canvas(canvas, det._mean, det._std).permute(2, 0, 1)[None]
    flops = conv_flops(det.model, xin)
    rate = flops / (step_ms * 1e-3)
    print(f"YOLOX-X step (normalize, forward, decode, postprocess) at "
          f"{YX_TEST_SIZE}: {step_ms:.2f} ms; {flops / 1e12:.4f} TFLOP of "
          f"float32 convolution, {rate / 1e12:.2f} TFLOP/s, "
          f"{100 * rate / FP32_FLOPS_PER_S:.1f}% of the 67 TFLOP/s float32 "
          f"peak (bound {flops / FP32_FLOPS_PER_S * 1e3:.2f} ms)")
    print(f"YOLOX-X step peak memory: {peak / 1e6:.1f} MB allocated, "
          f"{(peak - held) / 1e6:.1f} MB above the {held / 1e6:.1f} MB held "
          "before the step")
    profile_step(lambda: det.step(canvas), step_ms, label="YOLOX-X step")
    yolox_bf16_step(det, frames[0], canvas, xin, flops)
    return runs["pipelined"][2]


def yolox_rows_gap(cfg, state, xin):
    """The bf16 and float32 forwards of one YOLOX-X state on ``xin``:
    max |diff| / (1 + |want|) over the box and the score columns, and the
    bf16 rows."""
    import dataclasses

    import torch

    from busca_tpu_torch.models.yolox import YOLOX

    rows = {}
    for dtype in ("float32", "bfloat16"):
        model = YOLOX(dataclasses.replace(cfg, dtype=dtype)).to(xin.device)
        model.load_state_dict(state)
        with torch.no_grad():
            rows[dtype] = model.eval()(xin)[0]
        del model
    got, want = rows["bfloat16"], rows["float32"]
    check(got.dtype == torch.bfloat16, f"bf16 rows are {got.dtype}")
    check(bool(torch.isfinite(got).all()), "bf16 YOLOX rows non-finite")
    err = (got.float() - want).abs() / (1.0 + want.abs())
    return float(err[:, :4].max()), float(err[:, 4:].max()), got


def yolox_bf16_step(det, frame, canvas, xin, flops):
    """The bf16 YOLOX-X step (the detector's config in bf16, the same
    weights) on ``frame``'s ``canvas``: its decoded rows against the float32
    step's, its time, rate and profile, and ``frame`` detected through it.

    The calibrated random YOLOX-X is chaotic: its bf16 and float32 forwards
    disagree by O(1) (printed for the record).  The rows are held on the
    same weights with every backbone BatchNorm's variance times
    YX_BF16_DAMP, which takes each layer's gain below 1."""
    import dataclasses

    import numpy as np
    import torch

    from busca_tpu_torch.eval.detector import YoloxDetector

    state = det.model.state_dict()
    boxes, scores, _ = yolox_rows_gap(det.config, state, xin)
    print(f"YOLOX-X bf16 vs float32 decoded rows at {YX_TEST_SIZE}, the "
          f"calibrated weights: max |diff| / (1 + |want|) boxes {boxes:.4g}, "
          f"scores {scores:.4g} (not held: the random net is chaotic)")
    damped = {k: v * YX_BF16_DAMP if k.endswith("running_var")
              and not k.startswith("head.") else v for k, v in state.items()}
    boxes, scores, rows = yolox_rows_gap(det.config, damped, xin)
    print(f"YOLOX-X bf16 vs float32 decoded rows at {YX_TEST_SIZE} "
          f"({tuple(rows.shape)}), BN variances x{YX_BF16_DAMP}: max |diff| "
          f"/ (1 + |want|) boxes {boxes:.4g}, scores {scores:.4g} (tol "
          f"{YX_BF16_TOL})")
    check(max(boxes, scores) <= YX_BF16_TOL,
          f"bf16 YOLOX rows off by {max(boxes, scores)}")
    cfg = dataclasses.replace(det.config, dtype="bfloat16")
    det16 = YoloxDetector(cfg, state, test_size=YX_TEST_SIZE,
                          conf_thresh=YX_CONF, device=det.device)
    out = det16.detect(frame)
    check(np.isfinite(out.boxes_tlbr).all() and np.isfinite(out.scores).all(),
          "non-finite bf16 detections")
    step_ms = cuda_time_ms(lambda: det16.step(canvas), reps=10, warmup=2)
    rate = flops / (step_ms * 1e-3)
    print(f"YOLOX-X bf16 step at {YX_TEST_SIZE}: {step_ms:.2f} ms; "
          f"{flops / 1e12:.4f} TFLOP of convolution, {rate / 1e12:.2f} "
          f"TFLOP/s, {100 * rate / BF16_FLOPS_PER_S:.1f}% of the 989 "
          f"TFLOP/s bf16 peak (bound {flops / BF16_FLOPS_PER_S * 1e3:.2f} "
          f"ms); {len(out.scores)} detections on the frame")
    profile_step(lambda: det16.step(canvas), step_ms,
                 label="YOLOX-X bf16 step")


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch missing: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import busca_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2
    from busca_tpu_torch.utils.device import set_card_precision

    set_card_precision()  # TF32 off; bf16 products reduced in float32
    device = "cuda"
    try:
        phase_card()
        k1 = phase_k1(device)
        k1["letterbox"] = phase_k1_letterbox(device, LETTERBOX_HW,
                                             "TransCenter")
        k1["letterbox_yolox"] = phase_k1_letterbox(device, YX_LETTERBOX_HW,
                                                   "YOLOX")
        k1["pad_path"] = phase_k1_pad_path(device)
        k2 = phase_k2(device)
        engine, engine16 = phase_association(device)
        # BUSCA in bf16, the CLI's default, on the main paths
        k1_byte = phase_main_path(device, engine16)
        k1_tc, k2["launches"], tc32 = phase_transcenter(
            device, engine, k2["kernel_ms"])
        k1_tc16, k2["bf16"]["launches"], _ = phase_transcenter(
            device, engine16, k2["bf16"]["kernel_ms"], "bfloat16", tc32)
        del tc32
        k1_yolox = phase_yolox(device, engine16)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # launches: the canonical path (the pipelined YOLOX loop, BUSCA in
    # bf16); K1's count on each path is listed beside it; K2's are the
    # TransCenter loops', the only paths that run it: float32 at the top,
    # bf16 under "bf16"
    k1["launches"] = k1_yolox
    k1["launches_by_path"] = {"byte_synthetic": k1_byte,
                              "transcenter_loop": k1_tc,
                              "transcenter_bf16_loop": k1_tc16,
                              "yolox_loop": k1_yolox}
    print(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
