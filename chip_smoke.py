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
   that ``detect_async`` enqueues without a host sync and returns, behind a
   stream hold, before the device reaches its step; then the bf16 YOLOX-X step (the detector's bf16 config): its
   time and profile, and its decoded rows held against the float32 step's;
8. StrongSORT and GHOST with BUSCA in bf16 on a seeded crowd (96 objects
   at 1080x1920, 30 frames, dropouts and score dips): the full-width ReID
   extractor (ResNet-50, 384x128, 512-d, float32) with K1 held against its
   plain version at the first frame's boxes, 16 crops against the CPU, a
   300-crop batch against its 256 + 44 chunks run apart, and its time at
   the frame's batch; ``make_tracker`` + ``shim_for_runner`` through
   ``run_sequence``, base vs BUSCA, for StrongSORT and GHOST (ECC off: the
   card host has no cv2), DeepSORT base on 10 frames; K1's launches read
   around the StrongSORT and GHOST runs; AFLink (seeded random link model)
   and GSI over StrongSORT's rows cut at their gaps, on the card against
   the CPU; one device profile of a frame with a third round per tracker;
9. CenterTrack with BUSCA in bf16, and the SORT and MOTDT alternates: the
   full-width CenterTrack detector (DLA-34, 16 exact DCNv2 blocks,
   544x960, float32, seeded random weights with drawn offset/mask
   convolutions and a calibrated hm head) against the same model on the
   CPU at 128x224 on its four maps; the DCN offsets' range; the step's
   time, float32 operation count, peak memory, profile by kernel kind and
   the DCN blocks' share, and the step under ``sampling="windowed"`` and
   ``"local"``; ``track_frames_centertrack`` with ``CenterTrackAdapter`` +
   BUSCA over the dropout sequence at 1080x1920 for 20 frames, K1's
   launches and the third rounds counted; MOTDT with the ReID extractor on
   phase 8's crowd for 10 frames (K1 counted); SORT (host only) on the
   crowd's detections, its ms/frame and MOTA;
10. the tracking server (``busca_tpu_torch.serve.server.TrackingServer``)
   on a unix socket in a thread of this script, driven by
   ``TrackingClient``: ByteTrack + BUSCA (bf16) behind phase 7's YOLOX-X
   over 20 frames, TransCenter + BUSCA behind phase 6's float32 detector
   and CenterTrack + BUSCA behind phase 9's (through
   ``CenterTrackRunnerDetector``) over 10 frames each.  The served replies
   must equal the in-process serial loop's exactly (ids, tlwh, scores); a
   stream snapshotted with an HMAC key (after frame 10, resp. 5) and
   restored on a second server built with a fresh factory, over a new
   connection, its detector reset first, must equal the unbroken stream
   exactly, and a forged tag and an unsigned blob must be refused; round
   trip vs loop ms/frame, the server's own ms, the blob's bytes, snapshot
   and restore ms, K1's launches per served stream and K2's on
   TransCenter's;
11. TransCenter's exact deformable decoder: MSDA on the card against the
   CPU at the MOT17 pyramid (query 160x272, levels down to 20x34, C=256, 8
   heads, 9 points, seeded offsets that put some samples off every level);
   the full-width ``TransCenterConfig.for_dataset("mot17",
   sampling="deformable")`` detector with drawn offset and weight kernels:
   its maps against the CPU at 128x224, its step at 640x1088 in float32
   and bf16 (time, peak memory, device time by kind and MSDA's share, the
   bf16 maps against float32), and 6 frames of the TransCenter loop with
   BUSCA (K1 counted; K2 must not run);
12. the ``kernels`` JSON line, then the result line
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
# Phase 8's crowd: StrongSORT+BUSCA's dense-crowd configuration
# (BASELINE.json config 3) at a density the renderer draws.  96 objects of
# 40-80 x 100-200 px with distinct colours at 1080x1920 over 30 frames,
# detector noise 1 px; every third object has a 4-10 frame dropout from
# frame 8 on (once StrongSORT's n_init = 3 has confirmed it), every sixth
# (of the others) a score dip below min_confidence = 0.6.  The cuts: 30
# frames, random weights.
CROWD_OBJECTS, CROWD_FRAMES, CROWD_SEED = 96, 30, 8
FEAT_CPU_CROPS = 16  # the card-vs-CPU feature batch
FEAT_TOL = 1e-3  # ReID features, card vs CPU, float32 with TF32 off
CHUNK_CROPS, CHUNK_TOL = 300, 1e-5  # one batch vs its 256 + 44 chunks
DEEPSORT_FRAMES = 10
LINK_TOL = 1e-5  # AFLink probabilities, card vs CPU
# Phase 9: CenterTrack at its published DLA-34 width and 544x960 input,
# exact DCNv2, float32 (TF32 off), seeded random weights.  The published
# offset/mask convolutions start at zero, which would sample every DCN tap
# on the grid; the smoke draws them with CT_OFFSET_GAIN / sqrt(fan_in), so
# the taps move by fractions of a pixel and more.  The random hm head is
# rescaled (weights x CT_HM_GAIN) and its bias set so that the first
# frame's CT_FIRST_DETS-th peak scores CT_OUT_THRESH (10-30 detections per
# frame pass), the wh bias to CT_WH_BIAS output cells (7.5x19: 30x76 canvas
# pixels, 60x152 in the 1080p frame) with its and reg's weights x0.1.  As
# in phase 6, every detection is first-round (> CT_TRACK_THRESH) and starts
# a track, and a few flicker across the threshold each frame.
CT_TEST_SIZE = (544, 960)
CT_LETTERBOX_HW = (540, 960)  # 1080x1920 at exactly 1/2, top left of 544x960
CT_CPU_SIZE = (128, 224)  # every DLA level divides
# card vs CPU maps, max |diff| / (1 + |want|), float32 with TF32 off; the
# smoke also reads the gap with TF32 on, which this bound must catch
CT_MAP_TOL = 1e-5
CT_FRAMES = 20
CT_OFFSET_GAIN = 0.5
CT_HM_GAIN, CT_FIRST_DETS, CT_WH_BIAS = 3.0, 20, (7.5, 19.0)
CT_OUT_THRESH, CT_TRACK_THRESH = 0.6, 0.5
ALT_FRAMES = 10  # MOTDT with the extractor on the crowd's first frames
# Phase 10: the tracking server on a unix socket in a thread of this
# script.  The YOLOX-X stream (phase 7's detector) is snapshotted after
# frame SV_CUT of SV_FRAMES; TransCenter's (phase 6's float32 detector) and
# CenterTrack's (phase 9's) after SV_FEEDBACK_CUT of SV_FEEDBACK_FRAMES.
# Snapshots are signed with SV_KEY.
SV_FRAMES, SV_CUT = 20, 10
SV_FEEDBACK_FRAMES, SV_FEEDBACK_CUT = 10, 5
SV_KEY = b"chip-smoke-snapshot-key"
SV_CONNECT_S = 10.0  # the longest wait for a server's socket
# Phase 11: TransCenter's exact deformable decoder.  MSDA at the MOT17
# pyramid (K2's: query 160x272, levels down to 20x34, C=256, 8 heads) with
# MSDA_POINTS points per level, the offsets drawn with a std of
# MSDA_OFFSET_PX level pixels around each query's own pixel centre (some
# samples leave every level), card vs CPU within MSDA_TOL.  The full-width
# deformable model's offset and attention-weight kernels, zero in the
# published init, are drawn with std gain / sqrt(fan_in): the offsets then
# spread by about TC_DEFORM_OFFSET_GAIN level pixels and the weights'
# logits by about TC_DEFORM_WEIGHT_GAIN.  TC_DEFORM_FRAMES frames of the
# TransCenter loop run with the deformable detector.
MSDA_POINTS, MSDA_OFFSET_PX, MSDA_TOL = 9, 3.0, 1e-5
# the deformable model's maps, card vs CPU, max |diff|, float32 with TF32
# off; the smoke also reads the gap with TF32 on, which this bound must catch
TC_DEFORM_MAP_TOL = 1e-4
TC_DEFORM_OFFSET_GAIN, TC_DEFORM_WEIGHT_GAIN = 2.0, 1.0
TC_DEFORM_FRAMES = 6
# a stream hold lasts three times the host time it covers, and at least
# this long: a busy host's enqueue must not outrun it
HOLD_MIN_S = 0.25


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


def hold_stream(host_s):
    """Queue a sleep kernel that holds the current stream for three times
    ``host_s`` seconds of host work, and at least :data:`HOLD_MIN_S`, at up
    to 2e9 cycles/s: work the host queues behind it in that time cannot
    start before the host is done queueing."""
    import torch

    torch.cuda._sleep(int(max(3 * host_s, HOLD_MIN_S) * 2e9) + 1000)


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
    hold_stream(wall_s)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    held = not start.query()
    torch.cuda.synchronize()
    check(held, "the stream hold ended before the timed calls were queued")
    return start.elapsed_time(end) / reps


def device_kernels_ms(fn, reps=3, warmup=True):
    """Mean device ms per call of ``fn`` for each kernel name
    (torch.profiler's CUDA events): a step's device work without the host's
    dispatch gaps.  ``warmup=False`` profiles the first call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / reps)
    return by_name


def device_busy_ms(fn, reps=3):
    """Mean device time per call of ``fn`` summed over its kernels
    (:func:`device_kernels_ms`), for steps of more kernels than
    :func:`device_time_ms` can queue behind its hold."""
    return sum(device_kernels_ms(fn, reps).values())


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
    ``out_hw`` (612x1088 for TransCenter, 800x1422 for YOLOX, 540x960 for
    CenterTrack: an exact 1/2, every sample at a .5 fraction), quantized,
    not normalized."""
    frame, boxes_np, boxes, scratch, out = k1_case(
        device, 3, lambda rng, h, w: [[0.0, 0.0, float(w), float(h)]],
        out_hw)
    result = hold_k1(f"K1 at the {label} letterbox shape {FRAME_HW} -> "
                     f"{out_hw}", frame, boxes, scratch, out,
                     K1_MAIN_KW, timed=True)
    report_k1(f"{label} letterbox", result, FRAME_HW, boxes_np, out)
    return result


def canvas_crop_boxes(rng, h, w):
    """:func:`smoke_boxes` of a 1080x1920 frame at the scale of its
    ``h`` x ``w`` letterbox canvas, as BUSCA's boxes are on CenterTrack's
    canvas: the same mix inside, across the edges, outside and degenerate,
    some reaching the canvas's fill rows."""
    import numpy as np

    r = min(h / FRAME_HW[0], w / FRAME_HW[1])
    return (np.asarray(smoke_boxes(rng, N_BOXES, *FRAME_HW)) * r).tolist()


def phase_k1_canvas_crops(device):
    """K1 at CenterTrack's BUSCA crops: N_BOXES boxes -> CROP_HW from the
    uint8 544x960 canvas, exact against the plain version."""
    frame, boxes_np, boxes, scratch, out = k1_case(
        device, 5, canvas_crop_boxes, CROP_HW, frame_hw=CT_TEST_SIZE)
    result = hold_k1(f"K1 CenterTrack crops {CT_TEST_SIZE} -> {CROP_HW}, "
                     f"{len(boxes_np)} boxes", frame, boxes, scratch, out,
                     K1_MAIN_KW, timed=True)
    report_k1("CenterTrack canvas crops", result, CT_TEST_SIZE, boxes_np,
              out)
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
    ("gather (index_select)", ("index_select", "indexselect",
                               "index_elementwise", "gather")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "unrolled")),
)


def profile_step(step, step_ms, reps=3, label="detector step",
                 warmup=True, top=0):
    """Device time of ``reps`` calls of ``step`` by kernel kind
    (torch.profiler), and its idle share of ``step_ms``, the step's time
    measured without the profiler (whose own overhead stretches the
    profiled wall time).  ``warmup=False`` profiles the first call (a
    stateful step, such as a tracker's update, runs once); ``top`` prints
    that many kernels with the most device time.  Returns the device ms by
    kind."""
    by_kind = {}
    by_name = device_kernels_ms(step, reps, warmup)
    for name, ms in by_name.items():
        low = name.lower()
        kind = next((k for k, keys in KERNEL_KINDS
                     if any(key in low for key in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    busy = sum(by_kind.values())
    if not busy:
        print(f"{label} profile: the profiler recorded no device time "
              "(not measured)")
        return by_kind
    parts = ", ".join(f"{k} {v:.2f} ms ({100 * v / busy:.1f}%)"
                      for k, v in sorted(by_kind.items(),
                                         key=lambda kv: -kv[1]))
    print(f"{label} profile (mean of {reps}): device busy "
          f"{busy:.2f} ms of the {step_ms:.2f} ms step, idle "
          f"{100 * (1 - busy / step_ms):.1f}%; {parts}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"{label} profile: {ms:.3f} ms {name[:110]}")
    up = by_kind.get("upsample", 0.0)
    if up:
        print(f"{label} profile: upsample {up:.2f} ms "
              f"({100 * up / busy:.1f}% of the device time)")
    return by_kind


def check_against_cpu(det, device, label="TransCenter", tol=TC_MAP_TOL,
                      tf32_control=False):
    """The float32 detector's five maps against the same model on the CPU
    at TC_CPU_SIZE: max |diff| within ``tol``.  With ``tf32_control``, the
    gap once more with TF32 on (the card's default, which
    ``set_card_precision`` turns off), which must exceed ``tol``: the bound
    catches a TF32 leak."""
    import torch

    from busca_tpu_torch.models.transcenter import TransCenterDETR
    from busca_tpu_torch.utils.device import set_card_precision

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

    def gaps():
        with torch.no_grad():
            got = det.model(*(a.to(device) for a in args))
        torch.cuda.synchronize()
        out = {}
        for k in want:
            check(got[k].shape == want[k].shape, f"map {k} shape")
            check(bool(torch.isfinite(got[k]).all()), f"map {k} non-finite")
            out[k] = float((got[k].cpu() - want[k]).abs().max())
        return out

    for k, err in gaps().items():
        print(f"{label} card vs CPU at {h}x{w}, map {k} "
              f"{tuple(want[k].shape)}: max|diff| {err:.3g} (tol {tol})")
        check(err <= tol, f"card and CPU disagree on {k}: {err}")
    if not tf32_control:
        return
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = max(gaps().values())
    finally:
        set_card_precision()
    print(f"{label} card vs CPU with TF32 on: max|diff| {tf32:.3g} over the "
          f"five maps (tol {tol})")
    check(tf32 > tol, f"TF32's gap {tf32} is within {tol}")


def check_against_float32(det, ref, frame, label="TransCenter"):
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
        print(f"{label} bf16 vs float32 on the card at {TC_TEST_SIZE}, "
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

    # the enqueued step: no host sync, and back before the device reaches
    # it.  The stream is held behind a sleep kernel, so that a host that
    # queues slower than the card runs cannot end the step before the check.
    t0 = time.perf_counter()
    det.detect(frames[1])  # warm: K1 built, letterbox box cached
    torch.cuda.synchronize()
    detect_s = time.perf_counter() - t0
    hold_stream(detect_s)
    held = torch.cuda.Event()
    held.record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        handle = det.detect_async(det.put_frame(frames[1]))
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        returned_early = (not held.query() and handle.done is not None
                          and not handle.done.query())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    det.wait(handle)
    print(f"YOLOX detect_async under set_sync_debug_mode('error'): no host "
          f"sync; queued in {enqueue_ms:.2f} ms behind a stream hold of "
          f"{max(3 * detect_s, HOLD_MIN_S) * 1e3:.1f} ms (a synchronized "
          f"detect(): {detect_s * 1e3:.2f} ms); returned before the device "
          f"reached its step: {returned_early}")
    check(returned_early, "detect_async waited for the device")

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
    return runs["pipelined"][2], det


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


def crowd_sequence():
    """Phase 8's seeded crowd (see CROWD_OBJECTS)."""
    import numpy as np

    from busca_tpu_torch.eval.synthetic import (
        SyntheticObject,
        SyntheticSequence,
    )

    rng = np.random.RandomState(CROWD_SEED)
    h, w = FRAME_HW
    n = CROWD_FRAMES
    objs = []
    while len(objs) < CROWD_OBJECTS:
        color = rng.randint(30, 226, 3).astype(np.float64)
        if any(np.abs(color - o.color).sum() < 40 for o in objs):
            continue  # distinct colours
        bw, bh = rng.uniform(40, 80), rng.uniform(100, 200)
        vx, vy = rng.uniform(-2, 2), rng.uniform(-1, 1)
        # the whole trajectory stays in the frame
        x0 = rng.uniform(max(0.0, -vx * n), w - bw - max(0.0, vx * n))
        y0 = rng.uniform(max(0.0, -vy * n), h - bh - max(0.0, vy * n))
        kw = {}
        if len(objs) % 3 == 0:
            start = int(rng.randint(8, n - 5))
            kw["dropout"] = (start, start + int(rng.randint(4, 11)))
        elif len(objs) % 6 == 1:
            start = int(rng.randint(3, n - 5))
            kw["score_dip"] = (start, start + int(rng.randint(4, 11)))
            kw["dip_score"] = float(rng.uniform(0.3, 0.5))
        objs.append(SyntheticObject(color=color, x0=x0, y0=y0, vx=vx, vy=vy,
                                    w=bw, h=bh, **kw))
    return SyntheticSequence(objs, num_frames=n, height=h, width=w,
                             det_noise=1.0, seed=CROWD_SEED)


def reid_flops(model, x):
    """float32 operations of one ReID forward on ``x``: its convolutions
    (:func:`conv_flops`) and the two linears (2048 -> 512 -> classes)."""
    linear = sum(2 * m.in_features * m.out_features
                 for m in (model.red, model.fc) if m is not None)
    return conv_flops(model, x) + linear * x.shape[0]


def phase_extractor(device, ext, frames, dets):
    """The full-width ReID extractor on the card: K1 at the crowd's first
    frame against its plain version, 16 crops against the CPU, a 300-crop
    batch against its two 256-crop chunks run apart, and the network's time
    at the frame's batch.  Returns that time in ms."""
    import numpy as np
    import torch

    from busca_tpu_torch.eval.features import ReidFeatureExtractor
    from busca_tpu_torch.ops import crop_cuda
    from busca_tpu_torch.trackers.base import device_crops

    frame = torch.as_tensor(frames[0]).to(device)
    boxes_np = np.asarray(dets[0][0], np.float32)
    boxes = torch.from_numpy(boxes_np).to(device)
    out, scratch = crop_cuda.buffers(len(boxes_np), CROP_HW, device)
    hold_k1(f"K1 at the crowd's first frame ({len(boxes_np)} boxes, "
            f"{FRAME_HW} -> {CROP_HW})", frame, boxes, scratch, out,
            K1_MAIN_KW, timed=False)
    crops = device_crops(frame, boxes_np, CROP_HW, device)

    cpu = ReidFeatureExtractor(
        {k: v.cpu() for k, v in ext.model.state_dict().items()},
        device="cpu")
    sub = crops[:FEAT_CPU_CROPS]
    t0 = time.perf_counter()
    want = cpu(sub.cpu())
    cpu_s = time.perf_counter() - t0
    got = ext(sub)
    err = float(np.abs(got - want).max())
    norm = float(np.abs(np.linalg.norm(got, axis=1) - 1).max())
    print(f"ReID extractor card vs CPU ({FEAT_CPU_CROPS} crops as one "
          f"batch, the CPU pass {cpu_s:.2f} s): max|diff| {err:.3g} (tol "
          f"{FEAT_TOL}); | |f| - 1 | <= {norm:.2g}")
    check(got.shape == (FEAT_CPU_CROPS, ext.feature_dim)
          and np.isfinite(got).all(), "non-finite or misshapen features")
    check(err <= FEAT_TOL, f"ReID features card vs CPU: {err}")

    pool = torch.cat([device_crops(frames[t], dets[t][0], CROP_HW, device)
                      for t in range(4)])[:CHUNK_CROPS]
    check(len(pool) == CHUNK_CROPS, f"only {len(pool)} crops for the "
          "chunk check")
    step = ext.buckets[-1]
    whole = ext.features(pool)
    apart = torch.cat([ext.features(pool[:step]), ext.features(pool[step:])])
    err = float((whole - apart).abs().max())
    print(f"ReID extractor: {CHUNK_CROPS} crops in one call vs its first "
          f"{step} and last {CHUNK_CROPS - step} run apart: max|diff| "
          f"{err:.3g} (tol {CHUNK_TOL})")
    check(err <= CHUNK_TOL, f"the chunk boundary moved: {err}")

    ms = cuda_time_ms(lambda: ext.features(crops), reps=10, warmup=2)
    x = ((crops / ext._255 - ext._mean) / ext._std).flip(-1)
    flops = reid_flops(ext.model, x)
    print(f"ReID ResNet-50 at the frame's batch ({len(crops)} crops "
          f"{CROP_HW}, float32, TF32 off): {ms:.3f} ms per call, "
          f"{flops / 1e9:.1f} GFLOP, {flops / ms / 1e9:.2f} TFLOP/s = "
          f"{100 * flops / (ms * 1e-3) / FP32_FLOPS_PER_S:.1f}% of the "
          "67 TFLOP/s float32 peak")
    return ms


class Counted:
    """Counts the calls of one method of an object (an engine's
    ``associate``, a tracker's ``_kalman_candidates``) while installed."""

    def __init__(self, obj, method):
        self.obj, self.method, self.calls = obj, method, 0
        self.orig = getattr(obj, method)

        def counted(*a, **k):
            self.calls += 1
            return self.orig(*a, **k)

        setattr(obj, method, counted)

    def remove(self):
        delattr(self.obj, self.method)


def run_feature_tracker(label, name, engine, ext, frames, dets, gt,
                        kwargs):
    """One run of ``make_tracker(name)`` + ``shim_for_runner`` with the
    extractor through ``run_sequence``: metrics, ms/frame, the extractor's
    share, detections per frame, third rounds.  Returns ``(result,
    stats)``; ``stats`` has each frame's seconds and whether it ran a third
    round."""
    import numpy as np
    import torch

    from busca_tpu_torch.eval.metrics import evaluate_hota
    from busca_tpu_torch.eval.run import make_tracker, shim_for_runner
    from busca_tpu_torch.eval.runner import (
        evaluate_sequence,
        results_to_pred,
        run_sequence,
    )

    tracker = make_tracker(name, dict(kwargs), engine, CROP_HW, ext)
    shim = shim_for_runner(name, tracker, ext, CROP_HW)
    stats = {"frame_s": [], "third": [], "ext_s": 0.0}
    feats = ext.features

    def timed_features(crops):
        t0 = time.perf_counter()
        out = feats(crops)
        torch.cuda.synchronize()
        stats["ext_s"] += time.perf_counter() - t0
        return out

    ext.features = timed_features
    rounds = Counted(engine, "associate") if engine is not None else None
    kalman = (Counted(tracker, "_kalman_candidates") if name == "ghost"
              else None)
    update = shim.update

    def timed_update(*a):
        r0 = rounds.calls if rounds else 0
        t0 = time.perf_counter()
        out = update(*a)
        stats["frame_s"].append(time.perf_counter() - t0)
        stats["third"].append(bool(rounds) and rounds.calls > r0)
        return out

    shim.update = timed_update
    try:
        res = run_sequence(shim, frames, dets, name=label)
    finally:
        del ext.features
        for c in (rounds, kalman):
            if c is not None:
                c.remove()
    m = evaluate_sequence(res, gt)
    h = evaluate_hota(gt, results_to_pred(res))
    ms = 1e3 * sum(stats["frame_s"]) / res.num_frames
    stats["third_rounds"] = rounds.calls if rounds else 0
    stats["kalman_feature_calls"] = kalman.calls if kalman else 0
    n_dets = np.mean([len(b) for b, _ in dets])
    print(f"{label}: MOTA {m.mota:.4f} IDF1 {m.idf1:.4f} HOTA "
          f"{h['hota']:.4f} IDs {m.num_switches} FP {m.num_false_positives} "
          f"FN {m.num_misses}; {ms:.2f} ms/frame over {res.num_frames} "
          f"frames, the extractor {100 * stats['ext_s'] / sum(stats['frame_s']):.1f}% "
          f"of it; {n_dets:.1f} detections per frame; "
          f"{stats['third_rounds']} third rounds")
    check(all(np.isfinite(v) for v in (m.mota, m.idf1, h["hota"])),
          f"{label}: non-finite metrics")
    return res, stats


def result_rows(res):
    """A SequenceResult as MOT rows [frame, id, x, y, w, h, score, -1, -1,
    -1]."""
    import numpy as np

    rows = [[f, tid, *tlwh, conf, -1, -1, -1]
            for f, tlwhs, ids, confs in res.results
            for tlwh, tid, conf in zip(tlwhs, ids, confs)]
    return np.asarray(rows, np.float64).reshape(-1, 10)


def cut_at_gaps(rows):
    """Each track cut into tracklets at its gaps (a new id after every
    missing frame), as a tracker that does not coast would emit them."""
    import numpy as np

    out = rows.copy()
    next_id = int(rows[:, 1].max()) + 1 if len(rows) else 1
    for tid in np.unique(rows[:, 1]):
        idx = np.where(rows[:, 1] == tid)[0]
        idx = idx[np.argsort(rows[idx, 0])]
        new = tid
        for a, b in zip(idx[:-1], idx[1:]):
            if rows[b, 0] - rows[a, 0] > 1:
                new, next_id = next_id, next_id + 1
            out[b, 1] = new
    return out


def phase_link_and_smooth(device, rows):
    """AFLink (seeded random link model) and GSI over StrongSORT's rows cut
    at their gaps, on the card and on the CPU: the probabilities within
    LINK_TOL, the links and the linked and smoothed rows equal but where
    two probabilities (or one and thrP) lie within LINK_TOL."""
    import copy

    import numpy as np
    import torch

    from busca_tpu_torch.models.aflink import AFLinkModel
    from busca_tpu_torch.models.busca import seeded_init
    from busca_tpu_torch.trackers import postprocess as pp

    thr_p = 0.05
    rows = cut_at_gaps(rows)
    cpu = seeded_init(AFLinkModel(), torch.Generator().manual_seed(3)).eval()
    card = copy.deepcopy(cpu).to(device)
    tracks = pp._split_tracks(rows)
    cands = pp.link_candidates(tracks)
    check(len(cands) > 0, "no AFLink candidate pair")
    t0 = time.perf_counter()
    p_card = pp.candidate_probs(tracks, cands, card)
    card_ms = (time.perf_counter() - t0) * 1e3
    p_cpu = pp.candidate_probs(tracks, cands, cpu)
    err = float(np.abs(p_card - p_cpu).max())
    order = np.argsort(p_cpu)
    tied = set()
    for a, b in zip(order[:-1], order[1:]):
        if p_cpu[b] - p_cpu[a] <= LINK_TOL:
            tied |= {a, b}
    tied |= set(np.where(np.abs(p_cpu - thr_p) <= LINK_TOL)[0].tolist())
    links_card = pp.greedy_links(cands, p_card, thr_p)
    links_cpu = pp.greedy_links(cands, p_cpu, thr_p)
    tied_pairs = {cands[k] for k in tied}
    print(f"AFLink over StrongSORT's rows cut at their gaps: "
          f"{len(tracks)} tracklets, {len(cands)} candidate pairs, "
          f"{len(links_cpu)} links; card vs CPU probabilities max|diff| "
          f"{err:.3g} (tol {LINK_TOL}); {len(tied)} candidates within "
          f"{LINK_TOL} of another or of thrP; the card's scoring call "
          f"{card_ms:.2f} ms")
    check(err <= LINK_TOL, f"AFLink probabilities card vs CPU: {err}")
    check(set(links_card) - tied_pairs == set(links_cpu) - tied_pairs,
          "AFLink links differ between the card and the CPU")
    linked = pp.aflink(rows, model=card)
    smoothed = pp.gaussian_smoothed_interpolation(linked)
    if not tied:
        want = pp.merge_links(rows, links_cpu)
        check(np.array_equal(linked, want)
              and np.array_equal(smoothed,
                                 pp.gaussian_smoothed_interpolation(want)),
              "linked or smoothed rows differ between the card and the CPU")
    check(np.isfinite(smoothed).all(), "non-finite smoothed rows")
    print(f"AFLink + GSI: {len(rows)} rows, {len(np.unique(rows[:, 1]))} "
          f"ids -> linked {len(np.unique(linked[:, 1]))} ids -> GSI "
          f"{len(smoothed)} rows; card rows equal the CPU's"
          + ("" if not tied else " (compared on the untied links only)"))


def profile_third_round_frame(label, name, engine, ext, frames, dets, stats,
                              kwargs):
    """Replay the run up to its first frame with a third round, and profile
    that frame's update by kernel kind, with the device's idle share over
    the frame's wall time in the measured run."""
    from busca_tpu_torch.eval.run import make_tracker, shim_for_runner

    k = stats["third"].index(True)
    tracker = make_tracker(name, dict(kwargs), engine, CROP_HW, ext)
    shim = shim_for_runner(name, tracker, ext, CROP_HW)
    for t in range(k):
        shim.update(dets[t][0], dets[t][1], 1.0, frames[t])
    rounds = Counted(engine, "associate")
    try:
        profile_step(lambda: shim.update(dets[k][0], dets[k][1], 1.0,
                                         frames[k]),
                     stats["frame_s"][k] * 1e3, reps=1, warmup=False,
                     label=f"{label} frame {k + 1} (a third round)")
    finally:
        rounds.remove()
    check(rounds.calls >= 1, f"{label}: the profiled frame ran no third "
          "round")


def phase_feature_trackers(device, engine):
    """Phase 8: StrongSORT and GHOST with BUSCA, and DeepSORT, on the crowd,
    with the full-width ReID extractor; AFLink and GSI over StrongSORT's
    rows.  Returns K1's launches on the StrongSORT and GHOST loops, and the
    extractor with the crowd's frames, detections and gt for phase 9."""
    from busca_tpu_torch.eval.features import ReidFeatureExtractor
    from busca_tpu_torch.ops.crop_cuda import crop_resize_cuda

    t_phase = t0 = time.perf_counter()
    seq = crowd_sequence()
    frames = [seq.frame(t) for t in range(seq.num_frames)]
    dets = [seq.detections(t) for t in range(seq.num_frames)]
    gt = seq.ground_truth()
    n_drop = sum(o.dropout[1] > o.dropout[0] for o in seq.objects)
    n_dip = sum(o.score_dip[1] > o.score_dip[0] for o in seq.objects)
    print(f"crowd: {len(seq.objects)} objects at {FRAME_HW[0]}x"
          f"{FRAME_HW[1]}, {seq.num_frames} frames, {n_drop} dropouts, "
          f"{n_dip} score dips; rendered in "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    ext = ReidFeatureExtractor(device=device, seed=0)
    n_params = sum(p.numel() for p in ext.model.parameters())
    print(f"ReID extractor build (ResNet-50 (3, 4, 6, 3), {CROP_HW}, "
          f"{ext.feature_dim}-d, {n_params} parameters): "
          f"{time.perf_counter() - t0:.2f} s")
    phase_extractor(device, ext, frames, dets)

    busca = {"use_busca": True}
    # StrongSORT: base vs BUSCA, K1's launches counted over both
    crop_resize_cuda.launches = 0
    ss_base, _ = run_feature_tracker("StrongSORT base", "strongsort", None,
                                     ext, frames, dets, gt, {})
    _, ss_stats = run_feature_tracker(
        f"StrongSORT + BUSCA ({engine.config.dtype})", "strongsort", engine,
        ext, frames, dets, gt, busca)
    k1_ss = crop_resize_cuda.launches
    print(f"StrongSORT loop: K1 launches {k1_ss}")
    check(ss_stats["third_rounds"] >= 1, "StrongSORT ran no third round")
    check(k1_ss > 0, "the StrongSORT loop never launched K1")

    n = DEEPSORT_FRAMES
    run_feature_tracker(f"DeepSORT base (first {n} frames)", "deepsort",
                        None, ext, frames[:n], dets[:n],
                        {f: gt[f] for f in range(1, n + 1)}, {})

    # GHOST: base vs BUSCA; the card host has no cv2, so GHOST's ECC is set
    # off explicitly rather than left to fall back to an identity warp
    ecc_off = {"motion_compensation": False}
    crop_resize_cuda.launches = 0
    run_feature_tracker("GHOST base", "ghost", None, ext, frames, dets, gt,
                        ecc_off)
    _, gh_stats = run_feature_tracker(
        f"GHOST + BUSCA ({engine.config.dtype})", "ghost", engine, ext,
        frames, dets, gt, dict(busca, **ecc_off))
    k1_gh = crop_resize_cuda.launches
    print(f"GHOST loop: K1 launches {k1_gh}; the extractor ran on Kalman "
          f"candidates in {gh_stats['kalman_feature_calls']} frames")
    check(gh_stats["third_rounds"] >= 1, "GHOST ran no third round")
    check(gh_stats["kalman_feature_calls"] >= 1,
          "GHOST never computed Kalman-candidate features")
    check(k1_gh > 0, "the GHOST loop never launched K1")

    phase_link_and_smooth(device, result_rows(ss_base))
    profile_third_round_frame("StrongSORT + BUSCA", "strongsort", engine,
                              ext, frames, dets, ss_stats, busca)
    profile_third_round_frame("GHOST + BUSCA", "ghost", engine, ext, frames,
                              dets, gh_stats, dict(busca, **ecc_off))
    print(f"phase 8: {time.perf_counter() - t_phase:.2f} s")
    return k1_ss, k1_gh, (ext, frames, dets, gt)


def ct_flops(model, args):
    """float32 operations of one CenterTrack forward on ``args``: its
    convolutions (:func:`conv_flops`'s count: the offset/mask convolutions
    and the heads too), the DCN contractions (2 * 9 * Cin * Cout per output
    pixel) and the grouped upsamples (2 * k^2 per input element).  Returns
    ``(total, dcn)``."""
    import torch

    from busca_tpu_torch.models.centertrack import DCN, UpConv

    counts = {"conv": 0, "dcn": 0, "up": 0}

    def conv(mod, _inp, out):
        k = mod.kernel_size[0] * mod.kernel_size[1]
        counts["conv"] += (2 * mod.in_channels // mod.groups * k
                           * out.shape[1] * out.shape[2] * out.shape[3])

    def dcn(mod, inp, out):
        counts["dcn"] += (2 * 9 * inp[0].shape[1] * out.shape[1]
                          * out.shape[2] * out.shape[3])

    def up(mod, inp, _out):
        counts["up"] += 2 * mod.kernel_size[0] ** 2 * inp[0].numel()

    hooks = []
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            hooks.append(m.register_forward_hook(conv))
        elif isinstance(m, DCN):
            hooks.append(m.register_forward_hook(dcn))
        elif isinstance(m, UpConv):
            hooks.append(m.register_forward_hook(up))
    with torch.no_grad():
        model(*args)
    for h in hooks:
        h.remove()
    return sum(counts.values()), counts["dcn"]


def ct_random_weights(det, frame):
    """The smoke's CenterTrack weights (see CT_OFFSET_GAIN): drawn offset/
    mask convolutions, the hm head rescaled and its bias calibrated on
    ``frame`` so that CT_FIRST_DETS peaks pass CT_OUT_THRESH, the box heads
    damped.  Returns the calibrated hm bias."""
    import numpy as np
    import torch

    from busca_tpu_torch.eval.detector import normalize_canvas
    from busca_tpu_torch.models.centertrack import DCN

    model = det.model
    g = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DCN):
                w = m.conv_offset_mask.weight
                fan_in = w[0].numel()
                w.copy_((torch.randn(w.shape, generator=g) * CT_OFFSET_GAIN
                         / float(np.sqrt(fan_in))).to(w.device))
        model.hm[2].weight.mul_(CT_HM_GAIN)
        for head in (model.wh, model.reg):
            head[2].weight.mul_(0.1)
        model.wh[2].bias.copy_(torch.tensor(CT_WH_BIAS))
        model.hm[2].bias.zero_()
        canvas, _ = det.prep(torch.as_tensor(frame).to(det.device))
        x = normalize_canvas(canvas, det._mean, det._std,
                             to_rgb=False).permute(2, 0, 1)[None]
        hm = model(x, x, torch.zeros_like(x[:, :1]))["hm"][0, 0].float()
        # the decode's peaks: 3x3 local maxima, best first
        peak = torch.nn.functional.max_pool2d(hm[None, None], 3, 1, 1)[0, 0]
        logits = torch.sort(hm[peak == hm], descending=True)[0]
        target = float(np.log(CT_OUT_THRESH / (1 - CT_OUT_THRESH)))
        bias = target - float(logits[CT_FIRST_DETS - 1])
        model.hm[2].bias.fill_(bias)
    return bias


def ct_offsets_report(det, canvas, pre_hm):
    """One forward with hooks on every DCN block's offset/mask convolution:
    the offsets' range, the share of fractional ones, the share of sampled
    taps outside the map, the masks' range."""
    import torch

    from busca_tpu_torch.models.centertrack import DCN

    stats = []

    def hook(mod, inp, out):
        x = inp[0]
        h, w = x.shape[2], x.shape[3]
        off = out[:, :18].float()
        dy, dx = off[:, 0::2], off[:, 1::2]
        ky = torch.arange(3, device=x.device).repeat_interleave(3) - 1
        kx = torch.arange(3, device=x.device).repeat(3) - 1
        gy = torch.arange(h, device=x.device).view(1, 1, h, 1) + \
            ky.view(1, 9, 1, 1)
        gx = torch.arange(w, device=x.device).view(1, 1, 1, w) + \
            kx.view(1, 9, 1, 1)
        sy, sx = gy + dy, gx + dx
        outside = (sy <= -1) | (sy >= h) | (sx <= -1) | (sx >= w)
        frac = off - off.floor()
        stats.append((float(off.min()), float(off.max()),
                      float(((frac > 0.01) & (frac < 0.99)).float().mean()),
                      float(outside.float().mean()),
                      float(torch.sigmoid(out[:, 18:].float()).min()),
                      float(torch.sigmoid(out[:, 18:].float()).max())))

    hooks = [m.conv_offset_mask.register_forward_hook(hook)
             for m in det.model.modules() if isinstance(m, DCN)]
    det.step(canvas, canvas, pre_hm)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    lo = min(s[0] for s in stats)
    hi = max(s[1] for s in stats)
    frac = sum(s[2] for s in stats) / len(stats)
    out = max(s[3] for s in stats)
    print(f"CenterTrack DCN offsets over the {len(stats)} blocks: range "
          f"[{lo:.3f}, {hi:.3f}] px, fractional {100 * frac:.1f}% on "
          f"average; taps wholly outside the map up to {100 * out:.2f}% "
          f"of a block's; masks in [{min(s[4] for s in stats):.3f}, "
          f"{max(s[5] for s in stats):.3f}]")
    check(len(stats) == 16, f"{len(stats)} DCN blocks, not 16")
    check(hi - lo > 1.0 and frac > 0.5, "the DCN offsets barely move")
    check(out > 0, "no DCN tap left the map")


def ct_check_against_cpu(det, device):
    """The float32 model's four maps against the same model on the CPU at
    CT_CPU_SIZE: max |diff| / (1 + |want|) within CT_MAP_TOL.  Then the gap
    once more with TF32 on (the card's default, which
    ``set_card_precision`` turns off), which must exceed CT_MAP_TOL: the
    bound catches a TF32 leak."""
    import torch

    from busca_tpu_torch.models.centertrack import CenterTrackNet
    from busca_tpu_torch.utils.device import set_card_precision

    cpu = CenterTrackNet(det.config)
    cpu.load_state_dict({k: v.cpu() for k, v in
                         det.model.state_dict().items()})
    cpu.eval()
    g = torch.Generator().manual_seed(10)
    h, w = CT_CPU_SIZE
    args = (torch.randn((1, 3, h, w), generator=g),
            torch.randn((1, 3, h, w), generator=g),
            torch.rand((1, 1, h, w), generator=g))
    with torch.no_grad():
        want = cpu(*args)

    def gaps():
        with torch.no_grad():
            got = det.model(*(a.to(device) for a in args))
        torch.cuda.synchronize()
        out = {}
        for k in want:
            check(got[k].shape == want[k].shape, f"map {k} shape")
            check(bool(torch.isfinite(got[k]).all()), f"map {k} non-finite")
            diff = (got[k].cpu() - want[k]).abs()
            out[k] = (float(diff.max()),
                      float((diff / (1.0 + want[k].abs())).max()))
        return out

    for k, (diff, err) in gaps().items():
        print(f"CenterTrack card vs CPU at {h}x{w}, map {k}: max|diff| "
              f"{diff:.3g}, / (1 + |want|) {err:.3g} (tol {CT_MAP_TOL}); "
              f"max|want| {float(want[k].abs().max()):.3g}")
        check(err <= CT_MAP_TOL, f"card and CPU disagree on {k}: {err}")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = max(err for _, err in gaps().values())
    finally:
        set_card_precision()
    print(f"CenterTrack card vs CPU with TF32 on: / (1 + |want|) {tf32:.3g} "
          f"over the four maps (tol {CT_MAP_TOL})")
    check(tf32 > CT_MAP_TOL, f"TF32's gap {tf32} is within CT_MAP_TOL")


def ct_dcn_times(det, canvas, pre_hm, step_dev):
    """Device times (:func:`device_busy_ms`: the host's dispatch, which
    swings with the shared host, taken out) of the step's 16 DCN blocks on
    their captured inputs, beside ``step_dev``, the step's own (from
    :func:`profile_step`): the blocks whole (offset/mask convolution,
    gathers and contraction) and the gathers plus contractions alone
    (``deform_conv2d`` on the blocks' offsets and masks)."""
    import torch

    from busca_tpu_torch.models.centertrack import DCN
    from busca_tpu_torch.ops.deform import deform_conv2d

    calls = []

    def hook(mod, inp, _out):
        x = inp[0]
        with torch.no_grad():
            om = mod.conv_offset_mask(x)
        calls.append((mod, x, om[:, :18], torch.sigmoid(om[:, 18:])))

    hooks = [m.register_forward_hook(hook) for m in det.model.modules()
             if isinstance(m, DCN)]
    det.step(canvas, canvas, pre_hm)
    for h in hooks:
        h.remove()

    def blocks():
        with torch.no_grad():
            for mod, x, _, _ in calls:
                mod(x)

    def gathers():
        with torch.no_grad():
            for mod, x, off, mask in calls:
                deform_conv2d(x, off, mod.weight, mask, mod.bias)

    block_ms = device_busy_ms(blocks)
    gather_ms = device_busy_ms(gathers)
    if not step_dev:
        print("CenterTrack DCN share: the profiler recorded no device time "
              "(not measured)")
        return
    print(f"CenterTrack step on the device alone: {step_dev:.2f} ms; the 16 "
          f"DCN blocks {block_ms:.2f} ms ({100 * block_ms / step_dev:.1f}%), "
          f"of which gathers + contractions {gather_ms:.2f} ms "
          f"({100 * gather_ms / step_dev:.1f}%)")


def ct_sampling_steps(det, canvas, pre_hm, step_dev):
    """The same weights under ``sampling="windowed"`` and ``"local"``: the
    step's time back to back and on the device alone, and its maps' max
    |diff| to the exact DCN's."""
    import dataclasses

    import torch

    from busca_tpu_torch.models.centertrack import CenterTrackNet

    def maps(model):
        x = torch.zeros((1, 3) + CT_TEST_SIZE, device=det.device)
        with torch.no_grad():
            return model(canvas.permute(2, 0, 1)[None].float() / 255.0, x,
                         pre_hm.permute(2, 0, 1)[None])

    ref = maps(det.model)
    exact = det.model
    for sampling in ("windowed", "local"):
        model = CenterTrackNet(dataclasses.replace(det.config,
                                                   sampling=sampling))
        model.load_state_dict(exact.state_dict())
        det.model = model.to(det.device).eval()
        try:
            ms = cuda_time_ms(lambda: det.step(canvas, canvas, pre_hm),
                              reps=3, warmup=1)
            dev = device_busy_ms(lambda: det.step(canvas, canvas, pre_hm),
                                 reps=1)
            got = maps(det.model)
        finally:
            det.model = exact
        gap = max(float((got[k] - ref[k]).abs().max()) for k in ref)
        print(f"CenterTrack step with sampling={sampling!r}: {ms:.2f} ms "
              f"back to back, {dev:.2f} ms on the device alone (exact DCN "
              f"{step_dev:.2f}); maps' max |diff| to the exact DCN's "
              f"{gap:.3g}")
        del model


def ct_detect_stages(det, tracker, frames, det_ms):
    """A second run of the loop with ``det.detect``'s stages each timed on
    the host's clock up to a synchronize: first the device work the
    tracker left queued (the sync-free loop waits for it in the frame's
    upload), then the frame's upload, the letterbox (K1), the prior
    heatmap's render on the host and its upload, the device step, and the
    one readback with the dicts.  Printed in ms/frame beside ``det_ms``,
    the sync-free loop's detector time."""
    import numpy as np
    import torch

    from busca_tpu_torch.eval.detector import track_frames_centertrack
    from busca_tpu_torch.trackers.base import Track

    parts = dict.fromkeys(("the tracker's queued device work",
                           "frame upload", "letterbox (K1)",
                           "pre_hm render (host)", "pre_hm upload", "step",
                           "readback + dicts"), 0.0)

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts[key] += time.perf_counter() - t0
        return out

    def staged_detect(frame_bgr, tracks=None):  # detect(), stage by stage
        timed("the tracker's queued device work", lambda: None)
        frame = timed("frame upload", lambda: torch.as_tensor(
            np.asarray(frame_bgr)).to(det.device))
        canvas, r = timed("letterbox (K1)", lambda: det.prep(frame))
        if det._pre_canvas is None:
            det._pre_canvas = canvas
        hm = timed("pre_hm render (host)",
                   lambda: det._render_pre_hm(tracks, r))
        pre_hm = timed("pre_hm upload",
                       lambda: torch.from_numpy(hm).to(det.device))
        decoded = timed("step", lambda: det.step(canvas, det._pre_canvas,
                                                 pre_hm))
        det._pre_canvas = canvas
        return timed("readback + dicts",
                     lambda: det.results(decoded, r)), canvas, r

    det.detect = staged_detect
    det.reset()
    Track.reset_id_counter()
    try:
        res = track_frames_centertrack(det, tracker, frames,
                                       name="synthetic-1080p")
    finally:
        del det.detect
    ms = {k: v * 1e3 / len(frames) for k, v in parts.items()}
    print(f"CenterTrack detect() by stage (a second loop, synchronized "
          f"after each stage, ms/frame): "
          + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
          + f"; sum {sum(ms.values()):.2f}, this loop's detector "
          f"{res.stage_times['detector_s'] * 1e3 / res.num_frames:.2f}, "
          f"the sync-free loop's {det_ms:.2f}")


def phase_centertrack(device, engine):
    """Phase 9a: the full-width CenterTrack (DLA-34, exact DCNv2, 544x960,
    float32) against the CPU, its step's time, peak memory, profile and DCN
    share, the two other samplings' steps, then
    ``track_frames_centertrack`` with ``CenterTrackAdapter`` + BUSCA in
    ``engine``'s dtype over the dropout sequence at 1080x1920.  Returns
    K1's launches over the loop and the detector."""
    import numpy as np
    import torch

    from busca_tpu_torch.eval.detector import (
        CenterTrackDetector,
        track_frames_centertrack,
    )
    from busca_tpu_torch.eval.run import make_tracker
    from busca_tpu_torch.eval.synthetic import (
        SyntheticSequence,
        default_dropout_sequence,
    )
    from busca_tpu_torch.models.centertrack import CenterTrackConfig
    from busca_tpu_torch.ops import crop_cuda
    from busca_tpu_torch.ops.crop_cuda import crop_resize_cuda
    from busca_tpu_torch.trackers.base import Track

    cfg = CenterTrackConfig()
    base = default_dropout_sequence(40)
    seq = SyntheticSequence(base.objects, num_frames=base.num_frames,
                            height=FRAME_HW[0], width=FRAME_HW[1],
                            seed=base.seed)
    frames = [seq.frame(t) for t in range(CT_FRAMES)]
    t0 = time.perf_counter()
    det = CenterTrackDetector(cfg, test_size=CT_TEST_SIZE,
                              out_thresh=CT_OUT_THRESH, device=device,
                              seed=0)
    bias = ct_random_weights(det, frames[0])
    n_params = sum(p.numel() for p in det.model.parameters())
    torch.cuda.synchronize()
    print(f"CenterTrack build (DLA-34 {cfg.channels}, levels {cfg.levels}, "
          f"sampling {cfg.sampling!r}, {CT_TEST_SIZE[0]}x{CT_TEST_SIZE[1]}, "
          f"{n_params} parameters) and calibration: "
          f"{time.perf_counter() - t0:.2f} s; hm weights x{CT_HM_GAIN}, hm "
          f"bias {bias:.4f}, wh bias {CT_WH_BIAS}")
    ct_check_against_cpu(det, device)

    canvas, _ = det.prep(torch.as_tensor(frames[0]).to(device))
    pre_hm = torch.from_numpy(det._render_pre_hm(
        [{"bbox": b} for b in seq.detections(0)[0]],
        CT_TEST_SIZE[0] / FRAME_HW[0])).to(device)
    ct_offsets_report(det, canvas, pre_hm)

    step_ms = cuda_time_ms(lambda: det.step(canvas, canvas, pre_hm),
                           reps=10, warmup=2)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    det.step(canvas, canvas, pre_hm)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    x = (canvas.permute(2, 0, 1)[None].float() / 255.0,) * 2 + \
        (pre_hm.permute(2, 0, 1)[None],)
    flops, dcn_flops = ct_flops(det.model, x)
    rate = flops / (step_ms * 1e-3)
    print(f"CenterTrack step (normalize, DLA-34 + 16 DCN, sigmoid, decode) "
          f"at {CT_TEST_SIZE}: {step_ms:.2f} ms; {flops / 1e9:.2f} GFLOP "
          f"float32 ({dcn_flops / 1e9:.2f} in the DCN contractions), "
          f"{rate / 1e12:.2f} TFLOP/s, {100 * rate / FP32_FLOPS_PER_S:.1f}% "
          f"of the 67 TFLOP/s peak (bound "
          f"{flops / FP32_FLOPS_PER_S * 1e3:.2f} ms)")
    print(f"CenterTrack step peak memory: {peak / 1e6:.1f} MB allocated, "
          f"{(peak - held) / 1e6:.1f} MB above the {held / 1e6:.1f} MB held "
          "before the step")
    by_kind = profile_step(lambda: det.step(canvas, canvas, pre_hm),
                           step_ms, label="CenterTrack step", top=12)
    step_dev = sum(by_kind.values())
    if step_dev:
        g = by_kind.get("gather (index_select)", 0.0)
        print(f"CenterTrack step profile: DCN gathers (index_select) "
              f"{g:.2f} ms ({100 * g / step_dev:.1f}% of the device time)")
    ct_dcn_times(det, canvas, pre_hm, step_dev)
    ct_sampling_steps(det, canvas, pre_hm, step_dev)

    def make_ct_tracker():
        return make_tracker(
            "centertrack", {"use_busca": True,
                            "track_thresh": CT_TRACK_THRESH,
                            "use_camera_motion_compensation": False},
            engine, CROP_HW)

    tracker = make_ct_tracker()
    rounds = Counted(engine, "associate")
    n_dets = []
    detect = det.detect

    def counted_detect(frame, tracks=None):
        out = detect(frame, tracks=tracks)
        n_dets.append(len(out[0]))
        return out

    det.detect = counted_detect
    # the (frame, output, flags) of every K1 launch in the loop: each must
    # be a shape held against the plain version in phase 1
    k1_shapes = set()
    launch = crop_cuda.launch

    def recorded_launch(frame, boxes, scratch, out, **kw):
        k1_shapes.add((tuple(frame.shape[:2]), tuple(out.shape[1:3]),
                       tuple(sorted(kw.items()))))
        return launch(frame, boxes, scratch, out, **kw)

    crop_cuda.launch = recorded_launch
    det.reset()
    Track.reset_id_counter()
    crop_resize_cuda.launches = 0
    try:
        res = track_frames_centertrack(det, tracker, frames,
                                       name="synthetic-1080p")
    finally:
        crop_cuda.launch = launch
        rounds.remove()
        del det.detect
    k1 = crop_resize_cuda.launches
    main_kw = tuple(sorted(K1_MAIN_KW.items()))
    held = {(FRAME_HW, CT_LETTERBOX_HW, main_kw),
            (CT_TEST_SIZE, CROP_HW, main_kw)}
    print(f"CenterTrack loop: K1 (frame, output) shapes "
          f"{sorted(s[:2] for s in k1_shapes)}")
    check(k1_shapes <= held, f"K1 ran at shapes its own phase did not "
          f"hold: {k1_shapes - held}")
    n_tracks = [len(r[2]) for r in res.results]
    det_ms = res.stage_times["detector_s"] * 1e3 / res.num_frames
    trk_ms = res.stage_times["tracker_s"] * 1e3 / res.num_frames
    print(f"CenterTrack loop ({FRAME_HW[0]}x{FRAME_HW[1]}, {res.num_frames} "
          f"frames, out_thresh {CT_OUT_THRESH}, track_thresh "
          f"{CT_TRACK_THRESH}, BUSCA {engine.config.dtype}): detections per "
          f"frame {n_dets}; output tracks per frame {n_tracks}")
    print(f"CenterTrack loop: detector {det_ms:.2f} ms/frame, tracker "
          f"{trk_ms:.2f} ms/frame, total {1e3 / res.fps:.2f} ms/frame; "
          f"{rounds.calls} third rounds; K1 launches {k1}")
    ct_detect_stages(det, make_ct_tracker(), frames, det_ms)
    for _, tlwhs, _, confs in res.results:
        check(np.isfinite(np.reshape(tlwhs, (-1, 4))).all()
              and np.isfinite(confs).all(), "non-finite tracks")
    check(10 <= np.mean(n_dets) <= 30,
          f"{np.mean(n_dets):.1f} detections per frame, not 10-30")
    check(sum(n_tracks) > 0, "the CenterTrack loop output no track")
    check(k1 >= res.num_frames,
          f"K1 launched {k1} times, under one per frame")
    check(rounds.calls >= 1, "no third round ran in the CenterTrack loop")
    return k1, det


def phase_alternates(device, crowd):
    """Phase 9b: MOTDT with the ReID extractor on the crowd's first
    ALT_FRAMES frames (ms/frame, the extractor's share, K1's launches), and
    SORT on all its detections through the CLI's ``make_tracker`` (ms/frame
    and metrics against the crowd's ground truth).  Returns K1's launches on
    MOTDT."""
    import numpy as np

    from busca_tpu_torch.eval.run import make_tracker, shim_for_runner
    from busca_tpu_torch.eval.runner import evaluate_sequence, run_sequence
    from busca_tpu_torch.ops.crop_cuda import crop_resize_cuda
    from busca_tpu_torch.trackers import sort as sort_mod
    from busca_tpu_torch.trackers.base import IdCounter

    ext, frames, dets, gt = crowd
    n = ALT_FRAMES
    crop_resize_cuda.launches = 0
    res, stats = run_feature_tracker(
        f"MOTDT (first {n} frames, the extractor on every detection)",
        "motdt", None, ext, frames[:n], dets[:n],
        {f: gt[f] for f in range(1, n + 1)}, {})
    k1 = crop_resize_cuda.launches
    print(f"MOTDT loop: K1 launches {k1}")
    check(k1 >= n, f"MOTDT launched K1 {k1} times, under one per frame")
    check(sum(len(r[2]) for r in res.results) > 0, "MOTDT output no track")

    # SORT runs on the host alone (no tensor reaches the card), so there is
    # no card-vs-CPU check: its parity with busca_tpu's SORT is held on the
    # CPU by tests/test_torch_sort_motdt.py and tests/test_torch_run_cli.py
    sort_mod.SortTrack._count = IdCounter(1)
    tracker = shim_for_runner("sort", make_tracker("sort", {}, None,
                                                   CROP_HW))
    t0 = time.perf_counter()
    res = run_sequence(tracker, [None] * len(dets), dets, name="crowd")
    ms = (time.perf_counter() - t0) * 1e3 / len(dets)
    m = evaluate_sequence(res, gt)
    rows = result_rows(res)
    print(f"SORT on the crowd's detections ({len(dets)} frames, "
          f"{np.mean([len(d[0]) for d in dets]):.1f} per frame): {ms:.3f} "
          f"ms/frame (host only), {len(rows)} rows; MOTA {m.mota:.4f} IDF1 "
          f"{m.idf1:.4f} IDs {m.num_switches}")
    check(len(rows) > 0 and np.isfinite(rows).all(),
          "SORT output no track or non-finite rows")
    check(np.isfinite(m.mota) and np.isfinite(m.idf1),
          "SORT: non-finite metrics")
    return k1


def loop_replies(res):
    """A loop's results as the server's replies carry them: ``(frame id,
    [{"id", "tlwh", "score"}])`` per frame."""
    return [(fid, [{"id": int(i), "tlwh": [float(v) for v in t],
                    "score": float(c)} for t, i, c in zip(tlwhs, ids, confs)])
            for fid, tlwhs, ids, confs in res.results]


def reply_tracks(replies):
    return [(r["frame_id"], r["tracks"]) for r in replies]


def first_difference(got, want):
    return next((g[0] for g, w in zip(got, want) if g != w), None)


def start_server(server, tag, connections):
    """``server.serve_unix`` on a fresh socket path in a thread of this
    script, for ``connections`` connections; returns the thread and a
    connected client (the first connection)."""
    import tempfile
    import threading

    from busca_tpu_torch.serve.server import TrackingClient

    path = os.path.join(tempfile.mkdtemp(prefix="busca_serve_"),
                        f"{tag}.sock")
    check(len(path.encode()) < 100, f"socket path too long: {path}")
    thread = threading.Thread(target=server.serve_unix, args=(path,),
                              kwargs={"max_connections": connections},
                              daemon=True)
    thread.start()
    t0 = time.perf_counter()
    while True:
        try:
            return thread, path, TrackingClient.connect_unix(path)
        except (FileNotFoundError, ConnectionRefusedError):
            check(thread.is_alive() and
                  time.perf_counter() - t0 < SV_CONNECT_S,
                  f"the server on {path} never came up")
            time.sleep(0.02)


def served_frames(client, frames, label, first=1):
    """Sends ``frames``; returns the replies and each round trip's ms."""
    replies, rtt = [], []
    for i, frame in enumerate(frames):
        t0 = time.perf_counter()
        reply = client.frame(frame)
        rtt.append((time.perf_counter() - t0) * 1e3)
        check(reply.get("ok"), f"{label}: frame {first + i} failed: "
              f"{reply.get('error')}")
        replies.append(reply)
    return replies, rtt


def phase_server_stream(label, det, make_factory, frames, cut, filters,
                        counters):
    """One detector configuration through the port's ``TrackingServer``:
    the in-process serial loop (``track_frames_with_detector``), the same
    frames served over a unix socket (replies equal the loop's exactly;
    each kernel in ``counters`` counted over this served stream), then a
    stream snapshotted after ``cut`` frames with SV_KEY, refused forged and
    unsigned, and restored on a second server built with a fresh factory
    over a new connection, its detector reset first (its state must come
    from the blob): the restored frames must equal the unbroken stream's.
    Returns the served stream's launches per counter."""
    import threading

    import numpy as np

    from busca_tpu_torch.eval.detector import track_frames_with_detector
    from busca_tpu_torch.serve.server import TrackingClient, TrackingServer

    min_area, vthresh = filters
    n = len(frames)
    loop_det = SerialOnly(det) if hasattr(det, "detect_async") else det

    def loop(out):
        if hasattr(det, "reset"):
            det.reset()
        out.append(track_frames_with_detector(
            loop_det, make_factory()(), frames, name=label,
            min_box_area=min_area, vertical_thresh=vthresh))
        return out[-1]

    res = loop([])
    loop_ms = 1e3 / res.fps
    want = loop_replies(res)
    # the same loop on a worker thread, as the server runs it
    threaded = []
    worker = threading.Thread(target=loop, args=(threaded,))
    worker.start()
    worker.join()
    check(threaded and loop_replies(threaded[0]) == want,
          f"{label}: the loop on a worker thread differs")
    stages = ", ".join(
        f"{where}: {1e3 / r.fps:.2f} ms/frame (detector "
        f"{r.stage_times['detector_s'] * 1e3 / n:.2f}, tracker "
        f"{r.stage_times['tracker_s'] * 1e3 / n:.2f})"
        for where, r in (("main thread", res),
                         ("a worker thread", threaded[0])))
    print(f"server {label}: the in-process serial loop on the {stages}")

    server = TrackingServer(det, make_factory(), min_box_area=min_area,
                            vertical_thresh=vthresh, snapshot_key=SV_KEY)
    thread, path, client = start_server(server, label, 2)
    check(client.start(label)["ok"], f"{label}: start failed")
    for c in counters:
        c.launches = 0
    replies, rtt = served_frames(client, frames, label)
    launches = [c.launches for c in counters]
    client.stop()
    got = reply_tracks(replies)
    check(got == want, f"{label}: the served replies differ from the "
          f"in-process loop's from frame {first_difference(got, want)}")
    server_ms = [r["ms"] for r in replies]
    n_tracks = [len(t) for _, t in got]
    counts = ", ".join(f"{c.__name__} launches {k}"
                       for c, k in zip(counters, launches))
    # the first frame of a server thread also creates that thread's cuBLAS
    # and cuDNN handles: the steady state is frames 2 on
    steady, own = np.mean(rtt[1:]), np.mean(server_ms[1:])
    print(f"server {label} ({n} frames of {frames[0].shape[0]}x"
          f"{frames[0].shape[1]} over a unix socket): round trip "
          f"{np.mean(rtt):.2f} ms/frame (median {np.median(rtt):.2f}; frame "
          f"1 {rtt[0]:.2f}, frames 2-{n} {steady:.2f}), the server's own ms "
          f"{np.mean(server_ms):.2f} (frame 1 {server_ms[0]:.2f}, frames "
          f"2-{n} {own:.2f}), the socket and the reply {steady - own:.2f}; "
          f"the in-process serial loop {loop_ms:.2f} ms/frame (round trip "
          f"{np.mean(rtt) - loop_ms:+.2f}, frames 2-{n} "
          f"{steady - loop_ms:+.2f}); replies equal the loop's on every "
          f"frame; output tracks per frame {n_tracks}; {counts}")
    check(sum(n_tracks[cut:]) > 0, f"{label}: no track after frame {cut}")

    # the interrupted stream: `cut` frames, a snapshot, the rest elsewhere
    client = TrackingClient.connect_unix(path)
    check(client.start(label)["ok"], f"{label}: start failed")
    served_frames(client, frames[:cut], label)
    t0 = time.perf_counter()
    header, blob = client.snapshot()
    snap_ms = (time.perf_counter() - t0) * 1e3
    check(header.get("frame_id") == cut, f"{label}: snapshot at frame "
          f"{header.get('frame_id')}, not {cut}")
    client.stop()
    thread.join(timeout=60)
    check(not thread.is_alive(), f"{label}: the first server did not stop")
    if hasattr(det, "reset"):
        det.reset()
    server_b = TrackingServer(det, make_factory(), min_box_area=min_area,
                              vertical_thresh=vthresh, snapshot_key=SV_KEY)
    thread, _, client = start_server(server_b, label + "_b", 1)
    forged = bytearray(blob)
    forged[len(blob) // 2] ^= 0x01
    reply = client.restore(bytes(forged))
    check(not reply["ok"] and "HMAC" in reply["error"],
          f"{label}: a forged blob was not refused: {reply}")
    reply = client.restore(blob[40:])  # the payload without its envelope
    check(not reply["ok"] and "unsigned" in reply["error"],
          f"{label}: an unsigned blob was not refused: {reply}")
    t0 = time.perf_counter()
    reply = client.restore(blob)
    restore_ms = (time.perf_counter() - t0) * 1e3
    check(reply["ok"] and reply["frame_id"] == cut,
          f"{label}: restore failed: {reply}")
    tail, _ = served_frames(client, frames[cut:], label, first=cut + 1)
    client.stop()
    thread.join(timeout=60)
    check(not thread.is_alive(), f"{label}: the second server did not stop")
    got_tail = reply_tracks(tail)
    check(got_tail == got[cut:], f"{label}: the restored stream differs "
          f"from the unbroken one from frame "
          f"{first_difference(got_tail, got[cut:])}")
    canvas = ""
    if hasattr(det, "state_dict"):
        canvas = (f", of it the detector's canvas "
                  f"{det.state_dict()['pre_canvas'].nbytes} bytes")
    print(f"server {label} snapshot after frame {cut}: blob {len(blob)} "
          f"bytes ({len(blob) / 1e6:.3f} MB, HMAC-signed{canvas}); snapshot "
          f"{snap_ms:.2f} ms, restore {restore_ms:.2f} ms (round trips); a "
          f"forged tag and an unsigned blob refused; frames {cut + 1}-{n} "
          f"on the second server equal the unbroken stream's")
    return launches


def phase_server(device, engine, yolox, transcenter, centertrack):
    """Phase 10: the port's ``TrackingServer`` on the card, with ByteTrack +
    BUSCA behind YOLOX-X, TransCenter + BUSCA and CenterTrack + BUSCA
    (BUSCA in ``engine``'s dtype).  Returns K1's launches on each served
    stream and K2's on TransCenter's."""
    from busca_tpu_torch.eval.detector import CenterTrackRunnerDetector
    from busca_tpu_torch.eval.run import make_tracker, shim_for_runner
    from busca_tpu_torch.eval.synthetic import (
        SyntheticSequence,
        default_dropout_sequence,
    )
    from busca_tpu_torch.ops.crop_cuda import crop_resize_cuda
    from busca_tpu_torch.ops.lma_cuda import local_tap_sum_cuda
    from busca_tpu_torch.trackers.base import Track

    base = default_dropout_sequence(40)
    seq = SyntheticSequence(base.objects, num_frames=base.num_frames,
                            height=FRAME_HW[0], width=FRAME_HW[1],
                            seed=base.seed)
    frames = [seq.frame(t) for t in range(SV_FRAMES)]

    def factories(name, thresh):
        # CMC off: the card host has no cv2
        kwargs = {"use_busca": True, "track_thresh": thresh,
                  "use_camera_motion_compensation": False}

        def make_factory():
            def factory():
                Track.reset_id_counter()
                trk = make_tracker(name, kwargs, engine, CROP_HW)
                return shim_for_runner(name, trk, crop_hw=CROP_HW)
            return factory
        return make_factory

    out = {}
    (out["server_yolox"],) = phase_server_stream(
        "yolox", yolox, factories("byte", YX_TRACK_THRESH), frames, SV_CUT,
        (100.0, 1.6), [crop_resize_cuda])
    few = frames[:SV_FEEDBACK_FRAMES]
    out["server_transcenter"], k2 = phase_server_stream(
        "transcenter", transcenter,
        factories("transcenter", TC_TRACK_THRESH), few, SV_FEEDBACK_CUT,
        (100.0, 1.6), [crop_resize_cuda, local_tap_sum_cuda])
    check(k2 == 12 * len(few), f"K2 launched {k2} times on the served "
          f"TransCenter stream, not 12 per frame")
    (out["server_centertrack"],) = phase_server_stream(
        "centertrack", CenterTrackRunnerDetector(centertrack),
        factories("centertrack", CT_TRACK_THRESH), few, SV_FEEDBACK_CUT,
        (0.0, None), [crop_resize_cuda])
    for key, k1 in out.items():
        check(k1 >= SV_FEEDBACK_FRAMES, f"{key}: K1 launched {k1} times, "
              "under one per frame")
    return out, k2


def msda_inputs(seed=11):
    """MSDA's inputs at the MOT17 pyramid, on the CPU: a seeded value, each
    query's own pixel centre plus offsets drawn with a std of MSDA_OFFSET_PX
    level pixels, and softmaxed weights; and the share of samples off their
    level."""
    import torch

    from busca_tpu_torch.models.transcenter import reference_points

    levels, c, heads = K2_PYRAMIDS["mot17"]
    g = torch.Generator().manual_seed(seed)
    (h0, w0), nl = levels[0], len(levels)
    lq, lv = h0 * w0, sum(h * w for h, w in levels)
    value = torch.randn((1, lv, heads, c // heads), generator=g)
    sizes = torch.tensor([(w, h) for h, w in levels], dtype=torch.float32)
    off = torch.randn((1, lq, heads, nl, MSDA_POINTS, 2), generator=g)
    loc = (reference_points(h0, w0, "cpu")[None, :, None, None, None, :]
           + off * MSDA_OFFSET_PX / sizes[:, None, :])
    weights = torch.randn((1, lq, heads, nl * MSDA_POINTS), generator=g)
    weights = weights.softmax(-1).reshape(1, lq, heads, nl, MSDA_POINTS)
    outside = ((loc < 0) | (loc > 1)).any(-1).float().mean(dim=(0, 1, 2, 4))
    return levels, value, loc, weights, outside


def msda_bytes(levels, value, loc, weights):
    """The bytes MSDA must move (each input read once, the output written
    once), and the float32 bytes of one corner's samples of level 0 in the
    plain version."""
    lq, heads = loc.shape[1], loc.shape[2]
    d = value.shape[3]
    out = lq * heads * d * 4
    io = (value.numel() + loc.numel() + weights.numel()) * 4 + out
    return io, lq * heads * MSDA_POINTS * d * 4


def draw_deformable_weights(model, seed=12):
    """Seeded non-zero offset and attention-weight kernels (zero in the
    published init, which would sample each query's own pixel centre with
    uniform weights and leave a broken gather unseen)."""
    import math

    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            for part, gain in ((".offsets.weight", TC_DEFORM_OFFSET_GAIN),
                               (".weights.weight", TC_DEFORM_WEIGHT_GAIN)):
                if name.endswith(part):
                    p.copy_(torch.randn(p.shape, generator=g).mul_(
                        gain / math.sqrt(p.shape[1])).to(p.device))


def deformable_step(det, label, frame, ref=None):
    """The deformable detector's step at TC_TEST_SIZE: its time, peak
    memory, device time by kind, and MSDA's device time inside it (the
    step's 12 calls run again on their captured inputs).  bf16 maps are
    held against ``ref``'s (float32) on the card."""
    import torch

    import busca_tpu_torch.models.transcenter as ttc

    if ref is not None:
        check_against_float32(det, ref, frame, "TransCenter deformable")
    canvas, _ = det.prep(torch.as_tensor(frame).to(det.device))
    down = det.config.down_ratio
    pre_hm = torch.zeros((TC_TEST_SIZE[0] // down, TC_TEST_SIZE[1] // down,
                          1), device=det.device)
    step_ms = cuda_time_ms(lambda: det.step(canvas, canvas, pre_hm), reps=5,
                           warmup=1)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    det.step(canvas, canvas, pre_hm)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"{label} step (forward, decode, NMS) at {TC_TEST_SIZE}: "
          f"{step_ms:.2f} ms back to back; peak memory {peak / 1e6:.1f} MB "
          f"allocated, {(peak - held) / 1e6:.1f} MB above the "
          f"{held / 1e6:.1f} MB held before the step")
    by_kind = profile_step(lambda: det.step(canvas, canvas, pre_hm), step_ms,
                           label=f"{label} step")
    captured = []
    msda = ttc.multi_scale_deformable_attention

    def recording(*args):
        captured.append(args)
        return msda(*args)

    ttc.multi_scale_deformable_attention = recording
    try:
        with torch.no_grad():
            det.step(canvas, canvas, pre_hm)
    finally:
        ttc.multi_scale_deformable_attention = msda
    calls = 2 * det.config.num_decoder_layers
    check(len(captured) == calls, f"{label}: {len(captured)} MSDA calls in "
          f"the step, not {calls}")
    busy = sum(by_kind.values())
    msda_ms = device_busy_ms(lambda: [msda(*a) for a in captured], reps=2)
    share = f"{100 * msda_ms / busy:.1f}%" if busy else "not measured"
    print(f"{label} step: the {calls} MSDA calls take {msda_ms:.2f} ms of "
          f"device time ({msda_ms / calls:.2f} ms each), {share} of the "
          f"step's {busy:.2f} ms")
    del captured
    return step_ms


def phase_deformable(device, engine):
    """Phase 11: TransCenter's exact deformable decoder.  MSDA on the card
    against the CPU at the MOT17 pyramid; the full-width
    ``sampling="deformable"`` model's maps against the CPU at TC_CPU_SIZE,
    its step in float32 and bf16; then TC_DEFORM_FRAMES frames of the
    TransCenter loop with BUSCA in ``engine``'s dtype.  Returns K1's
    launches over the loop."""
    import dataclasses

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
    from busca_tpu_torch.ops.deform import multi_scale_deformable_attention
    from busca_tpu_torch.ops.lma_cuda import local_tap_sum_cuda
    from busca_tpu_torch.trackers.base import Track

    levels, value, loc, weights, outside = msda_inputs()
    t0 = time.perf_counter()
    want = multi_scale_deformable_attention(value, levels, loc, weights)
    cpu_s = time.perf_counter() - t0
    args = (value.to(device), levels, loc.to(device), weights.to(device))
    got = multi_scale_deformable_attention(*args)
    torch.cuda.synchronize()
    check(tuple(got.shape) == tuple(want.shape) and got.is_cuda,
          f"MSDA output {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "MSDA non-finite")
    err = float((got.cpu() - want).abs().max())
    ms = cuda_time_ms(lambda: multi_scale_deformable_attention(*args),
                      reps=10, warmup=2)
    dev_ms = device_busy_ms(lambda: multi_scale_deformable_attention(*args))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    multi_scale_deformable_attention(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    io, corner = msda_bytes(levels, value, loc, weights)
    heads, c = value.shape[2], value.shape[2] * value.shape[3]
    print(f"MSDA at the MOT17 pyramid ({levels}, C={c}, {heads} heads, "
          f"{MSDA_POINTS} points, "
          f"offsets std {MSDA_OFFSET_PX} level px; samples off their level "
          f"by level {np.round(outside.numpy(), 4).tolist()}): card vs CPU "
          f"max|diff| {err:.3g} (tol {MSDA_TOL}); {ms:.2f} ms back to back, "
          f"device busy {dev_ms:.2f} ms, {peak / 1e6:.1f} MB above the "
          f"inputs at its peak; inputs and output {io / 1e6:.1f} MB (bound "
          f"{io / HBM_BYTES_PER_S * 1e3:.4f} ms by bytes), level 0's samples "
          f"{corner / 1e6:.1f} MB per corner; the CPU's call {cpu_s:.2f} s")
    check(float(outside.min()) > 0, "no MSDA sample left some level")
    check(err <= MSDA_TOL, f"MSDA card and CPU disagree: {err}")
    del args, got, want, value, loc, weights

    cfg = TransCenterConfig.for_dataset("mot17", sampling="deformable")
    t0 = time.perf_counter()
    det = TransCenterDetector(cfg, test_size=TC_TEST_SIZE,
                              out_thresh=TC_OUT_THRESH, device=device, seed=0)
    calibrate_heads(det.model)
    draw_deformable_weights(det.model)
    n_params = sum(p.numel() for p in det.model.parameters())
    print(f"TransCenter deformable build (PVTv2-b2, hidden {cfg.hidden_dim}, "
          f"{cfg.num_decoder_layers} decoder layers of MSDA, {cfg.dec_heads} "
          f"heads, {cfg.dec_n_points} points, {n_params} parameters; offset "
          f"and weight kernels drawn, gains {TC_DEFORM_OFFSET_GAIN} / "
          f"{TC_DEFORM_WEIGHT_GAIN}): {time.perf_counter() - t0:.2f} s")
    check_against_cpu(det, device, "TransCenter deformable",
                      tol=TC_DEFORM_MAP_TOL, tf32_control=True)
    base = default_dropout_sequence(40)
    seq = SyntheticSequence(base.objects, num_frames=base.num_frames,
                            height=FRAME_HW[0], width=FRAME_HW[1],
                            seed=base.seed)
    frames = [seq.frame(t) for t in range(TC_DEFORM_FRAMES)]
    deformable_step(det, "TransCenter deformable float32", frames[0])
    det16 = TransCenterDetector(
        dataclasses.replace(cfg, dtype="bfloat16"),
        state_dict=det.model.state_dict(), test_size=TC_TEST_SIZE,
        out_thresh=TC_OUT_THRESH, device=device)
    deformable_step(det16, "TransCenter deformable bf16", frames[0], det)
    del det16

    tracker = make_tracker(
        "transcenter", {"use_busca": True, "track_thresh": TC_TRACK_THRESH,
                        "use_camera_motion_compensation": False},
        engine, CROP_HW)
    det.reset()
    Track.reset_id_counter()
    crop_resize_cuda.launches = 0
    local_tap_sum_cuda.launches = 0
    res = track_frames_with_detector(det, tracker, frames,
                                     name="synthetic-1080p")
    k1, k2 = crop_resize_cuda.launches, local_tap_sum_cuda.launches
    n_tracks = [len(r[2]) for r in res.results]
    det_ms = res.stage_times["detector_s"] * 1e3 / res.num_frames
    print(f"TransCenter deformable loop ({FRAME_HW[0]}x{FRAME_HW[1]}, "
          f"{res.num_frames} frames, BUSCA {engine.config.dtype}): detector "
          f"{det_ms:.2f} ms/frame, total {1e3 / res.fps:.2f} ms/frame; "
          f"output tracks per frame {n_tracks}; K1 launches {k1}, K2 "
          f"launches {k2}")
    check(sum(n_tracks) > 0, "the deformable TransCenter loop output no "
          "track")
    check(k1 >= res.num_frames, f"the deformable loop launched K1 {k1} "
          "times, under one per frame")
    check(k2 == 0, f"the deformable decoder launched K2 {k2} times")
    return k1


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
        k1["letterbox_centertrack"] = phase_k1_letterbox(
            device, CT_LETTERBOX_HW, "CenterTrack")
        k1["crops_centertrack"] = phase_k1_canvas_crops(device)
        k1["pad_path"] = phase_k1_pad_path(device)
        k2 = phase_k2(device)
        engine, engine16 = phase_association(device)
        # BUSCA in bf16, the CLI's default, on the main paths
        k1_byte = phase_main_path(device, engine16)
        k1_tc, k2["launches"], tc32 = phase_transcenter(
            device, engine, k2["kernel_ms"])
        k1_tc16, k2["bf16"]["launches"], _ = phase_transcenter(
            device, engine16, k2["bf16"]["kernel_ms"], "bfloat16", tc32)
        k1_yolox, yolox = phase_yolox(device, engine16)
        k1_ss, k1_ghost, crowd = phase_feature_trackers(device, engine16)
        t_phase = time.perf_counter()
        k1_ct, centertrack = phase_centertrack(device, engine16)
        k1_motdt = phase_alternates(device, crowd)
        print(f"phase 9: {time.perf_counter() - t_phase:.2f} s")
        t_phase = time.perf_counter()
        k1_served, k2_served = phase_server(device, engine16, yolox, tc32,
                                            centertrack)
        print(f"phase 10: {time.perf_counter() - t_phase:.2f} s")
        del yolox, tc32, centertrack
        t_phase = time.perf_counter()
        k1_deformable = phase_deformable(device, engine16)
        print(f"phase 11: {time.perf_counter() - t_phase:.2f} s")
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # launches: the canonical path (the pipelined YOLOX loop, BUSCA in
    # bf16); K1's count on each path is listed beside it; K2's are the
    # TransCenter paths', the only ones that run it: float32 (the loop and
    # the served stream) at the top, bf16 under "bf16"
    k1["launches"] = k1_yolox
    k1["launches_by_path"] = {"byte_synthetic": k1_byte,
                              "transcenter_loop": k1_tc,
                              "transcenter_bf16_loop": k1_tc16,
                              "yolox_loop": k1_yolox,
                              "strongsort_loop": k1_ss,
                              "ghost_loop": k1_ghost,
                              "centertrack_loop": k1_ct,
                              "motdt_loop": k1_motdt,
                              **k1_served,
                              "transcenter_deformable_loop": k1_deformable}
    k2["launches_by_path"] = {"transcenter_loop": k2["launches"],
                              "server_transcenter": k2_served}
    k2["launches"] += k2_served
    print(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
