#!/usr/bin/env python3
"""Smoke run of the PyTorch port (busca_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each failure exits non-zero before the result line):
1. the card (nvidia-smi name and power limit), torch/CUDA versions, and the
   build of kernels K1 and K2 from busca_tpu_torch/csrc/ (one nvcc each,
   started together), with their ptxas reports;
2. K1 against its plain torch version on the card: a seeded 1080x1920 frame,
   64 boxes (inside, partly outside, wholly outside, degenerate), every flag
   combination of the crop op, and the detector's letterbox shape (one
   full-frame box, 1080x1920 -> 612x1088); max |diff|, exact share, times
   and bound;
3. K2 against its plain torch version at the MOT17 decoder shape (4 levels,
   160x272, C=256, 8 heads, dilations 1/2/4/8, softmaxed weights) and at a
   ragged shape; max |diff|, exact share, times and bound;
4. an association drive at 1080p: 16 tracks with full 11-crop memories and
   30 detections, all cropped through K1, scored by the full-width model
   (ResNet-50, d=512, 4 layers) with random seeded weights in float32, TF32
   off; the probability rows must be finite and sum to 1, and a small
   request must agree with the same model on the CPU;
5. the ByteTrack main path: ``run_synthetic`` base vs BUSCA on the dropout
   sequence rendered at 1080x1920, with K1's launch count read around it;
6. the TransCenter loop: the full-width detector (PVTv2-b2, 6 decoder
   layers, 640x1088, random seeded weights with a calibrated head) against
   the same model on the CPU at 128x224 on all five maps, then
   ``track_frames_with_detector`` with TransCenterByteTracker + BUSCA over
   the dropout sequence at 1080x1920, with K1's and K2's launch counts read
   around it (K2: exactly 12 per frame);
7. the ``kernels`` JSON line, then the result line
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
QUANT_TOL, FLOAT_TOL = 1.0, 1e-3
PROB_TOL = 1e-3  # card vs CPU probabilities, float32 with TF32 off
LETTERBOX_HW = (612, 1088)  # 1080x1920 into the 640x1088 test size
# the flags both main paths crop with (BUSCA crops, the letterbox)
K1_MAIN_KW = dict(normalize=False, bgr_input=True, rgb_output=False,
                  quantize_uint8=True)
# K2: L, H4, W4, C, heads, dilations (MOT17 decoder shape; the ragged shape
# of tests/test_deform.py)
K2_SHAPES = {"mot17": (4, 160, 272, 256, 8, (1, 2, 4, 8)),
             "ragged": (3, 20, 24, 64, 4, (1, 2, 4))}
K2_TOL = 1e-5
TC_TEST_SIZE = (640, 1088)
TC_CPU_SIZE = (128, 224)  # every PVT stage divides: no SAME padding
TC_MAP_TOL = 1e-3  # card vs CPU maps, float32 with TF32 off
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
    kernel on prepared inputs) and the plain version.  The launches made
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


def k1_case(device, seed, boxes_fn, out_hw):
    """A seeded 1080x1920 uint8 frame on the card, its boxes (host and card)
    and the kernel-alone inputs: box parameters and an output buffer."""
    import numpy as np
    import torch

    from busca_tpu_torch.ops.crop import box_params

    rng = np.random.RandomState(seed)
    h, w = FRAME_HW
    frame = torch.from_numpy(
        rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).to(device)
    boxes_np = np.asarray(boxes_fn(rng, h, w), np.float32)
    boxes = torch.from_numpy(boxes_np).to(device)
    ip, pad = box_params(frame, boxes, True)
    out = torch.empty((len(boxes_np),) + tuple(out_hw) + (3,), device=device)
    return frame, boxes_np, boxes, ip, pad, out


def hold_k1(label, frame, boxes, ip, pad, out, kw, tol, timed):
    from busca_tpu_torch.ops import crop_cuda
    from busca_tpu_torch.ops.crop import crop_resize_normalize_plain
    from busca_tpu_torch.ops.crop_cuda import crop_resize_cuda

    out_hw = tuple(out.shape[1:3])
    return hold_against_plain(
        label,
        lambda: crop_resize_cuda(frame, boxes, out_hw, **kw),
        lambda: crop_resize_normalize_plain(frame, boxes, out_hw, **kw),
        lambda: crop_cuda.launch(frame, ip, pad, out, **kw),
        crop_resize_cuda, tol, out.shape, timed=timed)


def phase_k1(device):
    frame, boxes_np, boxes, ip, pad, out = k1_case(
        device, 1, lambda rng, h, w: smoke_boxes(rng, N_BOXES, h, w),
        CROP_HW)
    result = None
    for normalize in (False, True):
        for quantize in (True, False):
            for rgb_output in (False, True):
                kw = dict(normalize=normalize, bgr_input=True,
                          rgb_output=rgb_output, quantize_uint8=quantize)
                # one uint8 LSB quantized, scaled by 1/(255*std) when
                # normalized afterwards
                tol = QUANT_TOL if quantize else FLOAT_TOL
                if normalize and quantize:
                    tol = QUANT_TOL / (255.0 * 0.224)
                main = kw == K1_MAIN_KW
                held = hold_k1(f"K1 normalize={normalize} quantize="
                               f"{quantize} rgb={rgb_output}", frame, boxes,
                               ip, pad, out, kw, tol, timed=main)
                if main:
                    result = held
    bms, bound_by, nbytes = bound_ms(FRAME_HW, boxes_np, out.numel())
    print(f"K1 at N={N_BOXES} {FRAME_HW} -> {CROP_HW}: op {result['ms']:.4f}"
          f" ms (kernel alone {result['kernel_ms']:.4f} ms), plain "
          f"{result['plain_ms']:.4f} ms, bound {bms:.4f} ms by {bound_by} "
          f"({nbytes / 1e6:.1f} MB); no single PyTorch call computes this "
          "crop, so no library time")
    return {
        "name": "crop_resize (K1)",
        "route": "cuda",
        "source": "busca_tpu_torch/csrc/crop_resize.cu",
        "replaces": "busca_tpu/ops/crop_pallas.py:50",
        **result,
        "bound_ms": bms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def phase_k1_letterbox(device):
    """K1 at the TransCenter detector's letterbox shape: one full-frame box,
    1080x1920 -> 612x1088, quantized, not normalized."""
    frame, boxes_np, boxes, ip, pad, out = k1_case(
        device, 3, lambda rng, h, w: [[0.0, 0.0, float(w), float(h)]],
        LETTERBOX_HW)
    result = hold_k1(f"K1 at the letterbox shape {FRAME_HW} -> "
                     f"{LETTERBOX_HW}", frame, boxes, ip, pad, out,
                     K1_MAIN_KW, QUANT_TOL, timed=True)
    result["bound_ms"], bound_by, nbytes = bound_ms(FRAME_HW, boxes_np,
                                                    out.numel())
    print(f"K1 letterbox: op {result['ms']:.4f} ms (kernel alone "
          f"{result['kernel_ms']:.4f} ms), plain {result['plain_ms']:.4f} "
          f"ms, bound {result['bound_ms']:.4f} ms by {bound_by} "
          f"({nbytes / 1e6:.1f} MB)")
    return result


def k2_bound_ms(levels, h4, w4, c, heads):
    """Least time for the tap sum: bytes (values and weights read once, the
    float32 output written once) over the memory rate, or float32
    operations (a multiply and an add per term, 9 taps per level) over the
    float32 rate, whichever is larger."""
    nbytes = 4 * (levels * h4 * w4 * c + h4 * w4 * heads * levels * 9
                  + h4 * w4 * c)
    ops = 2 * levels * 9 * h4 * w4 * c
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, ops


def phase_k2(device):
    import torch

    from busca_tpu_torch.ops import lma_cuda
    from busca_tpu_torch.ops.lma import local_tap_sum, local_tap_sum_plain
    from busca_tpu_torch.ops.lma_cuda import local_tap_sum_cuda

    result = None
    for name, (levels, h4, w4, c, heads, dils) in K2_SHAPES.items():
        g = torch.Generator().manual_seed(5)
        vals = torch.randn((levels, h4, w4, c), generator=g).to(device)
        wts = torch.randn((h4, w4, heads, levels * 9),
                          generator=g).softmax(-1).to(device)
        out = torch.empty((h4, w4, c), device=device)
        held = hold_against_plain(
            f"K2 at {name} (L={levels}, {h4}x{w4}, C={c}, {heads} heads, "
            f"dils {dils})",
            lambda: local_tap_sum(vals, wts, dils, heads),
            lambda: local_tap_sum_plain(vals, wts, dils),
            lambda: lma_cuda.launch(vals, wts, dils, heads, out),
            local_tap_sum_cuda, K2_TOL, out.shape, timed=name == "mot17")
        if name != "mot17":
            continue
        bms, bound_by, nbytes, ops = k2_bound_ms(levels, h4, w4, c, heads)
        print(f"K2 at {name}: op {held['ms']:.4f} ms (kernel alone "
              f"{held['kernel_ms']:.4f} ms), plain {held['plain_ms']:.4f} "
              f"ms, bound {bms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} "
              f"MB, {ops / 1e9:.2f} GFLOP); no single PyTorch call computes "
              "this tap sum, so no library time")
        result = {
            "name": "local_tap_sum (K2)",
            "route": "cuda",
            "source": "busca_tpu_torch/csrc/local_tap_sum.cu",
            "replaces": "busca_tpu/ops/lma_pallas.py:60",
            **held,
            "bound_ms": bms,
            "bound_by": bound_by,
            "library_ms": None,
        }
    return result


def make_track(Track, crops, tlwhs, score=0.9):
    t = Track(tlwhs[0], score, image=crops[0])
    for crop, tlwh in zip(crops[1:], tlwhs[1:]):
        t.images_mem.append(crop)
        t.tlwh_mem.append(tlwh)
        t.conf_mem.append(score)
    t._tlwh = tlwhs[-1].copy()
    t.activate(1)
    return t


def phase_association(device):
    import numpy as np
    import torch

    from busca_tpu_torch.eval.run import build_engine
    from busca_tpu_torch.trackers.base import (
        KALMAN_CANDIDATE_CONF,
        Track,
        extract_uint8_crops,
    )

    rng = np.random.RandomState(2)
    h, w = FRAME_HW
    frame = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
    t0 = time.perf_counter()
    engine, _ = build_engine(device=device, crop_hw=CROP_HW, seed=0)
    print(f"engine build (ResNet-50, d=512, 4 layers): "
          f"{time.perf_counter() - t0:.2f} s")

    n_tracks, n_dets, seq_len = 16, 30, engine.seq_len
    tracks = []
    for _ in range(n_tracks):
        x, y = rng.uniform(0, w - 200), rng.uniform(0, h - 400)
        tlwhs = [np.array([x + 3 * k, y + k, 80.0, 200.0])
                 for k in range(seq_len)]
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
    check(probs_matrix.shape == (n_tracks, n_dets + n_tracks),
          f"probs matrix shape {probs_matrix.shape}")
    check(bool(reliable.all()), "full memories must be reliable")
    req = engine._prep_request(tracks, dets, extra_kalman_candidates=kals)
    probs = engine._score_prepped(req, True)
    row_sums = probs.sum(-1)
    check(np.isfinite(probs).all(), "non-finite probabilities")
    check(np.allclose(row_sums, 1.0, atol=1e-5),
          f"probability rows do not sum to 1: {row_sums}")
    print(f"association T={n_tracks} D={n_dets} (+{n_tracks} Kalman) at "
          f"{h}x{w}: {np.median(times):.2f} ms median of {len(times)} "
          f"({', '.join(f'{t:.2f}' for t in times)}); rows finite, "
          f"max |sum-1| {np.abs(row_sums - 1).max():.2e}")

    # the same model on the CPU, on a small request (2 tracks, 5 dets)
    cpu_model = type(engine.model)(engine.config)
    cpu_model.load_state_dict(
        {k: v.cpu() for k, v in engine.model.state_dict().items()})
    from busca_tpu_torch.assoc.engine import AssociationEngine

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
    return engine


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
        print(f"main path {tag}: MOTA {m['mota']:.4f} IDF1 {m['idf1']:.4f} "
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
    ("matmul", ("gemm", "xmma", "cutlass", "cublas", "splitk")),
    ("convolution", ("conv", "cudnn", "implicit", "winograd")),
    ("upsample", ("upsample",)),
    ("softmax", ("softmax",)),
    ("layer norm", ("layer_norm", "layernorm")),
    ("sort", ("sort", "radix")),
)


def profile_step(step, step_ms, reps=3):
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
        print("detector step profile: the profiler recorded no device "
              "time (not measured)")
        return
    parts = ", ".join(f"{k} {v:.2f} ms ({100 * v / busy:.1f}%)"
                      for k, v in sorted(by_kind.items(),
                                         key=lambda kv: -kv[1]))
    print(f"detector step profile (mean of {reps}): device busy "
          f"{busy:.2f} ms of the {step_ms:.2f} ms step, idle "
          f"{100 * (1 - busy / step_ms):.1f}%; {parts}")


def phase_transcenter(device, engine, k2_ms):
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
    from busca_tpu_torch.models.transcenter import (
        TransCenterConfig,
        TransCenterDETR,
    )
    from busca_tpu_torch.ops.crop_cuda import crop_resize_cuda
    from busca_tpu_torch.ops.lma_cuda import local_tap_sum_cuda
    from busca_tpu_torch.trackers.base import Track

    cfg = TransCenterConfig.for_dataset("mot17")
    t0 = time.perf_counter()
    det = TransCenterDetector(cfg, test_size=TC_TEST_SIZE,
                              out_thresh=TC_OUT_THRESH, device=device, seed=0)
    calibrate_heads(det.model)
    n_params = sum(p.numel() for p in det.model.parameters())
    print(f"TransCenter build (PVTv2-b2, hidden {cfg.hidden_dim}, "
          f"{cfg.num_decoder_layers} decoder layers, {cfg.dec_heads} heads, "
          f"K={cfg.K}, {n_params} parameters): "
          f"{time.perf_counter() - t0:.2f} s")

    # the same model on the CPU at a reduced test size
    cpu_model = TransCenterDETR(cfg)
    cpu_model.load_state_dict(
        {k: v.cpu() for k, v in det.model.state_dict().items()})
    cpu_model.eval()
    g = torch.Generator().manual_seed(6)
    h, w = TC_CPU_SIZE
    down = cfg.down_ratio
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

    base = default_dropout_sequence(40)
    seq = SyntheticSequence(base.objects, num_frames=base.num_frames,
                            height=FRAME_HW[0], width=FRAME_HW[1],
                            seed=base.seed)
    frames = [seq.frame(t) for t in range(TC_FRAMES)]
    # warm-up frame (cuDNN algorithm choice, allocator), then the steady
    # step time with CUDA events on a fixed canvas
    det.reset()
    det.out_thresh = 0.0  # the first frame's score spread, for the record
    probe = det.detect(frames[0])
    det.out_thresh = TC_OUT_THRESH
    top = np.sort(probe.scores)[::-1]
    print(f"first frame: {len(top)} detections after NMS; every 5th of the "
          f"top 100 scores {np.round(top[:100:5], 3).tolist()}; above "
          + ", ".join(f"{th}: {int((top > th).sum())}"
                      for th in (0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)))
    frame0 = torch.as_tensor(frames[0]).to(device)
    canvas, _ = det.prep(frame0)
    pre_hm = torch.zeros((TC_TEST_SIZE[0] // down, TC_TEST_SIZE[1] // down,
                          1), device=device)
    step_ms = cuda_time_ms(lambda: det.step(canvas, canvas, pre_hm), reps=5,
                           warmup=1)
    print(f"detector step (forward, decode, NMS) at {TC_TEST_SIZE}: "
          f"{step_ms:.2f} ms")

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
    print(f"TransCenter loop ({FRAME_HW[0]}x{FRAME_HW[1]}, {res.num_frames} "
          f"frames, out_thresh {TC_OUT_THRESH}, track_thresh "
          f"{TC_TRACK_THRESH}): detections per frame {n_dets} (mean "
          f"{np.mean(n_dets):.1f}); output tracks per frame {n_tracks}")
    print(f"TransCenter loop: detector {det_ms:.2f} ms/frame, tracker "
          f"{trk_ms:.2f} ms/frame, total {1e3 / res.fps:.2f} ms/frame; "
          f"{third_rounds[0]} third rounds; K1 launches {k1_launches}, K2 "
          f"launches {k2_launches} (12 per frame: "
          f"{12 * res.num_frames}); K2 at {k2_ms:.4f} ms per launch is "
          f"{100 * 12 * k2_ms / det_ms:.1f}% of the detector's time")
    for _, boxes, scores in log:
        check(np.isfinite(boxes).all() and np.isfinite(scores).all(),
              "non-finite detections")
    profile_step(lambda: det.step(canvas, canvas, pre_hm), step_ms)
    check(k2_launches == 12 * res.num_frames,
          f"K2 launched {k2_launches} times, not 12 per frame")
    check(k1_launches > 0, "the TransCenter loop never launched K1")
    check(third_rounds[0] >= 1, "no third round ran in the TransCenter loop")
    check(sum(n_tracks) > 0, "the TransCenter loop output no track")
    return k1_launches, k2_launches


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = "cuda"
    try:
        phase_card()
        k1 = phase_k1(device)
        k1["letterbox"] = phase_k1_letterbox(device)
        k2 = phase_k2(device)
        engine = phase_association(device)
        k1_byte = phase_main_path(device, engine)
        k1_tc, k2["launches"] = phase_transcenter(device, engine,
                                                  k2["kernel_ms"])
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # launches: this slice's main path (the TransCenter loop); K1's count on
    # each path is listed beside it
    k1["launches"] = k1_tc
    k1["launches_by_path"] = {"byte_synthetic": k1_byte,
                              "transcenter_loop": k1_tc}
    print(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
