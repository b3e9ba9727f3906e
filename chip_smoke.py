#!/usr/bin/env python3
"""Smoke run of the PyTorch port (busca_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each failure exits non-zero before the result line):
1. the card (nvidia-smi name and power limit), torch/CUDA versions, and the
   build of kernel K1 from busca_tpu_torch/csrc/;
2. K1 against its plain torch version on the card: a seeded 1080x1920 frame,
   64 boxes (inside, partly outside, wholly outside, degenerate), every flag
   combination of the crop op; max |diff|, exact share, times and bound;
3. an association drive at 1080p: 16 tracks with full 11-crop memories and
   30 detections, all cropped through K1, scored by the full-width model
   (ResNet-50, d=512, 4 layers) with random seeded weights in float32, TF32
   off; the probability rows must be finite and sum to 1, and a small
   request must agree with the same model on the CPU;
4. the main path: ``run_synthetic`` base vs BUSCA on the dropout sequence
   rendered at 1080x1920, with K1's launch count read around it;
5. the ``kernels`` JSON line, then the result line
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
    from busca_tpu_torch.ops import crop_cuda

    t0 = time.perf_counter()
    crop_cuda.build(verbose=True)
    print(f"K1 build: {time.perf_counter() - t0:.2f} s "
          f"({os.path.relpath(crop_cuda.library_path())})")


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


def phase_k1(device):
    import numpy as np
    import torch

    from busca_tpu_torch.ops.crop import crop_resize_normalize_plain
    from busca_tpu_torch.ops.crop_cuda import crop_resize_cuda

    rng = np.random.RandomState(1)
    h, w = FRAME_HW
    frame = torch.from_numpy(
        rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).to(device)
    boxes_np = np.asarray(smoke_boxes(rng, N_BOXES, h, w), np.float32)
    boxes = torch.from_numpy(boxes_np).to(device)

    worst = {}
    for normalize in (False, True):
        for quantize in (True, False):
            for rgb_output in (False, True):
                kw = dict(normalize=normalize, bgr_input=True,
                          rgb_output=rgb_output, quantize_uint8=quantize)
                got = crop_resize_cuda(frame, boxes, CROP_HW, **kw)
                want = crop_resize_normalize_plain(frame, boxes, CROP_HW,
                                                   **kw)
                torch.cuda.synchronize()
                check(got.shape == (N_BOXES,) + CROP_HW + (3,),
                      f"K1 shape {tuple(got.shape)}")
                check(bool(torch.isfinite(got).all()), "K1 non-finite")
                diff = (got - want).abs()
                err = float(diff.max())
                exact = float((diff == 0).float().mean())
                # one uint8 LSB quantized, scaled by 1/(255*std) when
                # normalized afterwards
                tol = QUANT_TOL if quantize else FLOAT_TOL
                if normalize and quantize:
                    tol = QUANT_TOL / (255.0 * 0.224)
                print(f"K1 vs plain normalize={normalize} quantize="
                      f"{quantize} rgb={rgb_output}: max|diff| {err:.3g} "
                      f"exact {exact * 100:.4f}% (tol {tol:.3g})")
                check(err <= tol, f"K1 disagrees with plain: {err} > {tol}")
                worst[(normalize, quantize, rgb_output)] = err

    main_kw = dict(normalize=False, bgr_input=True, rgb_output=False,
                   quantize_uint8=True)
    launches0 = crop_resize_cuda.launches
    ms = cuda_time_ms(lambda: crop_resize_cuda(frame, boxes, CROP_HW,
                                               **main_kw))
    plain_ms = cuda_time_ms(lambda: crop_resize_normalize_plain(
        frame, boxes, CROP_HW, **main_kw), reps=5, warmup=1)
    # the kernel alone, on precomputed box parameters
    from busca_tpu_torch.ops import crop_cuda
    from busca_tpu_torch.ops.crop import box_params

    ip, pad = box_params(frame, boxes, True)
    out = torch.empty((N_BOXES,) + CROP_HW + (3,), device=device)
    kernel_ms = cuda_time_ms(lambda: crop_cuda.launch(
        frame, ip, pad, out, **main_kw))
    crop_resize_cuda.launches = launches0
    bms, bound_by, nbytes = bound_ms(FRAME_HW, boxes_np, out.numel())
    print(f"K1 at N={N_BOXES} {h}x{w} -> {CROP_HW}: op {ms:.4f} ms "
          f"(kernel alone {kernel_ms:.4f} ms), plain {plain_ms:.4f} ms, "
          f"bound {bms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB); no "
          "single PyTorch call computes this crop, so no library time")
    return {
        "name": "crop_resize (K1)",
        "route": "cuda",
        "source": "busca_tpu_torch/csrc/crop_resize.cu",
        "replaces": "busca_tpu/ops/crop_pallas.py:50",
        "max_abs_err": worst[(False, True, False)],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bms,
        "bound_by": bound_by,
        "library_ms": None,
    }


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
        engine = phase_association(device)
        k1["launches"] = phase_main_path(device, engine)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [k1]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
