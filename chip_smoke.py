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
   TransCenter, -> 800x1422 for YOLOX), BUSCA's crops of CenterTrack's
   544x960 and YOLOX's 800x1440 canvases; and the pad
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
12. lockstep evaluation across sequences: four dropout sequences at
   1080x1920 (seeds 0, 3, 5, 7; one of 7 frames, three of 10) through
   phase 7's YOLOX-X, one batch step per lockstep frame
   (``detect_batch_async``: one upload, K1 letterboxes each frame into its
   slice of one canvas batch), ByteTracker + BUSCA in bf16, every frame's
   third rounds served by one ``associate_many``
   (``track_sequences_lockstep``).  The batch step enqueues without a host
   sync; its canvases equal the single-frame ones bit for bit, its rows,
   boxes and detections the single-frame step's; every K1 launch is at a
   shape phases 2 and 7 held; ``associate_many`` over the sequences' live
   third-round requests against per-request ``associate`` in float32 and
   bf16; each sequence's output against its own pipelined loop (ids
   relabelled); ms
   per sequence-frame against the sequential loop, the device's idle
   share over the lockstep frames, and the batch step at B=1 and B=4 in
   float32 and bf16, and in float32 through cuDNN (which the float32 YOLOX
   does not use on the card: ``precision.gemm_conv2d``);
13. the serving stack: (a) phase 7's pipelined loop over 10 frames on the
   main thread, on a fresh worker thread and again on that thread, each
   split into its detector and tracker stages, and the ops whose host
   time grows on a fresh thread (CPU profile); (b) phase 12's sequences
   served by ``LockstepTrackingServer`` behind phase 7's YOLOX-X on a unix
   socket (its accept loop on this thread, one client thread per stream):
   each stream equals its own in-process pipelined loop (ids relabelled),
   most ticks hold every active stream, a stream snapshotted after frame
   5 and restored over a new connection equals its unbroken loop; ms per
   sequence-frame against phases 12 and 10, and the device's idle share;
   (c) the YOLOX-X step exported with ``torch.export`` at 1080x1920
   (baked) and as a (1, 2, 4) batch family (unbaked): the program holds
   the registered crop op and cuDNN-free convolutions, its outputs equal
   the live step's bit for bit (float32 and bf16), 20 frames of
   ``ArtifactDetector`` through the pipelined loop equal the live loop,
   and the lockstep server behind ``ArtifactBatchDetector`` equals (b);
   export and load seconds, bytes, the program's time against the live
   step's; K1's launches on the served and exported paths;
14. training: (a) ``MotEpisodeSampler`` cuts ``EpisodeSpec()`` batches (8
   episodes, 11 memory crops and 5 candidates at 384x128) from phase 8's
   crowd, its gt written to a temp dir and its rendered frames handed to
   the sampler, one K1 launch per sequence frame of a batch; the
   full-width ``BuscaConfig()`` (ResNet-50, d=512, 4 layers, dropout 0.1)
   takes 10 float32 steps (TF32 off) with ``make_optimizer()`` (optax's
   AdamW, clip 1.0): every loss and gradient finite; the step's time
   (CUDA events), device busy and idle share, peak allocated memory and
   share of the float32 peak; the loss falls over 5 steps on one batch and
   mask; one bf16 step's loss against the float32 step's on the same
   batch, weights and mask; (b) one step at the small config (2 layers,
   ReID stages (1, 1, 1, 1), 64x32, dropout 0) on the card against the
   CPU from the same weights and batch: loss, every gradient, the updated
   parameters; (c) a full-width run saved after 2 steps and restored on a
   fresh model and optimizer, 2 steps on beside the unbroken run with
   cuDNN's deterministic algorithms: bit for bit; (d)
   ``train_demo_model`` + ``run_trained_rescue`` (accuracy > 0.6, base
   MOTA > 0.6, BUSCA MOTA >= base, no identity switch; K1 counted) and
   ``train_aflink_synthetic(steps=150, batch=64)`` (accuracy > 0.8, the
   linker merges a split trajectory), with their seconds;
15. frozen-stats ReID (``reid_stats='frozen'|'auto'``; run after phase 13):
   (a) the full-width engine from ``build_engine(reid_stats=...)`` in
   float32 (TF32 off) and bf16, its running statistics calibrated by
   ``calibrate_batch_stats`` on K1 crops of phase 8's crowd, at phase 4's
   shape (T=16, D=30, +16 Kalman): crops encoded per call (warm: none),
   warm equal to cold exactly, a 2-slot host cache, a small bank and the
   host cache against the default bank within 1e-6 in float32
   (busca_tpu's bars), card against CPU within 1e-3; batch mode against
   frozen cold, warm and next frame, and auto, in host ms and device busy;
   (b) auto's crossover: the fused forward against the cached path at
   T in 1..64, D=30, device ms (``AUTO_FUSED_MAX_T`` stays 1); (c) phase
   7's YOLOX-X loop with BUSCA bf16 frozen against batch mode in ms/frame,
   phase 12's sequences in lockstep with frozen (each equal to its own
   frozen loop, ids relabelled, tlwh within 0.1 px), the lockstep server
   with frozen and a stream snapshotted and restored, K1 counted in each;
   (d) the ``frozen_delta`` (in-domain and the ``dim`` shift) and
   ``memcap_delta`` CLIs at their defaults, in two processes side by side;
   (e) ``--det-ap``'s COCO table over the frozen loop's detections;
16. the dp x tp mesh (run after phase 14) on a one-rank NCCL group (a local
   TCP store, no gloo): (a) ``make_sharded_train_step`` on the full-width
   ``BuscaConfig()`` against ``make_train_step`` from the same weights,
   phase 14's first batch and the same generators, 3 steps with cuDNN's
   deterministic algorithms: losses and every parameter bit for bit, the
   steps' ms beside phase 14's; (b) ``--lockstep-dp 1`` (the detector's
   lockstep batch split over ``local_devices(1)``) over phase 12's
   sequences: every row equal to phase 12's lockstep output (0 px), K1
   counted; (c) ``global_metrics`` and ``psum_tallies`` through NCCL equal
   to the local sums; with two or more cards, ``dryrun_multichip(2)`` over
   NCCL, else a line saying the multi-rank mesh ran over gloo in Tier-1;
17. item 25 (run after phase 15): (a) the device ECC (``ops/ecc.py``, 50
   iterations) on a shift and a small rotation at 800x1440 and 1080x1920:
   its warp against cv2's ``findTransformECC`` (within 0.25) and the
   truth, the card against the CPU port (10 iterations), ms per pair
   against cv2's on this host; (b) phase 7's YOLOX-X loop over 5 frames
   around the dropout with ``viz_dir`` and an engine with ``debug_dir``
   (one JPEG per frame, one decision montage per third-round call, one
   call of phase 4's kind added), then the same frames through a serial
   loop timed by ``StageTimer(sync=True)``;
18. the ``kernels`` JSON line, then the result line
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
# Phase 12: lockstep evaluation across sequences.  LS_SEEDS' dropout
# sequences at 1080x1920, LS_LENGTHS frames each from frame LS_START on (the
# dropout of the first object starts at 18; one sequence ends early, which
# drives the padding), through phase 7's calibrated float32 YOLOX-X in one
# batch step per lockstep frame and BUSCA in bf16.  The batch step's rows
# against the single-frame step's within LS_ROW_TOL of the rows' scale,
# detections' boxes within LS_BOX_PX frame pixels; associate_many against
# per-request associate within rtol/atol LS_PROB_RTOL/LS_PROB_ATOL in
# float32 (tests/test_engine.py's bound) and LS_BF16_PROB_BAR in bf16 (the
# third-round bar, tests/test_pipeline_fuzz.py:138) with equal decisions.
LS_SEEDS, LS_LENGTHS, LS_START = (0, 3, 5, 7), (10, 10, 7, 10), 10
LS_ROW_TOL, LS_BOX_PX = 1e-4, 0.1
LS_PROB_RTOL, LS_PROB_ATOL, LS_BF16_PROB_BAR = 2e-4, 2e-6, 0.0242
# Phase 13: the serving stack.  13a runs phase 7's pipelined loop over
# TH_FRAMES frames on the main thread and on worker threads; 13b serves
# phase 12's sequences through the lockstep server (SL_TICK_S, the server
# CLI's default tick timeout), one stream snapshotted after SL_CUT frames;
# 13c exports phase 7's step (baked) and a batch family at ART_BATCHES
# (unbaked: one copy of the weights on disk, not one per bucket).
TH_FRAMES = 10
SL_TICK_S = 0.010
SL_CUT = 5
ART_BATCHES = (1, 2, 4)
ART_ROUNDS = 5
# a stream hold lasts three times the host time it covers, and at least
# this long: a busy host's enqueue must not outrun it
HOLD_MIN_S = 0.25
# Phase 14: training.  The full-width BuscaConfig() (dropout 0.1) in float32
# (TF32 off) on EpisodeSpec() batches (8 episodes of 11 memory crops and 5
# candidates at 384x128) that MotEpisodeSampler cuts from phase 8's crowd
# through K1: TR_STEPS steps, then TR_REPEAT steps on one batch with one
# dropout mask (its loss must fall), then one bf16 step from the same
# weights, whose loss must lie within TR_BF16_LOSS_TOL of the float32 step's
# (a decade above the CPU's largest gap at the small config, 0.011 over
# three seeds).  Card against the CPU at TR_SMALL (dropout 0): the
# loss within 1e-5 relative; each gradient within the larger of TR_GRAD_RTOL
# of its largest element plus TR_GRAD_ATOL (tests/test_torch_trainer.py's
# bound against busca_tpu) and twice the CPU's own float32 spread over
# TR_PERTURBATIONS + 1 equally valid evaluations (cpu_gradient_spread); the
# card's updated parameters against the CPU's AdamW run on the card's
# gradients, within 1e-6 relative plus 1e-3 lr; and the card's gradients
# with TF32 on must break that gradient bound.  Resume after
# TR_RESUME_K steps, compared over two more.
TR_STEPS = 10
TR_REPEAT = 5
TR_SEED = 14
TR_BF16_LOSS_TOL = 0.1
TR_SMALL = dict(num_layer=2, reid_num_classes=7, reid_layers=(1, 1, 1, 1),
                dropout_p=0.0)
TR_SMALL_SPEC = dict(batch=4, seq_len=3, num_candidates=2, crop_hw=(64, 32))
TR_GRAD_RTOL, TR_GRAD_ATOL = 2e-4, 1e-6
TR_PERTURBATIONS = 4
TR_RESUME_K = 2
FP32_PEAK_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
# Phase 15: frozen-stats ReID.  The frozen engines' running statistics are
# calibrated on K1 crops of these crowd frames (phase 8's, ~96 boxes each);
# busca_tpu's cache bars (tests/test_engine_frozen.py) on float32
# probabilities; auto's crossover is measured at these track counts.
FZ_CALIB_FRAMES = (0, 10, 20)
FZ_PROB_TOL = 1e-6
FZ_CROSSOVER_T = (1, 2, 4, 8, 16, 32, 64)
FZ_STUDY_TIMEOUT_S = 600


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
        # a record_function range (the optimizer's step) is mirrored on the
        # device's timeline as an annotation, not a kernel
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
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


def card_name_and_limit():
    """The card's name and power limit as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi unavailable"


def phase_card():
    import torch

    print(card_name_and_limit())  # as nvidia-smi prints it
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
    """K1 through the registered op (``crop_resize_normalize``, what every
    path calls) against the plain version; one call must launch K1 once.
    When ``timed``, also the ctypes wrapper alone back to back
    (``wrapper_ms``): the op's dispatch cost is the difference."""
    from busca_tpu_torch.ops import crop_cuda
    from busca_tpu_torch.ops.crop import (
        crop_resize_normalize,
        crop_resize_normalize_plain,
    )
    from busca_tpu_torch.ops.crop_cuda import crop_resize_cuda

    out_hw = tuple(out.shape[1:3])
    launches = crop_resize_cuda.launches
    crop_resize_normalize(frame, boxes, out_hw, **kw)
    check(crop_resize_cuda.launches == launches + 1,
          f"{label}: the registered op did not launch K1 once")
    crop_resize_cuda.launches = launches
    result = hold_against_plain(
        label,
        lambda: crop_resize_normalize(frame, boxes, out_hw, **kw),
        lambda: crop_resize_normalize_plain(frame, boxes, out_hw, **kw),
        lambda: crop_cuda.launch(frame, boxes, scratch, out, **kw),
        crop_resize_cuda, K1_TOL, out.shape, timed=timed)
    if timed:
        result["wrapper_ms"] = cuda_time_ms(
            lambda: crop_resize_cuda(frame, boxes, out_hw, **kw))
        crop_resize_cuda.launches = launches
    return result


def report_k1(label, result, frame_hw, boxes_np, out):
    """Adds K1's bound at this case to ``result`` and prints the case's op,
    kernel-alone, plain and bound times."""
    result["bound_ms"], bound_by, nbytes = bound_ms(frame_hw, boxes_np,
                                                    out.numel())
    print(f"K1 {label}: op {result['ms']:.4f} ms (the registered op; the "
          f"ctypes wrapper alone {result['wrapper_ms']:.4f} ms, kernel alone "
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


def phase_k1_canvas_crops(device, canvas_hw=CT_TEST_SIZE,
                          label="CenterTrack"):
    """K1 at a detector's BUSCA crops: N_BOXES boxes -> CROP_HW from its
    uint8 letterbox canvas (CenterTrack's 544x960, YOLOX's 800x1440), exact
    against the plain version."""
    frame, boxes_np, boxes, scratch, out = k1_case(
        device, 5, canvas_crop_boxes, CROP_HW, frame_hw=canvas_hw)
    result = hold_k1(f"K1 {label} crops {canvas_hw} -> {CROP_HW}, "
                     f"{len(boxes_np)} boxes", frame, boxes, scratch, out,
                     K1_MAIN_KW, timed=True)
    report_k1(f"{label} canvas crops", result, canvas_hw, boxes_np, out)
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
    # (PyTorch's own convolution path is im2col, then a GEMM under matmul)
    ("convolution", ("conv", "cudnn", "implicit", "winograd", "fprop",
                     "im2col")),
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
                        counters, served=None):
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
    if served is not None:
        served[label] = steady

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

    out, served = {}, {}
    (out["server_yolox"],) = phase_server_stream(
        "yolox", yolox, factories("byte", YX_TRACK_THRESH), frames, SV_CUT,
        (100.0, 1.6), [crop_resize_cuda], served)
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
    return out, k2, served["yolox"]


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


def lockstep_sequences():
    """Phase 12's sequences (see LS_SEEDS): lists of uint8 1080x1920
    frames."""
    from busca_tpu_torch.eval.synthetic import (
        SyntheticSequence,
        default_dropout_sequence,
    )

    seqs = []
    for seed, n in zip(LS_SEEDS, LS_LENGTHS):
        base = default_dropout_sequence(40, seed=seed)
        seq = SyntheticSequence(base.objects, num_frames=base.num_frames,
                                height=FRAME_HW[0], width=FRAME_HW[1],
                                seed=seed)
        seqs.append([seq.frame(t) for t in range(LS_START, LS_START + n)])
    return seqs


def lockstep_batch_vs_single(det, frames):
    """The batch step on one frame of each sequence against the
    single-frame step: no host sync in ``detect_batch_async``, one K1
    launch per frame, canvases bit-equal, decoded rows within LS_ROW_TOL of
    their scale, the candidates' boxes (rows scoring above the detector's
    threshold) within LS_BOX_PX frame pixels, equal detection counts, and
    every detection the NMS keeps within LS_BOX_PX of one the single-frame
    step keeps (where two overlapping candidates nearly tie, noise in the
    rows would decide which one it keeps)."""
    import numpy as np
    import torch

    from busca_tpu_torch.ops.crop_cuda import crop_resize_cuda

    first = np.stack(frames)
    det.wait_batch(det.detect_batch_async(first))  # warm at this batch
    torch.cuda.synchronize()
    crop_resize_cuda.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = det.detect_batch_async(first)
    except RuntimeError as e:
        raise PhaseError(f"detect_batch_async synchronized: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = crop_resize_cuda.launches
    outs = det.wait_batch(handle)
    check(launches == len(frames),
          f"the batch step launched K1 {launches} times for "
          f"{len(frames)} frames")
    row_err = box_err = score_err = 0.0
    picks, moved = 0, 0
    for i, frame in enumerate(frames):
        single = det.detect(frame)
        check(torch.equal(outs[i].image, single.image),
              f"sequence {i}: the lockstep canvas differs from the "
              "single-frame canvas")
        with torch.no_grad():
            want = det.forward(single.image)
        got = handle.pred[i]
        row_err = max(row_err, float((got - want).abs().max()
                                     / want.abs().max()))
        score = want[:, 4] * want[:, 5:].max(-1).values
        cand = score >= det.conf_thresh
        if bool(cand.any()):
            box_err = max(box_err, float(
                (got[cand, :4] - want[cand, :4]).abs().max()) / single.scale)
            score_err = max(score_err, float(
                (got[cand, 4:] - want[cand, 4:]).abs().max()))
        check(len(outs[i].scores) == len(single.scores),
              f"sequence {i}: {len(outs[i].scores)} detections in the "
              f"batch, {len(single.scores)} alone")
        picks += len(outs[i].scores)
        if len(single.scores):
            gap = np.abs(outs[i].boxes_tlbr[:, None]
                         - single.boxes_tlbr[None]).max(-1) / single.scale
            moved += int((gap.min(1) > LS_BOX_PX).sum())
    print(f"lockstep batch step (B={len(frames)}) vs the single-frame step "
          f"on the card: detect_batch_async under set_sync_debug_mode("
          f"'error'): no host sync; K1 launches {launches} (one letterbox "
          f"per frame); canvases bit-equal; decoded rows max |diff| "
          f"{row_err:.3g} of their scale (tol {LS_ROW_TOL}); candidates' "
          f"boxes max |diff| {box_err:.3g} frame px (tol {LS_BOX_PX}), obj "
          f"and cls {score_err:.3g}; detections without a single-frame one "
          f"within {LS_BOX_PX} px: {moved} of {picks}")
    check(row_err <= LS_ROW_TOL, f"batch rows off by {row_err}")
    check(box_err <= LS_BOX_PX, f"batch boxes off by {box_err} px")
    check(moved == 0, f"{moved} batch detections without a single-frame "
          f"one within {LS_BOX_PX} px")


def lockstep_association_check(engine, engine16, live):
    """``associate_many`` over ``live`` third-round requests against
    per-request ``associate`` on the same card, ``reliable`` and the
    third-round decisions equal: the float32 engine within LS_PROB_RTOL /
    LS_PROB_ATOL, the bf16 one within LS_BF16_PROB_BAR, with each row's
    argmax equal where the per-request row's margin is above BF16_MARGIN
    (the random model's rows are nearly flat, phase 4)."""
    import numpy as np

    from busca_tpu_torch.trackers.base import select_third_round_matches
    from busca_tpu_torch.utils.padding import next_pow2

    requests = [(r.pool, r.considered, None, r.kalman_cands) for r in live]
    for eng in (engine, engine16):
        many = eng.associate_many(requests, select_highest_candidate=False)
        worst = excess = 0.0
        same_decisions = same_reliable = True
        confident = same_argmax = 0
        for r, (p_b, r_b) in zip(live, many):
            p_s, r_s = eng.associate(r.pool, r.considered,
                                     extra_kalman_candidates=r.kalman_cands,
                                     select_highest_candidate=False)
            check(p_b.shape == p_s.shape, "associate_many shape")
            same_reliable &= bool(np.array_equal(r_b, r_s))
            dp = np.abs(p_b - p_s)
            worst = max(worst, float(dp.max()))
            excess = max(excess, float((dp - LS_PROB_RTOL
                                        * np.abs(p_s)).max()))
            n_dets, n_pool = len(r.considered), len(r.pool)
            decided = [select_third_round_matches(
                p, rel, n_dets, n_pool, r.thresh)
                for p, rel in ((p_b, r_b), (p_s, r_s))]
            same_decisions &= ([m[0] for m in decided[0][0]]
                               == [m[0] for m in decided[1][0]])
            srt = np.sort(p_s, -1)
            sure = srt[:, -1] - srt[:, -2] > BF16_MARGIN
            confident += int(sure.sum())
            same_argmax += int((p_b.argmax(-1) == p_s.argmax(-1))[sure].sum())
        tracks = [len(r.pool) for r in live]
        f32 = eng is engine
        bound = (f"rtol {LS_PROB_RTOL}, atol {LS_PROB_ATOL}: worst excess "
                 f"over rtol {excess:.3g}" if f32
                 else f"bar {LS_BF16_PROB_BAR}")
        print(f"associate_many ({eng.config.dtype}) over {len(live)} "
              f"sequences' third-round requests (tracks {tracks}, "
              f"{next_pow2(len(live))} BN groups per kind) vs per-request "
              f"associate on the card: max |dp| {worst:.3g} ({bound}); "
              f"reliable equal: {same_reliable}; third-round decisions "
              f"equal: {same_decisions}; argmax equal on {same_argmax} of "
              f"{confident} rows whose margin > {BF16_MARGIN}")
        check(same_reliable, "associate_many changed reliable")
        check(same_decisions,
              f"{eng.config.dtype} associate_many changed a third-round "
              "decision")
        check(same_argmax == confident,
              f"{eng.config.dtype} associate_many changed a confident "
              "argmax")
        if f32:
            check(excess <= LS_PROB_ATOL,
                  f"float32 associate_many off by {worst} (rtol "
                  f"{LS_PROB_RTOL}, atol {LS_PROB_ATOL})")
        else:
            check(worst <= LS_BF16_PROB_BAR,
                  f"bf16 associate_many off by {worst}")


def lockstep_step_times(det, frames):
    """The batch step's CUDA-event ms and device-busy ms at B=1 and B=4,
    float32 (also with its convolutions through cuDNN) and bf16 (the
    detector's config in bf16, the same weights), frame 0's rows at B=4
    against B=1, and the bf16 B=4 step's profile (its idle share)."""
    import dataclasses

    import numpy as np
    import torch

    from busca_tpu_torch.eval.detector import YoloxDetector
    from busca_tpu_torch.models.precision import Conv2d

    x = torch.from_numpy(np.stack(frames)).to(det.device)
    det16 = YoloxDetector(dataclasses.replace(det.config, dtype="bfloat16"),
                          det.model.state_dict(), test_size=YX_TEST_SIZE,
                          conf_thresh=YX_CONF, device=det.device)
    convs = [m for m in det.model.modules() if isinstance(m, Conv2d)]
    times = {}
    for dtype, d, cudnn in (("float32", det, False),
                            ("float32 through cuDNN", det, True),
                            ("bfloat16", det16, True)):
        for m in convs:
            m.cudnn = cudnn
        rows = []
        for b in (1, len(frames)):
            xb = x[:b]
            ms = cuda_time_ms(lambda: d.batch_step(xb), reps=4, warmup=1)
            busy = device_busy_ms(lambda: d.batch_step(xb), reps=1)
            times[dtype, b] = (ms, busy)
            rows.append(d.batch_step(xb)[3][0])
        (m1, b1), (m4, b4) = times[dtype, 1], times[dtype, len(frames)]
        gap = float((rows[1].float() - rows[0].float()).abs().max()
                    / rows[0].float().abs().max())
        print(f"YOLOX-X batch step ({dtype}, letterbox + forward + "
              f"postprocess at {YX_TEST_SIZE}): B=1 {m1:.2f} ms (device "
              f"busy {b1:.2f}), B={len(frames)} {m4:.2f} ms (busy "
              f"{b4:.2f}); B={len(frames)} / ({len(frames)} x B=1) "
              f"{m4 / (len(frames) * m1):.3f} (busy "
              f"{b4 / (len(frames) * b1):.3f}); {m4 / len(frames):.2f} ms "
              f"per frame; frame 0's rows at B={len(frames)} vs B=1 max "
              f"|diff| {gap:.3g} of their scale")
    for m in convs:
        m.cudnn = False
    profile_step(lambda: det16.batch_step(x), times["bfloat16",
                                                   len(frames)][0],
                 reps=2, label=f"YOLOX-X bf16 batch step B={len(frames)}")
    del det16, x
    torch.cuda.empty_cache()
    return times


def phase_lockstep(device, engine, engine16, det):
    """Phase 12: lockstep evaluation across sequences (see LS_SEEDS).
    Returns K1's launches over the timed lockstep run."""
    import numpy as np
    import torch

    import busca_tpu_torch.trackers.base as tbase
    from busca_tpu_torch.eval.detector import (
        track_frames_with_detector,
        track_sequences_lockstep,
    )
    from busca_tpu_torch.eval.run import make_tracker
    from busca_tpu_torch.ops import crop_cuda
    from busca_tpu_torch.ops.crop_cuda import crop_resize_cuda

    t0 = time.perf_counter()
    seqs = lockstep_sequences()
    b = len(seqs)
    lockstep_batch_vs_single(det, [s[0] for s in seqs])
    # CMC off: the card host has no cv2
    kwargs = {"use_busca": True, "track_thresh": YX_TRACK_THRESH,
              "use_camera_motion_compensation": False}
    names = [f"seed{s}" for s in LS_SEEDS]

    def run_lockstep():
        tbase.Track.reset_id_counter()
        trackers = [make_tracker("byte", kwargs, engine16, CROP_HW)
                    for _ in seqs]
        return track_sequences_lockstep(det, trackers,
                                        [iter(f) for f in seqs], names=names)

    # run 1, instrumented: the shape of every K1 launch, the third-round
    # batches, and associate_many held against associate on the first
    # frame with the most live requests
    served, compared = [], [0]
    service = tbase.service_deferred_updates

    def spy(pending):
        live = [req for _, _, req in pending if req.thresh > 0 and req.pool]
        served.append(len(live))
        if len(live) > max(compared[0], 1) and compared[0] < b:
            lockstep_association_check(engine, engine16, live)
            compared[0] = len(live)
        return service(pending)

    k1_shapes = set()
    launch = crop_cuda.launch

    def recorded_launch(frame, boxes, scratch, out, **kw):
        k1_shapes.add((tuple(frame.shape[:2]), tuple(out.shape[1:3]),
                       tuple(sorted(kw.items()))))
        return launch(frame, boxes, scratch, out, **kw)

    tbase.service_deferred_updates = spy
    crop_cuda.launch = recorded_launch
    try:
        first = run_lockstep()
    finally:
        tbase.service_deferred_updates = service
        crop_cuda.launch = launch
    main_kw = tuple(sorted(K1_MAIN_KW.items()))
    held = {(FRAME_HW, YX_LETTERBOX_HW, main_kw),
            (YX_TEST_SIZE, CROP_HW, main_kw)}
    print(f"lockstep loop: K1 (frame, output) shapes "
          f"{sorted(s[:2] for s in k1_shapes)}; live third-round requests "
          f"per frame {served}")
    check(k1_shapes <= held, f"K1 ran at shapes phases 2 and 7 did not "
          f"hold: {k1_shapes - held}")
    check(compared[0] >= 2, "no lockstep frame had two live third rounds: "
          "associate_many was never held")

    # run 2, timed: the kernels line's launches
    torch.cuda.synchronize()
    crop_resize_cuda.launches = 0
    lock = run_lockstep()
    torch.cuda.synchronize()
    k1_launches = crop_resize_cuda.launches
    frames_total = sum(r.num_frames for r in lock)
    wall_s = sum(r.track_time_s for r in lock)
    check([r.num_frames for r in lock] == list(LS_LENGTHS),
          f"lockstep frames {[r.num_frames for r in lock]}")
    for a, c in zip(first, lock):
        for (fa, ta, ia, _), (fc, tc, ic, _) in zip(a.results, c.results):
            check(fa == fc and ia == ic and np.array_equal(
                np.reshape(ta, (-1, 4)), np.reshape(tc, (-1, 4))),
                f"{a.name} frame {fa}: two lockstep runs differ")

    # run 3, profiled: the device's busy time over the lockstep frames
    busy = sum(device_kernels_ms(run_lockstep, 1, warmup=False).values())

    # each sequence alone through the pipelined loop
    seq_s = 0.0
    solos = []
    for res, frames in zip(lock, seqs):
        tbase.Track.reset_id_counter()
        solo = track_frames_with_detector(
            det, make_tracker("byte", kwargs, engine16, CROP_HW), frames,
            name=res.name)
        solos.append(solo)
        seq_s += solo.track_time_s
        relabel = [{}, {}]
        worst = 0.0
        for (fa, ta, ia, _), (fb, tb, ib, _) in zip(res.results,
                                                    solo.results):
            la = [relabel[0].setdefault(i, len(relabel[0])) for i in ia]
            lb = [relabel[1].setdefault(i, len(relabel[1])) for i in ib]
            check(fa == fb and la == lb,
                  f"{res.name} frame {fa}: lockstep and sequential ids "
                  f"differ ({ia} vs {ib})")
            if len(ta):
                worst = max(worst, float(np.abs(
                    np.reshape(ta, (-1, 4)) - np.reshape(tb, (-1, 4))).max()))
        check(worst <= LS_BOX_PX, f"{res.name}: lockstep tlwh off by "
              f"{worst} px")
        n_tracks = [len(r[2]) for r in res.results]
        print(f"lockstep {res.name} ({res.num_frames} frames): output "
              f"tracks per frame {n_tracks}; equal to its sequential "
              f"pipelined loop (ids relabelled, tlwh max |diff| "
              f"{worst:.3g} px)")
        check(sum(n_tracks) > 0, f"{res.name}: no track was output")
    lock_ms = wall_s * 1e3 / frames_total
    seq_ms = seq_s * 1e3 / frames_total
    det_ms = sum(r.stage_times["detector_s"] for r in lock) * 1e3
    trk_ms = sum(r.stage_times["tracker_s"] for r in lock) * 1e3
    print(f"lockstep (B={b}, {frames_total} sequence-frames over "
          f"{max(LS_LENGTHS)} lockstep frames, BUSCA "
          f"{engine16.config.dtype}): {lock_ms:.2f} ms per sequence-frame "
          f"(waiting for the batch {det_ms / frames_total:.2f}, trackers "
          f"{trk_ms / frames_total:.2f}, the rest, chiefly the next "
          f"batch's upload and enqueue, "
          f"{lock_ms - (det_ms + trk_ms) / frames_total:.2f}) against "
          f"{seq_ms:.2f} ms/frame for "
          f"the sequences one by one through the pipelined loop "
          f"({seq_ms / lock_ms:.2f}x); device busy {busy:.1f} ms of "
          f"{wall_s * 1e3:.1f} ms, idle "
          f"{100 * (1 - busy / (wall_s * 1e3)):.1f}% over the lockstep "
          f"frames; K1 launches {k1_launches}")
    check(k1_launches >= b * max(LS_LENGTHS),
          f"K1 launched {k1_launches} times, under one per batch frame")
    lockstep_step_times(det, [s[0] for s in seqs])
    print(f"phase 12: {time.perf_counter() - t0:.2f} s")
    return k1_launches, {"seqs": seqs, "solo": solos, "lock_ms": lock_ms,
                         "lock": lock}


def yolox_frames(n):
    """Phase 7's frames: the dropout sequence at 1080x1920, its first
    ``n``."""
    from busca_tpu_torch.eval.synthetic import (
        SyntheticSequence,
        default_dropout_sequence,
    )

    base = default_dropout_sequence(40)
    seq = SyntheticSequence(base.objects, num_frames=base.num_frames,
                            height=FRAME_HW[0], width=FRAME_HW[1],
                            seed=base.seed)
    return [seq.frame(t) for t in range(n)]


def yolox_loop(det, engine, frames):
    """Phase 7's pipelined loop: ByteTrack + BUSCA (``engine``) behind
    ``det`` (a ``YoloxDetector`` or an ``ArtifactDetector``) over
    ``frames``, the track ids counted from 1."""
    from busca_tpu_torch.eval.detector import track_frames_with_detector
    from busca_tpu_torch.eval.run import make_tracker
    from busca_tpu_torch.trackers.base import Track

    Track.reset_id_counter()
    # CMC off: the card host has no cv2
    kwargs = {"use_busca": True, "track_thresh": YX_TRACK_THRESH,
              "use_camera_motion_compensation": False}
    return track_frames_with_detector(
        det, make_tracker("byte", kwargs, engine, CROP_HW), frames,
        name="yolox")


def loop_split(res):
    """``(ms/frame, detector ms/frame, tracker ms/frame)`` of a loop."""
    n = res.num_frames
    return (1e3 / res.fps, res.stage_times["detector_s"] * 1e3 / n,
            res.stage_times["tracker_s"] * 1e3 / n)


def cpu_profile(fn):
    """``fn()`` under torch.profiler's CPU activity, started on the calling
    thread: ``(result, {op: self CPU ms})``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = fn()
    return res, {e.key: e.self_cpu_time_total / 1e3
                 for e in prof.key_averages()}


def phase_thread_cost(det, engine, frames):
    """13a: the pipelined YOLOX-X loop on the main thread, on a fresh worker
    thread, and again on that same thread; then each under the CPU
    profiler (the main thread against another fresh thread), the ops whose
    host time grows the most on the fresh thread printed.  Every run's
    output must equal the main thread's.  Returns ms/frame by run."""
    from concurrent.futures import ThreadPoolExecutor

    n = len(frames)
    want = loop_replies(yolox_loop(det, engine, frames))  # warm
    runs = {"the main thread": yolox_loop(det, engine, frames)}
    with ThreadPoolExecutor(1) as pool:
        for label in ("a fresh worker thread", "that worker thread again"):
            runs[label] = pool.submit(yolox_loop, det, engine,
                                      frames).result()
    for label, res in runs.items():
        check(loop_replies(res) == want,
              f"thread cost: the loop on {label} differs")
        total, det_ms, trk_ms = loop_split(res)
        print(f"thread cost (the pipelined YOLOX-X loop, {n} frames, BUSCA "
              f"{engine.config.dtype}) on {label}: {total:.2f} ms/frame "
              f"(detector {det_ms:.2f}, tracker {trk_ms:.2f})")
    _, on_main = cpu_profile(lambda: yolox_loop(det, engine, frames))
    with ThreadPoolExecutor(1) as pool:
        _, on_fresh = pool.submit(
            cpu_profile, lambda: yolox_loop(det, engine, frames)).result()
    grown = sorted(((on_fresh.get(k, 0.0) - on_main.get(k, 0.0)) / n, k)
                   for k in set(on_main) | set(on_fresh))[::-1]
    print("thread cost profile, self CPU ms per frame on a fresh thread "
          "against the main thread (profiled runs): " + ", ".join(
              f"{k} {on_fresh.get(k, 0.0) / n:.2f} vs "
              f"{on_main.get(k, 0.0) / n:.2f}" for _, k in grown[:8]))
    return {label: loop_split(res)[0] for label, res in runs.items()}


def relabelled_gap(label, got, want):
    """``got`` and ``want`` as ``(frame id, tlwhs, ids)`` rows: equal frame
    ids and ids after relabelling each by first appearance; returns the
    largest tlwh |diff|."""
    import numpy as np

    check(len(got) == len(want), f"{label}: {len(got)} frames, not "
          f"{len(want)}")
    relabel = [{}, {}]
    worst = 0.0
    for (fa, ta, ia), (fb, tb, ib) in zip(got, want):
        la = [relabel[0].setdefault(i, len(relabel[0])) for i in ia]
        lb = [relabel[1].setdefault(i, len(relabel[1])) for i in ib]
        check(fa == fb and la == lb, f"{label} frame {fa}: ids differ "
              f"after relabelling ({ia} vs {ib})")
        if len(ta):
            worst = max(worst, float(np.abs(np.reshape(ta, (-1, 4))
                                            - np.reshape(tb, (-1, 4))).max()))
    return worst


def reply_rows(replies):
    return [(r["frame_id"], [t["tlwh"] for t in r["tracks"]],
             [t["id"] for t in r["tracks"]]) for r in replies]


def serve_lockstep(detector, factory, seqs, snapshot_stream=None,
                   profiled=False):
    """The port's ``LockstepTrackingServer`` behind ``detector`` on a unix
    socket in a fresh temp dir, its accept loop on this thread (its ticks
    on the server's scheduler thread), one client thread per sequence
    (frames rendered beforehand) sending its frames as fast as its replies
    come.  The ``snapshot_stream`` client snapshots
    after SL_CUT frames, stops, and restores over a new connection.
    Returns the replies per stream, the ticks' ``(batch, active streams)``,
    the wall seconds from the first frame sent to the last reply, and the
    device's busy ms when ``profiled``."""
    import tempfile
    import threading
    import types

    from busca_tpu_torch.serve.lockstep import LockstepTrackingServer
    from busca_tpu_torch.serve.server import TrackingClient

    server = LockstepTrackingServer(detector, factory,
                                    tick_timeout=SL_TICK_S,
                                    snapshot_key=SV_KEY)
    ticks = []

    def detect_batch(frames):
        ticks.append((len(frames), server._active_count()))
        return detector.detect_batch(frames)

    server.detector = types.SimpleNamespace(detect_batch=detect_batch)
    path = os.path.join(tempfile.mkdtemp(prefix="busca_lockstep_"),
                        "ls.sock")
    check(len(path.encode()) < 100, f"socket path too long: {path}")
    results, errors = {}, []

    def connect():
        t0 = time.perf_counter()
        while True:
            try:
                return TrackingClient.connect_unix(path)
            except (FileNotFoundError, ConnectionRefusedError):
                check(time.perf_counter() - t0 < SV_CONNECT_S,
                      f"the lockstep server on {path} never came up")
                time.sleep(0.01)

    def client(i):
        try:
            c = connect()
            check(c.start(f"seq{i}")["ok"], f"stream {i}: start failed")
            out, blob = [], None
            t_first = time.perf_counter()
            for k, frame in enumerate(seqs[i]):
                if i == snapshot_stream and k == SL_CUT:
                    header, blob = c.snapshot()
                    check(header.get("frame_id") == SL_CUT,
                          f"stream {i}: snapshot at {header}")
                    c.stop()
                    c = connect()
                    r = c.restore(blob)
                    check(r.get("ok") and r.get("frame_id") == SL_CUT,
                          f"stream {i}: restore failed: {r}")
                r = c.frame(frame)
                check(r.get("ok"), f"stream {i} frame {k + 1}: "
                      f"{r.get('error')}")
                out.append(r)
            results[i] = (out, t_first, time.perf_counter(),
                          None if blob is None else len(blob))
            c.stop()
        except Exception as e:  # reported on the main thread
            errors.append(f"stream {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(seqs))]
    for t in threads:
        t.start()
    connections = len(seqs) + (snapshot_stream is not None)

    def serve():
        server.serve_unix(path, max_connections=connections)

    busy = None
    if profiled:
        busy = sum(device_kernels_ms(serve, 1, warmup=False).values())
    else:
        serve()
    for t in threads:
        t.join(timeout=120)
    check(not errors, "; ".join(errors))
    check(len(results) == len(seqs), "a client did not finish")
    replies = [results[i][0] for i in range(len(seqs))]
    wall_s = (max(r[2] for r in results.values())
              - min(r[1] for r in results.values()))
    blob = next((r[3] for r in results.values() if r[3]), None)
    return replies, ticks, wall_s, busy, blob


def phase_lockstep_server(det, engine, lockstep, served_ms):
    """13b: phase 12's sequences served by the lockstep server behind phase
    7's YOLOX-X, ByteTrack + BUSCA (``engine``, bf16): each stream equals
    its own in-process pipelined loop (ids relabelled, tlwh within
    LS_BOX_PX); most ticks hold every active stream; a stream snapshotted
    after SL_CUT frames and restored over a new connection equals its
    unbroken loop.  Returns the served replies and K1's launches over the
    timed run."""
    from busca_tpu_torch.eval.run import make_tracker
    from busca_tpu_torch.ops.crop_cuda import crop_resize_cuda
    from busca_tpu_torch.trackers.base import Track

    seqs, solos = lockstep["seqs"], lockstep["solo"]
    kwargs = {"use_busca": True, "track_thresh": YX_TRACK_THRESH,
              "use_camera_motion_compensation": False}

    def factory():
        return make_tracker("byte", kwargs, engine, CROP_HW)

    total = sum(len(s) for s in seqs)
    Track.reset_id_counter()
    crop_resize_cuda.launches = 0
    replies, ticks, wall_s, _, _ = serve_lockstep(det, factory, seqs)
    k1 = crop_resize_cuda.launches
    worst = max(relabelled_gap(
        f"lockstep server stream {i}", reply_rows(got),
        [(f, t, ids) for f, t, ids, _ in solo.results])
        for i, (got, solo) in enumerate(zip(replies, solos)))
    check(worst <= LS_BOX_PX, f"the lockstep server is off by {worst} px")
    full = sum(1 for b, active in ticks if b == active)
    print(f"lockstep server ({len(seqs)} streams of {[len(s) for s in seqs]}"
          f" frames at {FRAME_HW[0]}x{FRAME_HW[1]}, tick timeout "
          f"{SL_TICK_S * 1e3:.0f} ms): each stream equals its in-process "
          f"pipelined loop (ids relabelled, tlwh max |diff| {worst:.3g} px); "
          f"ticks (batch, active streams) {ticks}: {full} of {len(ticks)} "
          f"hold every active stream; K1 launches {k1}")
    check(full * 2 > len(ticks), f"the ticks did not coalesce: {ticks}")
    Track.reset_id_counter()
    _, _, prof_wall_s, busy, _ = serve_lockstep(det, factory, seqs,
                                                profiled=True)
    ms = wall_s * 1e3 / total
    print(f"lockstep server: {ms:.2f} ms per sequence-frame ({total} "
          f"sequence-frames in {wall_s * 1e3:.1f} ms, first frame sent to "
          f"last reply) against {lockstep['lock_ms']:.2f} for phase 12's "
          f"in-process lockstep and {served_ms:.2f} ms/frame for phase 10's "
          f"sequential server (one stream, frames 2 on); device busy "
          f"{busy:.1f} ms, idle {100 * (1 - busy / (wall_s * 1e3)):.1f}% "
          f"of the timed run (the profiled run took "
          f"{prof_wall_s * 1e3:.1f} ms)")
    Track.reset_id_counter()
    snap, _, _, _, blob = serve_lockstep(det, factory, seqs,
                                         snapshot_stream=0)
    gap = relabelled_gap(
        "restored lockstep stream", reply_rows(snap[0]),
        [(f, t, ids) for f, t, ids, _ in solos[0].results])
    check(gap <= LS_BOX_PX, f"the restored stream is off by {gap} px")
    print(f"lockstep server: stream 0 snapshotted after frame {SL_CUT} "
          f"({blob} bytes, signed), restored over a new connection: equals "
          f"its unbroken loop (tlwh max |diff| {gap:.3g} px)")
    check(sum(len(r["tracks"]) for rs in replies for r in rs) > 0,
          "the lockstep server output no track")
    return replies, k1


def alternating_ms(fns, rounds=None, reps=5):
    """ms per call of each callable (:func:`cuda_time_ms`, ``reps`` calls)
    in each of ``rounds`` rounds (ART_ROUNDS) that take them in turn: a
    host-bound step's time drifts with the shared host's load, and
    alternating keeps each comparison within one stretch of time.  Returns
    the rounds' times per callable."""
    times = {k: [] for k in fns}
    for _ in range(rounds or ART_ROUNDS):
        for key, fn in fns.items():
            times[key].append(cuda_time_ms(fn, reps=reps, warmup=1))
    return times


def live_step(det, frame):
    """The live step over one device frame: the letterbox, the step and its
    outputs in the exported program's order."""
    canvas, _ = det.prep(frame)
    rows, valid, converged, pred = det.step(canvas)
    return rows, valid, converged, canvas, pred


def phase_artifacts(det, engine, lockstep, served_replies):
    """13c: phase 7's YOLOX-X step exported at 1080x1920 (baked) and a
    batch family at ART_BATCHES (unbaked), both loaded: the program holds
    the crop op and its outputs equal the live step's bit for bit; 20
    frames of ``ArtifactDetector`` through the pipelined loop equal the
    live loop; the lockstep server behind ``ArtifactBatchDetector`` equals
    13b's replies; export and load seconds, bytes, and the program's time
    against the live step's in float32 and bf16 (its rows equal the live
    bf16 step's).  Returns K1's launches in the artifact loop and the
    artifact lockstep server."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    from busca_tpu_torch.eval.detector import YoloxDetector
    from busca_tpu_torch.eval.run import make_tracker
    from busca_tpu_torch.ops.crop_cuda import crop_resize_cuda
    from busca_tpu_torch.serve.detector import (
        ArtifactBatchDetector,
        ArtifactDetector,
    )
    from busca_tpu_torch.serve.export import (
        export_detector_batch_steps,
        export_detector_step,
        load_artifact,
    )
    from busca_tpu_torch.trackers.base import Track

    frames = yolox_frames(YX_FRAMES)
    root = tempfile.mkdtemp(prefix="busca_artifacts_")
    out = {}
    try:
        dirs = {k: os.path.join(root, k) for k in ("step", "family",
                                                     "bf16")}
        t0 = time.perf_counter()
        m_step = export_detector_step(det, FRAME_HW, dirs["step"])
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        m_fam = export_detector_batch_steps(det, FRAME_HW, ART_BATCHES,
                                            dirs["family"],
                                            bake_weights=False)
        fam_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        art = load_artifact(dirs["step"], device=det.device)
        load_s = time.perf_counter() - t0
        state = dict(det.model.state_dict())
        t0 = time.perf_counter()
        fam = ArtifactBatchDetector(dirs["family"], variables=state,
                                    device=det.device)
        fam_load_s = time.perf_counter() - t0
        print(f"artifacts: the YOLOX-X step at {FRAME_HW[0]}x{FRAME_HW[1]} "
              f"exported (baked) in {export_s:.2f} s, {m_step['size_bytes']} "
              f"bytes, loaded in {load_s:.2f} s; the batch family "
              f"{list(ART_BATCHES)} (unbaked) exported in {fam_s:.2f} s, "
              f"bytes {m_fam['size_bytes']}, loaded in {fam_load_s:.2f} s")
        nodes = [str(n.target) for n in art.program.graph.nodes
                 if n.op == "call_function"]
        check(nodes.count("busca_tpu_torch.crop_resize.default") == 1,
              "the exported step does not hold the crop op once")
        convs = [n for n in art.program.graph.nodes
                 if str(n.target) == "aten._convolution.default"]
        check(convs and all(n.args[11] is False for n in convs),
              "the exported float32 YOLOX convolves through cuDNN")
        other = "cpu" if det.device.type == "cuda" else "cuda"
        try:
            load_artifact(dirs["step"], device=other)
            check(False, f"an artifact exported on {det.device.type} "
                  f"loaded on {other}")
        except ValueError as e:
            print(f"artifacts: loading it on {other} is refused: {e}")

        frame = torch.from_numpy(frames[0]).to(det.device)
        with torch.no_grad():
            launches = crop_resize_cuda.launches
            got = art.call(frame)
            check(crop_resize_cuda.launches == launches + 1,
                  "the program did not launch K1 once")
            want = live_step(det, frame)
        torch.cuda.synchronize()
        for name, g, w in zip(("rows", "valid", "converged", "canvas",
                               "pred"), got, want):
            check(g.shape == w.shape and g.dtype == w.dtype
                  and bool(torch.equal(g, w)),
                  f"the artifact's {name} differ from the live step's")
        print(f"artifacts: the program's {len(convs)} convolutions are "
              f"aten._convolution with cuDNN off; its rows, valid, "
              f"converged, canvas and decoded rows equal the live step's "
              f"bit for bit")

        live = yolox_loop(det, engine, frames)
        adet = ArtifactDetector(art, device=det.device)
        crop_resize_cuda.launches = 0
        served = yolox_loop(adet, engine, frames)
        out["artifact_loop"] = crop_resize_cuda.launches
        check(loop_replies(served) == loop_replies(live),
              "the artifact loop differs from the live loop")
        check(out["artifact_loop"] >= len(frames),
              "K1 launched under once per frame in the artifact loop")
        total, det_ms, trk_ms = loop_split(served)
        ltotal, ldet, ltrk = loop_split(live)
        print(f"artifacts: {len(frames)} frames of ArtifactDetector through "
              f"the pipelined loop equal the live loop; {total:.2f} ms/frame "
              f"(detector {det_ms:.2f}, tracker {trk_ms:.2f}) against "
              f"{ltotal:.2f} ({ldet:.2f}, {ltrk:.2f}); K1 launches "
              f"{out['artifact_loop']}")

        def factory():
            return make_tracker("byte", {
                "use_busca": True, "track_thresh": YX_TRACK_THRESH,
                "use_camera_motion_compensation": False}, engine, CROP_HW)

        Track.reset_id_counter()
        crop_resize_cuda.launches = 0
        replies, ticks, wall_s, _, _ = serve_lockstep(fam, factory,
                                                      lockstep["seqs"])
        out["artifact_lockstep"] = crop_resize_cuda.launches
        worst = 0.0
        for i, (got_r, want_r) in enumerate(zip(replies, served_replies)):
            worst = max(worst, relabelled_gap(
                f"artifact lockstep stream {i}", reply_rows(got_r),
                reply_rows(want_r)))
        check(worst <= LS_BOX_PX, f"the artifact lockstep server is off by "
              f"{worst} px")
        n = sum(len(s) for s in lockstep["seqs"])
        print(f"artifacts: the lockstep server behind ArtifactBatchDetector "
              f"equals the live lockstep server (ids relabelled, tlwh max "
              f"|diff| {worst:.3g} px); ticks {ticks}; "
              f"{wall_s * 1e3 / n:.2f} ms per sequence-frame; K1 launches "
              f"{out['artifact_lockstep']}")

        with torch.no_grad():
            launches = crop_resize_cuda.launches
            live_busy = device_busy_ms(lambda: live_step(det, frame))
            art_busy = device_busy_ms(lambda: art.call(frame))
            cfg16 = dataclasses.replace(det.config, dtype="bfloat16")
            det16 = YoloxDetector(cfg16, state, test_size=det.test_size,
                                  conf_thresh=det.conf_thresh,
                                  device=det.device)
            export_detector_step(det16, FRAME_HW, dirs["bf16"],
                                 bake_weights=False)
            art16 = load_artifact(dirs["bf16"], device=det.device)
            got = art16.call(state, frame)
            want = live_step(det16, frame)
            torch.cuda.synchronize()
            check(all(bool(torch.equal(g, w)) for g, w in zip(got, want)),
                  "the bf16 artifact differs from the live bf16 step")
            times = alternating_ms({
                "live": lambda: live_step(det, frame),
                "program": lambda: art.call(frame),
                "live16": lambda: live_step(det16, frame),
                "program16": lambda: art16.call(state, frame)})
            crop_resize_cuda.launches = launches

        def spread(key):
            t = times[key]
            return (f"{np.median(t):.2f} ms (rounds {min(t):.2f}-"
                    f"{max(t):.2f})")

        print(f"artifacts: the step with its letterbox at "
              f"{FRAME_HW[0]}x{FRAME_HW[1]}, back to back (CUDA events, "
              f"median of {ART_ROUNDS} alternating rounds): float32 "
              f"program {spread('program')}, device busy {art_busy:.2f}, "
              f"against the live step {spread('live')}, busy "
              f"{live_busy:.2f}; bf16 (unbaked) program "
              f"{spread('program16')} against {spread('live16')}; the bf16 "
              f"program's outputs equal the live bf16 step's bit for bit")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def phase_serving(det, engine, lockstep, served_ms):
    """Phase 13: the thread cost, the lockstep server and the artifacts
    (13a-c).  Returns K1's launches on the served and exported paths."""
    t0 = time.perf_counter()
    phase_thread_cost(det, engine, yolox_frames(TH_FRAMES))
    replies, k1 = phase_lockstep_server(det, engine, lockstep, served_ms)
    out = {"server_lockstep": k1}
    out.update(phase_artifacts(det, engine, lockstep, replies))
    print(f"phase 13: {time.perf_counter() - t0:.2f} s")
    return out


def write_mot_gt(directory, gt, frame_hw, n_frames):
    """A MOT sequence directory holding ``seqinfo.ini`` and ``gt/gt.txt``
    of ``gt`` ({frame: (tlwh, ids)}), without frames: the sampler is handed
    the rendered ones (the card host has no cv2 to decode JPEGs)."""
    os.makedirs(os.path.join(directory, "gt"), exist_ok=True)
    rows = [f"{f},{int(i)},{x:.2f},{y:.2f},{w:.2f},{h:.2f},1,1,1.0"
            for f in sorted(gt) for (x, y, w, h), i in zip(*gt[f])]
    with open(os.path.join(directory, "gt", "gt.txt"), "w") as fh:
        fh.write("\n".join(rows) + "\n")
    with open(os.path.join(directory, "seqinfo.ini"), "w") as fh:
        fh.write(f"[Sequence]\nname=crowd\nimDir=img1\nframeRate=30\n"
                 f"seqLength={n_frames}\nimWidth={frame_hw[1]}\n"
                 f"imHeight={frame_hw[0]}\nimExt=.jpg\n")


def train_flops(model, batch):
    """float32 operations of one training step: three times the forward's
    (the backward computes two products per forward product), the forward
    being the ReID's convolutions and linears on the batch's crops
    (:func:`reid_flops`), the encoder linear and the Transformer's
    products."""
    import torch

    cfg = model.config
    b, l = batch["mem_boxes"].shape[:2]
    c = batch["can_boxes"].shape[1]
    dev = next(model.parameters()).device
    crops = torch.cat([torch.as_tensor(batch["mem_crops"]).flatten(0, 1),
                       torch.as_tensor(batch["can_crops"]).flatten(0, 1)])
    fwd = reid_flops(model.reid_encoder.model, crops.to(dev))
    d, ff = cfg.trans_dim, cfg.ff_size
    s = l + 2 * (c + cfg.num_extra_candidates)  # tokens per episode
    fwd += 2 * b * (l + c) * cfg.dim_embedding * d
    fwd += cfg.num_layer * b * (2 * s * d * 3 * d + 2 * 2 * s * s * d
                                + 2 * s * d * d + 2 * 2 * s * d * ff)
    fwd += b * (c + cfg.num_extra_candidates) * 2 * d
    return 3 * fwd


def timed_train_step(step, batch, generator):
    """One train step timed with CUDA events: (metrics, ms)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    metrics = step(batch, generator)
    end.record()
    torch.cuda.synchronize()
    return metrics, start.elapsed_time(end)


def check_gradients_finite(model, label):
    import torch

    grads = [p.grad for p in model.parameters() if p.grad is not None]
    check(len(grads) > 0, f"{label}: no gradients")
    peak = torch.stack([g.abs().amax() for g in grads])
    check(bool(torch.isfinite(peak).all()), f"{label}: a gradient is not "
          "finite")


def train_episodes(device, crowd):
    """Phase 14's batches: MotEpisodeSampler over phase 8's crowd, its
    crops through K1.  Returns (sampler, batches, K1's launches)."""
    import tempfile

    import numpy as np

    from busca_tpu_torch.ops.crop_cuda import crop_resize_cuda
    from busca_tpu_torch.train.data import EpisodeSpec, MotEpisodeSampler

    _, frames, _, gt = crowd
    spec = EpisodeSpec()
    with tempfile.TemporaryDirectory(prefix="busca_train_") as tmp:
        seq_dir = os.path.join(tmp, "crowd")
        write_mot_gt(seq_dir, gt, FRAME_HW, len(frames))
        sampler = MotEpisodeSampler([seq_dir], spec, device=device)
    sampler._frame = lambda si, f: frames[f - 1]
    rng = np.random.RandomState(TR_SEED)
    crop_resize_cuda.launches = 0
    batches, ms = [], []
    for _ in range(TR_STEPS):
        t0 = time.perf_counter()
        batches.append(sampler.batch(rng))
        ms.append(1e3 * (time.perf_counter() - t0))
    k1 = crop_resize_cuda.launches
    boxes = spec.batch * (spec.seq_len + spec.num_candidates)
    print(f"train episodes: EpisodeSpec() batch {spec.batch}, seq_len "
          f"{spec.seq_len}, {spec.num_candidates} candidates, "
          f"{spec.crop_hw[0]}x{spec.crop_hw[1]} crops from the crowd "
          f"({len(sampler.seqs[0][2])} usable tracks); sampler "
          f"{float(np.median(ms)):.2f} ms per batch (median of "
          f"{TR_STEPS}; first {ms[0]:.2f}); K1 launches {k1} over "
          f"{TR_STEPS} batches, {k1 / TR_STEPS:.1f} per batch for up to "
          f"{boxes} boxes (one per sequence frame)")
    check(k1 > 0, "the episode sampler never launched K1")
    for b in batches:
        check(all(np.isfinite(v).all() for v in b.values()),
              "an episode batch is not finite")
    return sampler, batches, k1


def phase_train_full_width(device, batches):
    """14a: the full-width float32 step, its loss falling on a repeated
    batch, and one bf16 step from the same weights."""
    import dataclasses

    import numpy as np
    import torch

    from busca_tpu_torch.models.busca import BuscaConfig, BuscaModel
    from busca_tpu_torch.train.trainer import (
        make_optimizer,
        make_train_step,
        step_generator,
    )

    cfg = BuscaConfig()
    model = BuscaModel(cfg).to(device)
    model.init_weights(torch.Generator().manual_seed(TR_SEED))
    n_params = sum(p.numel() for p in model.parameters())
    step = make_train_step(model, make_optimizer(model.parameters()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for i, b in enumerate(batches):
        m, ms = timed_train_step(step, b, step_generator(TR_SEED, i, device))
        losses.append(float(m["loss"]))
        step_ms.append(ms)
        check(np.isfinite(losses[-1]), f"train step {i}: loss not finite")
        check_gradients_finite(model, f"train step {i}")
    peak = torch.cuda.max_memory_allocated()
    ms = float(np.median(step_ms[1:]))
    flops = train_flops(model, batches[0])
    print(f"train step on {card_name_and_limit()} (BuscaConfig(): "
          f"ResNet-50, d={cfg.trans_dim}, "
          f"{cfg.num_layer} layers, dropout {cfg.dropout_p}; "
          f"{n_params} parameters; float32): {ms:.2f} ms (CUDA events, "
          f"median of steps 2-{len(batches)}; the first {step_ms[0]:.2f}); "
          f"peak allocated {peak / 2**30:.2f} GiB; {flops / 1e12:.3f} "
          f"TFLOP per step, {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s, "
          f"{100 * flops / (ms * 1e-3) / FP32_PEAK_FLOPS:.1f}% of the "
          f"float32 peak; losses {[round(x, 4) for x in losses]}")
    by_kind = profile_step(
        lambda: step(batches[0], step_generator(TR_SEED, 99, device)), ms,
        reps=2, label="train step (float32)", top=5)
    busy = sum(by_kind.values())
    if busy:
        print(f"train step: device busy {busy:.2f} ms of {ms:.2f}, idle "
              f"{100 * (1 - busy / ms):.1f}%")

    rep = [float(step(batches[0], step_generator(TR_SEED, 1000,
                                                 device))["loss"])
           for _ in range(TR_REPEAT)]
    print(f"train step: one batch and mask {TR_REPEAT} times, losses "
          f"{[round(x, 4) for x in rep]}")
    check(all(np.isfinite(rep)) and rep[-1] < rep[0],
          "the loss did not fall on a repeated batch")

    model16 = BuscaModel(dataclasses.replace(cfg, dtype="bfloat16"))
    model16.load_state_dict(model.state_dict())
    model16.to(device)
    step16 = make_train_step(model16, make_optimizer(model16.parameters()))
    m16, ms16 = timed_train_step(step16, batches[1],
                                 step_generator(TR_SEED, 2000, device))
    m32, _ = timed_train_step(step, batches[1],
                              step_generator(TR_SEED, 2000, device))
    l16, l32 = float(m16["loss"]), float(m32["loss"])
    check_gradients_finite(model16, "bf16 train step")
    print(f"train step bf16: loss {l16:.5f} against float32 {l32:.5f} on "
          f"the same batch, weights and mask, |gap| {abs(l16 - l32):.5f} "
          f"(bound {TR_BF16_LOSS_TOL}); first call {ms16:.2f} ms")
    check(np.isfinite(l16), "the bf16 train step's loss is not finite")
    check(abs(l16 - l32) <= TR_BF16_LOSS_TOL,
          f"bf16 train loss {l16} vs float32 {l32}")
    return {"step_ms": ms, "peak_bytes": peak, "flops": flops,
            "busy_ms": busy}


def cpu_gradient_spread(cfg, state, batch, grads):
    """Per parameter, the most the CPU's own float32 gradients of one step
    move under evaluations that are as valid: the crops changed by 1e-7
    relative (TR_PERTURBATIONS seeds) and oneDNN off.  At the small config
    some ReLU and max decisions tie to float32's last bits, and each such
    evaluation flips a few (a 1e-7 change of the crops flips the same one
    as float64-accurate convolutions), moving a layer's gradient by two
    orders of magnitude more than the base bound (phase 14b prints the
    largest ratio)."""
    import numpy as np
    import torch

    from busca_tpu_torch.models.busca import BuscaModel
    from busca_tpu_torch.train.trainer import loss_fn

    model = BuscaModel(cfg)
    model.load_state_dict(state)
    model.train()

    def grads_of(b):
        model.zero_grad(set_to_none=True)
        loss_fn(model, b).backward()
        return {n: p.grad.detach().clone() for n, p in
                model.named_parameters() if p.grad is not None}

    variants = []
    for seed in range(TR_PERTURBATIONS):
        rng = np.random.RandomState(seed)
        b = dict(batch)
        for k in ("mem_crops", "can_crops"):
            b[k] = (batch[k] * (1 + 1e-7 * rng.standard_normal(
                batch[k].shape))).astype(np.float32)
        variants.append(grads_of(b))
    with torch.backends.mkldnn.flags(enabled=False):
        variants.append(grads_of(batch))
    return {n: max((v[n] - g).abs().max().item() for v in variants)
            for n, g in grads.items()}


def phase_train_card_vs_cpu(device):
    """14b: one step at the small config on the card and on the CPU from
    the same weights and batch, dropout 0: the loss; each gradient within
    the larger of the base bound and twice the CPU's own float32 spread
    (:func:`cpu_gradient_spread`); the card's updated parameters against
    the CPU's optimizer run on the card's gradients.  The gradients once
    more with TF32 on (the card's default, which ``set_card_precision``
    turns off) must exceed that bound: the widened bound still catches a
    product at the wrong precision."""
    import numpy as np
    import torch

    from busca_tpu_torch.models.busca import BuscaConfig, BuscaModel
    from busca_tpu_torch.train.data import EpisodeSpec, synthetic_batch
    from busca_tpu_torch.train.trainer import (
        loss_fn,
        make_optimizer,
        make_train_step,
    )
    from busca_tpu_torch.utils.device import set_card_precision

    cfg = BuscaConfig(**TR_SMALL)
    cpu = BuscaModel(cfg).init_weights(torch.Generator().manual_seed(
        TR_SEED))
    state = {k: v.clone() for k, v in cpu.state_dict().items()}
    card = BuscaModel(cfg)
    card.load_state_dict(state)
    card.to(device)
    batch = synthetic_batch(np.random.RandomState(TR_SEED),
                            EpisodeSpec(**TR_SMALL_SPEC))
    mc = make_train_step(cpu, make_optimizer(cpu.parameters()))(batch)
    mg = make_train_step(card, make_optimizer(card.parameters()))(batch)
    grads = {n: p.grad.detach().clone() for n, p in cpu.named_parameters()
             if p.grad is not None}
    spread = cpu_gradient_spread(cfg, state, batch, grads)

    def gap_ratios(model):
        out = {}
        for n, p in model.named_parameters():
            if n not in grads:
                check(p.grad is None, f"card vs CPU: {n} has a gradient on "
                      "the card only")
                continue
            base = TR_GRAD_RTOL * grads[n].abs().max().item() + TR_GRAD_ATOL
            out[n] = ((p.grad.cpu() - grads[n]).abs().max().item()
                      / max(base, 2 * spread[n]), spread[n] / base)
        return out

    ratio = gap_ratios(card)
    tf32_card = BuscaModel(cfg)
    tf32_card.load_state_dict(state)
    tf32_card.to(device)
    tf32_card.train()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        loss_fn(tf32_card, batch).backward()
        torch.cuda.synchronize()
    finally:
        set_card_precision()
    tf32_ratio = gap_ratios(tf32_card)
    # the card's AdamW update against the CPU's on the card's gradients
    ref = BuscaModel(cfg)
    ref.load_state_dict(state)
    for (n, pr), pg in zip(ref.named_parameters(), card.parameters()):
        pr.grad = None if pg.grad is None else pg.grad.cpu()
    opt = make_optimizer(ref.parameters())
    opt.step()
    lr = opt.param_groups[0]["lr"]
    update_gap = max(((pg.detach().cpu() - pr.detach()).abs()
                      / (1e-6 * pr.detach().abs() + 1e-3 * lr)).max().item()
                     for pr, pg in zip(ref.parameters(), card.parameters()))
    loss_gap = abs(float(mg["loss"]) - float(mc["loss"])) / abs(
        float(mc["loss"]))
    grad_worst = max(r for r, _ in ratio.values())
    for n in sorted(ratio, key=lambda k: -ratio[k][0])[:3]:
        print(f"train step card vs CPU: {n}: gradient gap "
              f"{ratio[n][0]:.3f} of its bound (the CPU's own spread "
              f"{ratio[n][1]:.2f} of the base bound)")
    print(f"train step card vs CPU ({TR_SMALL}, "
          f"{TR_SMALL_SPEC['crop_hw']} crops, batch "
          f"{TR_SMALL_SPEC['batch']}): loss {float(mg['loss']):.6f} vs "
          f"{float(mc['loss']):.6f} (relative {loss_gap:.2e}, bound 1e-5); "
          f"worst gradient gap {grad_worst:.3f} of its bound ("
          f"{sum(r > 1 for _, r in ratio.values())} of {len(ratio)} "
          f"parameters' CPU spread above the base bound, the largest "
          f"{max(r for _, r in ratio.values()):.1f} times it); the card's "
          f"update "
          f"against the CPU optimizer on its gradients {update_gap:.3f} of "
          f"1e-6 relative + 1e-3 lr")
    check(loss_gap <= 1e-5, "train loss card vs CPU")
    check(float(mg["accuracy"]) == float(mc["accuracy"]),
          "train accuracy card vs CPU")
    tf32_worst = max(tf32_ratio, key=lambda k: tf32_ratio[k][0])
    print(f"train step card vs CPU with TF32 on: worst gradient gap "
          f"{tf32_ratio[tf32_worst][0]:.3f} of its bound ({tf32_worst}; "
          f"{sum(r > 1 for r, _ in tf32_ratio.values())} of "
          f"{len(tf32_ratio)} parameters above their bound)")
    check(grad_worst <= 1.0, "gradients card vs CPU")
    check(update_gap <= 1.0, "the card's AdamW update")
    check(tf32_ratio[tf32_worst][0] > 1.0,
          "TF32's gradients are within the card-vs-CPU bound")


def phase_train_resume(device, batches):
    """14c: save after TR_RESUME_K full-width steps, restore on a fresh
    model and optimizer, and step on beside the unbroken run, with cuDNN's
    deterministic algorithms (its default backward-weight algorithms are
    not bit-reproducible)."""
    import tempfile

    import torch

    from busca_tpu_torch.models.busca import BuscaConfig, BuscaModel
    from busca_tpu_torch.models.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
        train_state,
    )
    from busca_tpu_torch.train.trainer import (
        make_optimizer,
        make_train_step,
        step_generator,
    )

    def fresh(seed):
        model = BuscaModel(BuscaConfig()).to(device)
        model.init_weights(torch.Generator().manual_seed(seed))
        opt = make_optimizer(model.parameters())
        return model, opt, make_train_step(model, opt)

    def run(step, first, n):
        return [float(step(batches[i], step_generator(TR_SEED, i,
                                                      device))["loss"])
                for i in range(first, first + n)]

    k = TR_RESUME_K
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        ma, oa, sa = fresh(TR_SEED)
        run(sa, 0, k)
        with tempfile.TemporaryDirectory(prefix="busca_ckpt_") as ck:
            t0 = time.perf_counter()
            path = save_checkpoint(ck, train_state(ma, oa, k), k)
            save_s = time.perf_counter() - t0
            size = os.path.getsize(path)
            unbroken = run(sa, k, 2)
            mb, ob, sb = fresh(TR_SEED + 1)
            t0 = time.perf_counter()
            state = restore_checkpoint(ck)
            mb.load_state_dict(state["params"])
            ob.load_state_dict(state["opt_state"])
            load_s = time.perf_counter() - t0
        resumed = run(sb, state["step"], 2)
        gaps = [(a - b).abs().max().item() for a, b in
                zip(ma.state_dict().values(), mb.state_dict().values())
                if a.is_floating_point()]
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    print(f"train resume (full width, cuDNN deterministic): checkpoint "
          f"{size} bytes, saved in {save_s:.2f} s, restored in "
          f"{load_s:.2f} s; losses after step {k}: unbroken {unbroken}, "
          f"resumed {resumed}; parameters' max |diff| {max(gaps):.3e}")
    check(resumed == unbroken and max(gaps) == 0.0,
          "the resumed run differs from the unbroken one")


def aflink_split_rows():
    """tests/test_aflink.py:65-88's rows: identity A split into ids 1 and 2
    by a 6-frame gap, identity B far away and overlapping in time."""
    import numpy as np

    rows = [[f, 1, 100 + 3.0 * f, 50 + 1.0 * f, 40, 90, 1, -1, -1, -1]
            for f in range(1, 21)]
    rows += [[f, 2, 100 + 3.0 * f, 50 + 1.0 * f, 40, 90, 1, -1, -1, -1]
             for f in range(27, 46)]
    rows += [[f, 7, 900 - 2.0 * f, 700, 40, 90, 1, -1, -1, -1]
             for f in range(1, 46)]
    return np.asarray(rows, np.float64)


def phase_train_demo(device):
    """14d: the trained-rescue demo and AFLink's synthetic training on the
    card, held to busca_tpu's bars.  Returns K1's launches on the rescue
    run."""
    import numpy as np

    from busca_tpu_torch.models.aflink import train_aflink_synthetic
    from busca_tpu_torch.ops.crop_cuda import crop_resize_cuda
    from busca_tpu_torch.trackers.postprocess import aflink
    from busca_tpu_torch.train.demo import (
        run_trained_rescue,
        train_demo_model,
    )

    t0 = time.perf_counter()
    cfg, model, metrics = train_demo_model(device=device)
    train_s = time.perf_counter() - t0
    crop_resize_cuda.launches = 0
    t0 = time.perf_counter()
    out = run_trained_rescue(cfg, model)
    rescue_s = time.perf_counter() - t0
    k1 = crop_resize_cuda.launches
    summary = {tag: {k: round(v, 4) if isinstance(v, float) else v
                     for k, v in m.items() if k != "results"}
               for tag, m in out.items()}
    print(f"trained rescue: train_demo_model {train_s:.2f} s (accuracy "
          f"{metrics['accuracy']:.3f}, loss {metrics['loss']:.4f}), "
          f"run_trained_rescue {rescue_s:.2f} s, K1 launches {k1}: "
          f"{summary}")
    check(metrics["accuracy"] > 0.6, "the demo model did not learn")
    check(out["base"]["mota"] > 0.6, "the base tracker's MOTA")
    check(out["busca"]["mota"] >= out["base"]["mota"] - 1e-9,
          "the trained engine hurt the tracker")
    check(out["busca"]["ids"] == 0, "identity switches with BUSCA")
    check(k1 > 0, "the rescue run never launched K1")

    t0 = time.perf_counter()
    link, acc = train_aflink_synthetic(steps=150, batch=64, device=device)
    link_s = time.perf_counter() - t0
    linked = aflink(aflink_split_rows(), model=link)
    tail = np.unique(linked[(linked[:, 0] >= 27) & (linked[:, 2] < 500), 1])
    ids = np.unique(linked[:, 1])
    print(f"AFLink synthetic training: 150 steps of 64 in {link_s:.2f} s, "
          f"accuracy {acc:.3f}; linked ids {ids.tolist()}")
    check(acc > 0.8, f"AFLink's synthetic training: accuracy {acc}")
    check(tail.tolist() == [1.0] and 7.0 in ids and 2.0 not in ids,
          "the trained linker did not merge the split trajectory")
    return k1


def phase_training(device, crowd):
    """Phase 14: training (a-d).  Returns K1's launches on the episode
    sampler's and the rescue demo's paths, the batches and 14a's step
    ms."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    _, batches, k1_train = train_episodes(device, crowd)
    full = phase_train_full_width(device, batches)
    torch.cuda.empty_cache()
    phase_train_card_vs_cpu(device)
    phase_train_resume(device, batches)
    torch.cuda.empty_cache()
    k1_rescue = phase_train_demo(device)
    print(f"phase 14: {time.perf_counter() - t0:.2f} s")
    return ({"train_episodes": k1_train, "trained_rescue": k1_rescue},
            batches, full["step_ms"])


# ---------------------------------------------------------------------------
# Phase 15: frozen-stats ReID (reid_stats='frozen'|'auto').


def frozen_engines(device, crowd):
    """The full-width frozen engines (float32 and bf16 ``frozen``, bf16
    ``auto``) from ``build_engine`` with seed 0 (phase 4's weights), their
    running statistics calibrated by ``calibrate_batch_stats`` on crops K1
    cuts from phase 8's crowd (the float32 model's batch statistics, loaded
    into all three)."""
    import numpy as np

    from busca_tpu_torch.eval.frozen_delta import calibrate_batch_stats
    from busca_tpu_torch.eval.run import build_engine
    from busca_tpu_torch.trackers.base import device_crops

    engines = {}
    for tag, dtype, mode in (("fz32", "float32", "frozen"),
                             ("fz16", "bfloat16", "frozen"),
                             ("auto16", "bfloat16", "auto")):
        engines[tag], _ = build_engine(device=device, crop_hw=CROP_HW,
                                       seed=0, dtype=dtype, reid_stats=mode)
        check(engines[tag].bank is None and engines[tag]._feat_bank,
              f"{tag}: a crop bank beside the feature bank")
    _, frames, dets, _ = crowd
    fz32 = engines["fz32"]
    batches = [fz32._prep(device_crops(frames[t], dets[t][0], CROP_HW,
                                       device), True)
               for t in FZ_CALIB_FRAMES]
    t0 = time.perf_counter()
    stats = calibrate_batch_stats(fz32.model, batches)
    for eng in engines.values():
        buffers = dict(eng.model.named_buffers())
        for k, v in stats.items():
            buffers[k].copy_(v)
    var = np.concatenate([v.cpu().numpy() for k, v in stats.items()
                          if k.endswith("running_var")])
    print(f"frozen engines: running statistics of {len(stats) // 2} BNs "
          f"calibrated on {sum(len(b) for b in batches)} crowd crops in "
          f"{time.perf_counter() - t0:.2f} s (running_var "
          f"{var.min():.3g}..{var.max():.3g})")
    return engines


def count_encodes(engine):
    """Counts the crops each ``_encode_scatter`` call encodes into the
    returned list, padding rows (written to the scratch slot 0) left
    out."""
    calls = []
    inner = engine._encode_scatter

    def counted(crops, slots, *a):
        calls.append(int((slots != 0).sum()))
        return inner(crops, slots, *a)

    engine._encode_scatter = counted
    return calls


def fresh_candidates(request):
    """The request with new uids on its detection and Kalman crops: the
    next frame's candidates, the memories still cached."""
    import numpy as np

    from busca_tpu_torch.assoc.bank import next_uid, tag

    tracks, dets, kals = request
    for t in list(dets) + list(kals):
        t.images_mem[-1] = tag(np.asarray(t.images_mem[-1]), next_uid())
    return request


def host_and_device_ms(fn, prepare=None):
    """(median host ms of 5 synchronized calls, device busy ms per call):
    ``prepare()`` runs before each call, outside the timing."""
    import numpy as np
    import torch

    prepare = prepare or (lambda: None)
    prepare()
    fn()
    times = []
    for _ in range(5):
        prepare()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)

    def one():
        prepare()
        fn()

    return float(np.median(times)), device_busy_ms(one)


def frozen_association(engines, engine16, frame):
    """15a: batch against frozen cold, warm and next-frame, and auto, host
    and device ms at phase 4's shape; encodes per call; busca_tpu's cache
    bars in float32; card against CPU."""
    import numpy as np
    import torch

    from busca_tpu_torch.assoc.engine import AssociationEngine

    n_tracks, n_dets = 16, 30
    fz32, fz16, auto16 = (engines[k] for k in ("fz32", "fz16", "auto16"))
    req = {tag: association_request(eng, np.random.RandomState(3), frame,
                                    n_tracks, n_dets)
           for tag, eng in engines.items()}
    batch_req = association_request(engine16, np.random.RandomState(3),
                                    frame, n_tracks, n_dets)
    prepped = engine16._prep_request(batch_req[0], batch_req[1],
                                     extra_kalman_candidates=batch_req[2])
    # batch mode encodes every memory crop and the unique candidates (and
    # the zero crop) on every call
    n_batch = n_tracks * engine16.seq_len + 1 + len(
        {d for row in prepped[3] for d in row if d is not None})

    def call(eng, request):
        tracks, dets, kals = request
        return eng.associate(tracks, dets, extra_kalman_candidates=kals,
                             select_highest_candidate=False)[0]

    # warmth: cold (empty bank) against warm, exactly, and encodes per call
    for tag in ("fz32", "fz16"):
        eng = engines[tag]
        calls = count_encodes(eng)
        eng._reset_bank()
        cold = call(eng, req[tag])
        n_cold = list(calls)
        warm = call(eng, req[tag])
        n_warm = calls[len(n_cold):]
        check(not n_warm, f"{tag}: the warm call encoded {n_warm}")
        check(np.array_equal(cold, warm), f"{tag}: warm differs from cold "
              f"by {np.abs(cold - warm).max()}")
        fresh_candidates(req[tag])
        call(eng, req[tag])
        n_next = calls[len(n_cold):]
        del eng._encode_scatter
        print(f"frozen {eng.config.dtype}: crops encoded per call: cold "
              f"{n_cold} (T={n_tracks} x {eng.seq_len} memories, the unique "
              f"candidates and the zero crop), warm {n_warm or [0]}, next "
              f"frame (new detection and Kalman crops) {n_next}, against "
              f"{n_batch} in batch mode; warm equals cold exactly")

    # busca_tpu's cache bars (tests/test_engine_frozen.py), float32
    def twin(**kw):
        return AssociationEngine(fz32.config, fz32.model,
                                 seq_len=fz32.seq_len, crop_hw=CROP_HW,
                                 reid_stats="frozen", **kw)

    fz32._reset_bank()
    want = call(fz32, req["fz32"])
    other = association_request(fz32, np.random.RandomState(4), frame,
                                n_tracks, n_dets)
    want_other = call(fz32, other)
    gaps = {}
    host = twin(feat_bank=False)
    gaps["host cache vs bank"] = max(
        np.abs(call(host, r) - w).max()
        for r, w in ((req["fz32"], want), (other, want_other),
                     (req["fz32"], want)))
    tiny = twin(feat_bank=False, feat_cache_slots=2)
    gaps["2-slot host cache"] = max(np.abs(call(tiny, req["fz32"]) - want)
                                    .max() for _ in range(2))
    distinct = n_tracks * fz32.seq_len + n_dets + n_tracks + 1
    small = twin(feat_cache_slots=distinct + 8)
    gaps[f"{distinct + 8}-slot bank"] = max(
        np.abs(call(small, r) - w).max()
        for r, w in ((req["fz32"], want), (other, want_other)) * 2)
    for label, gap in gaps.items():
        print(f"frozen float32 {label} against the default bank: max "
              f"|dp| {gap:.3g} (bar {FZ_PROB_TOL})")
        check(gap <= FZ_PROB_TOL, f"frozen {label} differs by {gap}")
    # one crop's feature in batches of 8 and of 256
    crops = np.stack([t.images_mem[0] for t in req["fz32"][0][:8]])
    big = np.concatenate([crops, np.zeros((248,) + crops.shape[1:],
                                          np.uint8)])
    feat_gap = float((fz32._encode(crops, True)
                      - fz32._encode(big, True)[:8]).abs().max())
    print(f"frozen float32 features of 8 crops encoded alone and in a "
          f"batch of 256: max |diff| {feat_gap:.3g}")

    # card against the CPU (phase 4's bound, float32)
    cpu_model = type(fz32.model)(fz32.model.config)
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               fz32.model.state_dict().items()})
    cpu = AssociationEngine(fz32.config, cpu_model.eval(),
                            seq_len=fz32.seq_len, crop_hw=CROP_HW,
                            reid_stats="frozen")
    tracks, dets, kals = req["fz32"]
    small_req = (tracks[:2], dets[:5], kals[:2])
    err = float(np.abs(call(fz32, small_req) - call(cpu, small_req)).max())
    print(f"frozen card vs CPU probabilities (float32, T=2, D=5): max|diff| "
          f"{err:.3g} (tol {PROB_TOL})")
    check(err <= PROB_TOL, f"frozen card and CPU disagree: {err}")

    # times: host clock and device busy, phase 4's shape
    rows = [("batch bf16", engine16, batch_req, None)]
    for tag, label in (("fz16", "bf16"), ("fz32", "float32")):
        eng = engines[tag]
        rows += [(f"frozen {label} cold", eng, req[tag], eng._reset_bank),
                 (f"frozen {label} warm", eng, req[tag], None),
                 (f"frozen {label} next frame", eng, req[tag],
                  lambda r=req[tag]: fresh_candidates(r))]
    rows.append(("auto bf16 next frame", auto16, req["auto16"],
                 lambda: fresh_candidates(req["auto16"])))
    times = {}
    for label, eng, request, prep in rows:
        times[label] = host_and_device_ms(lambda: call(eng, request), prep)
        print(f"association {label} T={n_tracks} D={n_dets} (+{n_tracks} "
              f"Kalman): {times[label][0]:.2f} ms host (median of 5), "
              f"device busy {times[label][1]:.2f} ms")
    torch.cuda.synchronize()
    return times


def frozen_crossover(engines, frame):
    """15b: auto's crossover on the card: the fused forward against the
    cached path (memories cached, new candidate crops each call), device
    ms per call at D=30, bf16."""
    import numpy as np

    from busca_tpu_torch.assoc.engine import AssociationEngine

    fz16 = engines["fz16"]
    fused_eng = AssociationEngine(fz16.config, fz16.model,
                                  seq_len=fz16.seq_len, crop_hw=CROP_HW,
                                  reid_stats="auto",
                                  auto_fused_max_t=10 ** 6)
    rows = []
    for t in FZ_CROSSOVER_T:
        request = association_request(fz16, np.random.RandomState(t), frame,
                                      t, 30)
        tracks, dets, kals = request

        def call(eng):
            return eng.associate(tracks, dets, extra_kalman_candidates=kals)

        fused = host_and_device_ms(lambda: call(fused_eng))[1]
        cached = host_and_device_ms(lambda: call(fz16),
                                    lambda: fresh_candidates(request))[1]
        rows.append((t, fused, cached))
        print(f"auto crossover T={t} D=30 (bf16): fused {fused:.2f} ms, "
              f"cached {cached:.2f} ms device per call")
    fused_wins = [t for t, f, c in rows if f < c]
    crossover = max(fused_wins) if fused_wins else 0
    print(f"auto crossover on the card: the fused forward wins at T <= "
          f"{crossover} (fused wins at {fused_wins}); AUTO_FUSED_MAX_T "
          f"stays 1 in code")
    return crossover


def frozen_loops(det, engines, engine16, lockstep):
    """15c and 15e: phase 7's YOLOX-X loop with BUSCA bf16 frozen against
    batch mode; phase 12's sequences in lockstep with frozen, each equal to
    its own frozen loop; the lockstep server with frozen, a stream
    snapshotted and restored; the detection AP of the loop's detections.
    Returns K1's launches per loop."""
    import numpy as np
    import torch

    from busca_tpu_torch.eval.detection import (
        coco_eval_full,
        format_coco_table,
    )
    from busca_tpu_torch.eval.detector import (
        track_frames_with_detector,
        track_sequences_lockstep,
    )
    from busca_tpu_torch.eval.run import make_tracker
    from busca_tpu_torch.eval.synthetic import (
        SyntheticSequence,
        default_dropout_sequence,
    )
    from busca_tpu_torch.ops.crop_cuda import crop_resize_cuda
    from busca_tpu_torch.trackers.base import Track

    fz16 = engines["fz16"]
    kwargs = {"use_busca": True, "track_thresh": YX_TRACK_THRESH,
              "use_camera_motion_compensation": False}
    frames = yolox_frames(YX_FRAMES)
    k1 = {}
    batch = yolox_loop(det, engine16, frames)
    Track.reset_id_counter()
    det_log = []
    crop_resize_cuda.launches = 0
    frozen = track_frames_with_detector(
        det, make_tracker("byte", kwargs, fz16, CROP_HW), frames,
        name="yolox", det_log=det_log)
    torch.cuda.synchronize()
    k1["yolox_frozen_loop"] = crop_resize_cuda.launches
    (b_ms, b_det, b_trk), (f_ms, f_det, f_trk) = (loop_split(batch),
                                                  loop_split(frozen))
    print(f"YOLOX-X loop, BUSCA bf16, {YX_FRAMES} frames: frozen "
          f"{f_ms:.2f} ms/frame (detector {f_det:.2f}, tracker {f_trk:.2f}) "
          f"against batch mode {b_ms:.2f} (detector {b_det:.2f}, tracker "
          f"{b_trk:.2f}); K1 launches {k1['yolox_frozen_loop']}")
    check(sum(len(r[2]) for r in frozen.results) > 0,
          "the frozen loop output no track")
    check(k1["yolox_frozen_loop"] > 0, "the frozen loop never launched K1")

    # 15e: the 12-number COCO table of the loop's raw detections
    base = default_dropout_sequence(40)
    seq = SyntheticSequence(base.objects, num_frames=base.num_frames,
                            height=FRAME_HW[0], width=FRAME_HW[1],
                            seed=base.seed)
    gt = seq.ground_truth()
    dets = {("yolox", fid): (boxes, scores)
            for fid, boxes, scores in det_log}
    gts = {}
    for fid in range(1, YX_FRAMES + 1):
        tlwh = gt.get(fid, (np.zeros((0, 4)),))[0].copy()
        tlwh[:, 2:] += tlwh[:, :2]
        gts[("yolox", fid)] = tlwh
    t0 = time.perf_counter()
    stats = coco_eval_full(dets, gts)
    print(f"--det-ap over phase 7's detections ({len(dets)} frames, "
          f"{sum(len(b) for b, _ in dets.values())} detections) against the "
          f"sequence's gt ({time.perf_counter() - t0:.3f} s):")
    print(format_coco_table(stats))
    check(all(np.isfinite(v) for v in stats.values()), "non-finite AP")

    # lockstep with frozen: each sequence equals its own frozen loop
    seqs = lockstep["seqs"]
    names = [f"seed{s}" for s in LS_SEEDS]
    solos = []
    for frames_i, name in zip(seqs, names):
        Track.reset_id_counter()
        solos.append(track_frames_with_detector(
            det, make_tracker("byte", kwargs, fz16, CROP_HW), frames_i,
            name=name))
    Track.reset_id_counter()
    crop_resize_cuda.launches = 0
    lock = track_sequences_lockstep(
        det, [make_tracker("byte", kwargs, fz16, CROP_HW) for _ in seqs],
        [iter(f) for f in seqs], names=names)
    torch.cuda.synchronize()
    k1["yolox_frozen_lockstep"] = crop_resize_cuda.launches
    worst = max(relabelled_gap(
        f"frozen lockstep {res.name}",
        [(f, t, ids) for f, t, ids, _ in res.results],
        [(f, t, ids) for f, t, ids, _ in solo.results])
        for res, solo in zip(lock, solos))
    check(worst <= LS_BOX_PX, f"frozen lockstep is off by {worst} px")
    total = sum(r.num_frames for r in lock)
    lock_ms = sum(r.track_time_s for r in lock) * 1e3 / total
    solo_ms = sum(r.track_time_s for r in solos) * 1e3 / total
    print(f"frozen lockstep ({len(seqs)} sequences, {total} sequence-frames):"
          f" each equals its own frozen loop (ids relabelled, tlwh max "
          f"|diff| {worst:.3g} px); {lock_ms:.2f} ms per sequence-frame "
          f"against {solo_ms:.2f} one by one (batch mode, phase 12: "
          f"{lockstep['lock_ms']:.2f}); K1 launches "
          f"{k1['yolox_frozen_lockstep']}")

    # the lockstep server with frozen; stream 0 snapshotted and restored
    def factory():
        return make_tracker("byte", kwargs, fz16, CROP_HW)

    Track.reset_id_counter()
    crop_resize_cuda.launches = 0
    replies, ticks, wall_s, _, blob = serve_lockstep(det, factory, seqs,
                                                     snapshot_stream=0)
    k1["server_frozen_lockstep"] = crop_resize_cuda.launches
    gap = max(relabelled_gap(
        f"frozen lockstep server stream {i}", reply_rows(got),
        [(f, t, ids) for f, t, ids, _ in solo.results])
        for i, (got, solo) in enumerate(zip(replies, solos)))
    check(gap <= LS_BOX_PX, f"the frozen lockstep server is off by {gap} px")
    print(f"frozen lockstep server: {len(seqs)} streams, stream 0 "
          f"snapshotted after frame {SL_CUT} ({blob} bytes) and restored: "
          f"every stream equals its own frozen loop (tlwh max |diff| "
          f"{gap:.3g} px); {wall_s * 1e3 / total:.2f} ms per sequence-frame;"
          f" K1 launches {k1['server_frozen_lockstep']}")
    return k1


def frozen_deviation_studies():
    """15d: the deviation studies' CLIs at their defaults on the card,
    ``python -m busca_tpu_torch.eval.frozen_delta --shift dim`` (in-domain
    and the ``dim`` arm on one trained model) and ``python -m
    busca_tpu_torch.eval.memcap_delta``, in two processes side by side:
    both are bound by the host (cv2's ECC of the trackers' camera-motion
    compensation), not by the card.  Their reports and seconds are
    printed; a failure or a run past FZ_STUDY_TIMEOUT_S fails the phase,
    and no process outlives it."""
    here = os.path.dirname(os.path.abspath(__file__))
    runs = {"frozen_delta": ["--shift", "dim"], "memcap_delta": []}
    t0 = time.perf_counter()
    # the host's cores split between the two; cv2's ECC on one thread
    # each (faster than on all cores there: tools/study_host_cost.py)
    env = dict(os.environ, OMP_NUM_THREADS=str(max(os.cpu_count() // 2, 1)),
               OPENCV_FOR_THREADS_NUM="1")
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"busca_tpu_torch.eval.{name}", *args],
        cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name, args in runs.items()}
    try:
        for name, proc in procs.items():
            left = FZ_STUDY_TIMEOUT_S - (time.perf_counter() - t0)
            try:
                out, _ = proc.communicate(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                check(False, f"{name} ran past {FZ_STUDY_TIMEOUT_S} s")
            for line in out.splitlines():
                if not line.startswith("{"):  # the JSON record repeats it
                    print(f"{name}: {line}")
            print(f"{name}: exit {proc.returncode} after "
                  f"{time.perf_counter() - t0:.2f} s")
            check(proc.returncode == 0, f"{name} failed")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def phase_frozen(device, engine16, det, lockstep, crowd):
    """Phase 15: frozen-stats ReID on the card.  Returns K1's launches per
    frozen loop."""
    import numpy as np

    t0 = time.perf_counter()
    engines = frozen_engines(device, crowd)
    rng = np.random.RandomState(2)
    frame = rng.randint(0, 256, FRAME_HW + (3,), dtype=np.uint8)
    frozen_association(engines, engine16, frame)
    frozen_crossover(engines, frame)
    k1 = frozen_loops(det, engines, engine16, lockstep)
    frozen_deviation_studies()
    print(f"phase 15: {time.perf_counter() - t0:.2f} s")
    return k1


# ---------------------------------------------------------------------------
# Phase 16: the dp x tp mesh on a one-rank NCCL group (item 23).

MESH_STEPS = 3
ECC_ITERS = 50  # busca_tpu's default
ECC_CPU_ITERS = 10  # the card-vs-CPU check (the CPU's solve takes seconds)
ECC_SIZES = ((800, 1440), (1080, 1920))
ECC_CASES = (("shift", 0.0, 2.5, -2.0), ("rotation", 0.01, 3.0, 2.0))
ECC_CV2_TOL = 0.25  # tests/test_ecc.py:74's bar, warp entries
ECC_CARD_CPU_TOL = 1e-3  # the same float32 sums in another order
ECC_TRACK_TOL = 1e-5  # the same solve on the same card, called twice
VIZ_FRAMES = 5


def mesh_train_step(device, mesh, batches, phase14_ms):
    """16a: ``make_sharded_train_step`` on the full-width model against
    ``make_train_step`` from the same weights, batch and generators, with
    cuDNN's deterministic algorithms: losses and parameters bit for
    bit."""
    import torch

    from busca_tpu_torch.models.busca import BuscaConfig, BuscaModel
    from busca_tpu_torch.parallel.mesh import gather_state_dict
    from busca_tpu_torch.train.trainer import (
        make_optimizer,
        make_sharded_train_step,
        make_train_step,
        step_generator,
    )

    def fresh():
        model = BuscaModel(BuscaConfig()).to(device)
        model.init_weights(torch.Generator().manual_seed(TR_SEED))
        return model

    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        plain_model, mesh_model = fresh(), fresh()
        plain = make_train_step(plain_model,
                                make_optimizer(plain_model.parameters()))
        sharded, _ = make_sharded_train_step(mesh_model, mesh)
        losses, ms = {"plain": [], "mesh": []}, {"plain": [], "mesh": []}
        for i in range(MESH_STEPS):
            for tag, step in (("plain", plain), ("mesh", sharded)):
                m, t = timed_train_step(step, batches[0],
                                        step_generator(TR_SEED, i, device))
                losses[tag].append(float(m["loss"]))
                ms[tag].append(t)
        whole = gather_state_dict(mesh_model, mesh)
        gaps = [float((p - whole[n]).abs().max())
                for n, p in plain_model.state_dict().items()
                if p.is_floating_point()]
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    print(f"mesh train step (BuscaConfig(), one EpisodeSpec() batch, "
          f"{MESH_STEPS} steps, dropout 0.1, cuDNN deterministic, NCCL "
          f"world 1, mesh dp=1 x tp=1): losses {losses['mesh']} against "
          f"make_train_step's {losses['plain']}; parameters' max |diff| "
          f"{max(gaps):.3e}; step {ms['mesh'][-1]:.2f} ms against "
          f"{ms['plain'][-1]:.2f} unsharded (CUDA events, the last step; "
          f"{card_name_and_limit()}) and phase 14's {phase14_ms:.2f} ms "
          f"(cuDNN's default algorithms)")
    check(losses["mesh"] == losses["plain"] and max(gaps) == 0.0,
          "the sharded step differs from the unsharded one")


def mesh_lockstep(det, engine16, lockstep):
    """16b: ``--lockstep-dp 1`` (the detector split over
    ``local_devices(1)``) over phase 12's sequences: each sequence's rows
    equal to phase 12's lockstep output (0 px).  Returns K1's launches."""
    import copy

    import numpy as np
    import torch

    import busca_tpu_torch.trackers.base as tbase
    from busca_tpu_torch.eval.detector import track_sequences_lockstep
    from busca_tpu_torch.eval.run import make_tracker
    from busca_tpu_torch.ops.crop_cuda import crop_resize_cuda
    from busca_tpu_torch.parallel.mesh import local_devices

    split = copy.copy(det).shard_lockstep(local_devices(1, "cuda"))
    seqs = lockstep["seqs"]
    kwargs = {"use_busca": True, "track_thresh": YX_TRACK_THRESH,
              "use_camera_motion_compensation": False}
    tbase.Track.reset_id_counter()
    trackers = [make_tracker("byte", kwargs, engine16, CROP_HW)
                for _ in seqs]
    torch.cuda.synchronize()
    crop_resize_cuda.launches = 0
    out = track_sequences_lockstep(split, trackers, [iter(f) for f in seqs],
                                   names=[r.name for r in lockstep["lock"]])
    torch.cuda.synchronize()
    k1 = crop_resize_cuda.launches
    worst = 0.0
    for got, want in zip(out, lockstep["lock"]):
        check(len(got.results) == len(want.results),
              f"{got.name}: {len(got.results)} frames")
        for (fa, ta, ia, _), (fb, tb, ib, _) in zip(got.results,
                                                    want.results):
            check(fa == fb and ia == ib, f"{got.name} frame {fa}: ids "
                  f"{ia} against phase 12's {ib}")
            if len(ta):
                worst = max(worst, float(np.abs(
                    np.reshape(ta, (-1, 4)) - np.reshape(tb, (-1, 4))).max()))
    lock_ms = 1e3 * sum(r.track_time_s for r in out) / sum(
        r.num_frames for r in out)
    print(f"--lockstep-dp 1 over phase 12's {len(seqs)} sequences: ids and "
          f"frames equal to phase 12's lockstep, tlwh max |diff| {worst} "
          f"px; {lock_ms:.2f} ms per sequence-frame against phase 12's "
          f"{lockstep['lock_ms']:.2f}; K1 launches {k1}")
    check(worst == 0.0, f"--lockstep-dp 1 tlwh off by {worst} px")
    check(k1 > 0, "the split lockstep never launched K1")
    return k1


def mesh_metrics(mesh):
    """16c: ``global_metrics`` and ``psum_tallies`` through NCCL against
    the local sums."""
    import numpy as np

    from busca_tpu_torch.eval.runner import (
        evaluate_sequence,
        global_metrics,
        metrics_to_tally,
        psum_tallies,
        run_sequence,
    )
    from busca_tpu_torch.eval.synthetic import default_dropout_sequence
    from busca_tpu_torch.trackers.byte import ByteTracker, ByteTrackerConfig

    per_seq = {}
    for i in range(4):
        seq = default_dropout_sequence(num_frames=30, seed=i)
        res = run_sequence(ByteTracker(ByteTrackerConfig(use_busca=False)),
                           [None] * seq.num_frames,
                           [seq.detections(t) for t in range(30)])
        per_seq[f"seq{i}"] = evaluate_sequence(res, seq.ground_truth())
    local = global_metrics(per_seq)
    reduced = global_metrics(per_seq, group=mesh.get_group("dp"))
    rows = np.stack([metrics_to_tally(m) for m in per_seq.values()])
    summed = psum_tallies(rows, mesh)
    print(f"global_metrics through NCCL: MOTA {reduced.mota:.6f}, IDF1 "
          f"{reduced.idf1:.6f} over {reduced.num_gt} gt boxes, equal to "
          f"the local sum: {reduced == local}; psum_tallies equal: "
          f"{bool(np.array_equal(summed, rows.sum(0)))}")
    check(reduced == local and np.array_equal(summed, rows.sum(0)),
          "the NCCL metric sum differs from the local one")


def phase_mesh(device, batches, phase14_ms, det, engine16, lockstep):
    """Phase 16: the mesh on a one-rank NCCL group (a local TCP store):
    (a) the sharded train step, (b) ``--lockstep-dp 1``, (c) the metric
    sum; with two or more cards, ``dryrun_multichip(2)`` over NCCL.
    Returns K1's launches on (b)."""
    import torch
    import torch.distributed as dist

    from busca_tpu_torch.parallel.dryrun import dryrun_multichip, free_port
    from busca_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        check(dist.get_backend() == "nccl", "the mesh's group is not NCCL")
        mesh = make_mesh(1)
        check(mesh.device_type == "cuda", "the mesh is not on the card")
        mesh_train_step(device, mesh, batches, phase14_ms)
        k1 = mesh_lockstep(det, engine16, lockstep)
        mesh_metrics(mesh)
    finally:
        dist.destroy_process_group()
    if torch.cuda.device_count() >= 2:
        print(dryrun_multichip(2))
    else:
        print("mesh: this host has one card; the multi-rank mesh (dp=2, "
              "tp=2) ran only over gloo in Tier-1 "
              "(tests/test_torch_{mesh,sharded_train,multiprocess_dp}.py)")
    print(f"phase 16: {time.perf_counter() - t0:.2f} s")
    return k1


# ---------------------------------------------------------------------------
# Phase 17: the device ECC, the online visualization, the debug montage and
# StageTimer (item 25).


def ecc_pair(h, w, theta, tx, ty, seed=17):
    """A textured uint8 BGR frame and its image under the Euclidean warp
    (theta, tx, ty), and the warp ECC should recover (cv2's convention:
    the inverse of the applied one)."""
    import cv2
    import numpy as np

    rng = np.random.RandomState(seed)
    small = rng.uniform(0, 255, (h // 8, w // 8)).astype(np.float32)
    tpl = cv2.GaussianBlur(cv2.resize(small, (w, h),
                                      interpolation=cv2.INTER_CUBIC),
                           (5, 5), 1.5)
    c, s = np.cos(theta), np.sin(theta)
    true = np.array([[c, -s, tx], [s, c, ty]], np.float32)
    img = cv2.warpAffine(tpl, true, (w, h),
                         flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)
    r_inv = np.linalg.inv(true[:, :2])
    want = np.concatenate([r_inv, (-r_inv @ true[:, 2])[:, None]], axis=1)

    def bgr(g):
        return np.repeat(np.clip(g, 0, 255).astype(np.uint8)[..., None], 3,
                         axis=2)

    return bgr(tpl), bgr(img), want


def phase_ecc(device):
    """17a: the device ECC (``ops/ecc.py``, 50 iterations) on the card at
    800x1440 and 1080x1920 on a shift and a small rotation: its warp
    against cv2's ``findTransformECC`` (the reference's 100 iterations,
    eps 1e-5) and the truth, against the CPU port at ECC_CPU_ITERS
    iterations, and ms per pair against cv2's on this host."""
    import numpy as np
    import torch

    from busca_tpu_torch.ops.ecc import ecc_euclidean, estimate_cmc, \
        rgb_to_gray
    from busca_tpu_torch.trackers.cmc import ecc_align

    out = {}
    for h, w in ECC_SIZES:
        for name, theta, tx, ty in ECC_CASES:
            prev, cur, want = ecc_pair(h, w, theta, tx, ty)
            rho, warp = estimate_cmc(prev, cur, ECC_ITERS, device=device)
            g1 = rgb_to_gray(torch.from_numpy(prev).to(device))
            g2 = rgb_to_gray(torch.from_numpy(cur).to(device))
            ms = cuda_time_ms(lambda: ecc_euclidean(g1, g2, ECC_ITERS),
                              reps=3, warmup=1)
            t0 = time.perf_counter()
            estimate_cmc(prev, cur, ECC_ITERS, device=device)
            host_ms = 1e3 * (time.perf_counter() - t0)
            cv_ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                cc, cv_warp = ecc_align(prev, cur)
                cv_ms.append(1e3 * (time.perf_counter() - t0))
            gap_cv = float(np.abs(warp - cv_warp).max())
            gap_true = float(np.abs(warp - want).max())
            line = (f"device ECC {h}x{w} {name}: rho {rho:.5f}, warp vs "
                    f"cv2's max |diff| {gap_cv:.4f} (bar {ECC_CV2_TOL}), vs "
                    f"the truth {gap_true:.4f}; {ms:.2f} ms per pair on the "
                    f"card (CUDA events, {ECC_ITERS} iterations, frames "
                    f"resident), {host_ms:.2f} ms from host frames; cv2 "
                    f"{float(np.median(cv_ms)):.2f} ms (median of 3, "
                    f"{ECC_ITERS * 2} iterations, eps 1e-5, cc {cc:.5f})")
            if name == "shift":
                _, cpu_warp = ecc_euclidean(g1.cpu(), g2.cpu(),
                                            ECC_CPU_ITERS)
                _, card_warp = ecc_euclidean(g1, g2, ECC_CPU_ITERS)
                gap_cpu = float((card_warp.cpu() - cpu_warp).abs().max())
                line += (f"; card vs CPU at {ECC_CPU_ITERS} iterations "
                         f"{gap_cpu:.2e} (bar {ECC_CARD_CPU_TOL})")
                check(gap_cpu <= ECC_CARD_CPU_TOL,
                      f"ECC {h}x{w}: card vs CPU {gap_cpu}")
            print(f"{line}; {card_name_and_limit()}")
            check(gap_cv <= ECC_CV2_TOL, f"ECC {h}x{w} {name}: off cv2 by "
                  f"{gap_cv}")
            out[(h, w, name)] = (ms, float(np.median(cv_ms)))
            if (h, w) == ECC_SIZES[0] and name == "shift":
                compensate_on_card(prev, cur, warp)
    return out


def compensate_on_card(prev, cur, warp):
    """``compensate_tracks(backend="device")`` as a tracker calls it, on
    host frames with no device named: the solve must run on the card (the
    card's peak allocation grows by at least the two float32 gray frames)
    and warp the track by ``estimate_cmc``'s warp on the card."""
    import numpy as np
    import torch

    from busca_tpu_torch.trackers.cmc import compensate_tracks

    class Warped:
        def __init__(self):
            self.warps = []

        def apply_camera_motion(self, w):
            self.warps.append(np.asarray(w))

    track = Warped()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cc = compensate_tracks([track], prev, cur, backend="device")
    ms = 1e3 * (time.perf_counter() - t0)
    grew = torch.cuda.max_memory_allocated() - base
    gray_bytes = 2 * prev.shape[0] * prev.shape[1] * 4
    gap = float(np.abs(track.warps[0] - warp).max())
    print(f"compensate_tracks(backend='device') on host frames "
          f"{prev.shape[0]}x{prev.shape[1]}: {ms:.2f} ms, cc {cc:.5f}, the "
          f"card's peak allocation grew {grew} B (two gray frames: "
          f"{gray_bytes} B), warp vs estimate_cmc on the card {gap:.2e}; "
          f"{card_name_and_limit()}")
    check(grew >= gray_bytes, f"compensate_tracks' device ECC allocated "
          f"{grew} B on the card: it did not solve there")
    check(gap <= ECC_TRACK_TOL, f"compensate_tracks' warp off "
          f"estimate_cmc's by {gap}")


def phase_viz(det, engine16):
    """17b: phase 7's YOLOX-X loop over VIZ_FRAMES frames around the
    dropout with ``viz_dir`` and an engine with ``debug_dir`` (one JPEG per
    frame, one montage per third-round call), then the same frames
    through a serial loop timed by ``StageTimer(sync=True)``."""
    import tempfile

    import cv2
    import numpy as np

    from busca_tpu_torch.assoc.engine import AssociationEngine
    from busca_tpu_torch.eval.detector import track_frames_with_detector
    from busca_tpu_torch.eval.run import make_tracker
    from busca_tpu_torch.eval.runner import write_viz_frame
    from busca_tpu_torch.eval.synthetic import default_dropout_sequence
    from busca_tpu_torch.trackers.base import Track
    from busca_tpu_torch.utils.profiling import StageTimer

    base = default_dropout_sequence(40)
    start = next(t for t in range(base.num_frames)
                 if not base.objects[0].detected_at(t)) - 3
    frames = yolox_frames(start + VIZ_FRAMES)[start:]
    kwargs = {"use_busca": True, "track_thresh": YX_TRACK_THRESH,
              "use_camera_motion_compensation": False}
    with tempfile.TemporaryDirectory(prefix="busca_viz_") as tmp:
        debug = os.path.join(tmp, "montage")
        engine = AssociationEngine(
            engine16.config, engine16.model, seq_len=engine16.seq_len,
            num_candidates=engine16.num_candidates, crop_hw=CROP_HW,
            buckets=engine16.buckets, debug_dir=debug)
        calls = [0]
        associate = engine.associate

        def counted(*a, **kw):
            calls[0] += 1
            return associate(*a, **kw)

        engine.associate = counted
        Track.reset_id_counter()
        viz = os.path.join(tmp, "viz")
        res = track_frames_with_detector(
            det, make_tracker("byte", kwargs, engine, CROP_HW), frames,
            name="viz", viz_dir=viz)
        in_loop = calls[0]
        # and one call of phase 4's kind (4 tracks, 8 detections), so a
        # montage is written whatever the random detector's loop did
        tracks, dets, kals = association_request(
            engine, np.random.RandomState(17), frames[0], 4, 8)
        engine.associate(tracks, dets, extra_kalman_candidates=kals)
        jpegs = sorted(os.listdir(viz))
        montages = sorted(os.listdir(debug)) if os.path.isdir(debug) else []
        shape = cv2.imread(os.path.join(viz, jpegs[0])).shape
        print(f"online visualization: {len(jpegs)} JPEGs of {shape} for "
              f"{res.num_frames} frames; {len(montages)} decision montages "
              f"for {calls[0]} third-round calls ({in_loop} in the loop), "
              f"the last {cv2.imread(os.path.join(debug, montages[-1])).shape}"
              if montages else "no montage")
        check(jpegs == [f"{i:06d}.jpg" for i in range(1, VIZ_FRAMES + 1)],
              f"viz files {jpegs}")
        check(len(montages) == calls[0] > in_loop,
              f"{len(montages)} montages for {calls[0]} third rounds")
        timer = StageTimer(sync=True)
        Track.reset_id_counter()
        tracker = make_tracker("byte", kwargs, engine16, CROP_HW)
        for i, frame in enumerate(frames):
            with timer("detect"):
                d = det.detect(frame)
            with timer("track"):
                online = tracker.update(d.boxes_tlbr / d.scale, d.scores,
                                        d.scale, d.image)
            with timer("viz"):
                write_viz_frame(os.path.join(tmp, "timed"), i + 1, d.image,
                                [t.tlwh for t in online],
                                [t.track_id for t in online], scale=d.scale)
    print("StageTimer(sync=True) over the serial loop:\n" + timer.report())


def phase_item25(device, det, engine16):
    """Phase 17: 17a the device ECC, 17b the visualization loop."""
    t0 = time.perf_counter()
    phase_ecc(device)
    phase_viz(det, engine16)
    print(f"phase 17: {time.perf_counter() - t0:.2f} s")


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
        k1["crops_yolox"] = phase_k1_canvas_crops(device, YX_TEST_SIZE,
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
        k1_yolox, yolox = phase_yolox(device, engine16)
        k1_ss, k1_ghost, crowd = phase_feature_trackers(device, engine16)
        t_phase = time.perf_counter()
        k1_ct, centertrack = phase_centertrack(device, engine16)
        k1_motdt = phase_alternates(device, crowd)
        print(f"phase 9: {time.perf_counter() - t_phase:.2f} s")
        t_phase = time.perf_counter()
        k1_served, k2_served, served_ms = phase_server(
            device, engine16, yolox, tc32, centertrack)
        print(f"phase 10: {time.perf_counter() - t_phase:.2f} s")
        k1_lockstep, lockstep = phase_lockstep(device, engine, engine16,
                                               yolox)
        k1_serving = phase_serving(yolox, engine16, lockstep, served_ms)
        k1_frozen = phase_frozen(device, engine16, yolox, lockstep, crowd)
        phase_item25(device, yolox, engine16)
        del tc32, centertrack
        t_phase = time.perf_counter()
        k1_deformable = phase_deformable(device, engine16)
        print(f"phase 11: {time.perf_counter() - t_phase:.2f} s")
        del engine
        k1_training, batches, train_ms = phase_training(device, crowd)
        k1_mesh = phase_mesh(device, batches, train_ms, yolox, engine16,
                             lockstep)
        del yolox, engine16, lockstep
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
                              "transcenter_deformable_loop": k1_deformable,
                              "yolox_lockstep": k1_lockstep,
                              **k1_serving,
                              **k1_frozen,
                              **k1_training,
                              "yolox_lockstep_dp1": k1_mesh}
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
