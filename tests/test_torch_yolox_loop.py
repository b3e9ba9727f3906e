"""The port's live YOLOX loop against busca_tpu's on the CPU.

A small YOLOX (depth 0.33, width 0.125, one class) with the port's seeded
weights calibrated on the sequence's frames
(``YoloxDetector.calibrate_random_weights``: BN statistics, obj and cls
biases, per-level wh biases of log(size / stride)), carried to busca_tpu
through ``convert_yolox_state_dict``:

- ``YoloxDetector`` on seeded 50x70 and 96x128 frames (windows of the
  sequence's): canvases equal but for <= 0.1% of values 1 LSB apart, where
  XLA's CPU resize blend lands a few ulp from the port's value across a .5
  rounding boundary (ROADMAP Queue 3); detection counts equal, boxes and
  scores within 1e-3;
- ``track_frames_with_detector`` with ByteTracker + BUSCA (the small engine
  of tests/test_torch_byte_pipeline.py) over the synthetic dropout sequence,
  pipelined in both packages: detections, ids and boxes equal per frame;
- the port's pipelined loop equal to its serial loop;
- both packages' ``--mot-dir`` CLI on a tiny MOT sequence written with cv2,
  from the same ``.pth``: the same results (frames and ids; boxes within
  the loop's tolerance) and CLEAR counts;
- busca_tpu's bfloat16 mode: the same loop with a designed tiny YOLOX
  (see BRIGHT_GAIN) and the BUSCA engines of tests/test_torch_bf16_loop.py
  in bf16 in both packages: detection counts, ids and boxes equal per
  frame, scores within BF16_SCORE_TOL, third-round probabilities within
  0.12.

The detector outputs agree to ~1e-6 (tests/test_torch_yolox.py), so the
loops could only diverge where a score sits within that noise of a
threshold; the loop test checks that none does on this seed.
"""

import os

import numpy as np
import pytest
import torch

from busca_tpu.eval import detector as jdetector
from busca_tpu.eval.synthetic import default_dropout_sequence
from busca_tpu.models.yolox import YoloxConfig as JConfig
from busca_tpu.models.yolox import convert_yolox_state_dict
from busca_tpu.trackers.base import Track as JTrack
from busca_tpu.trackers.byte import ByteTracker as JByte
from busca_tpu.trackers.byte import ByteTrackerConfig as JByteCfg
from busca_tpu_torch.eval import detector as tdetector
from busca_tpu_torch.models.yolox import YOLOX, YoloxConfig
from busca_tpu_torch.trackers.base import Track
from busca_tpu_torch.trackers.byte import ByteTracker, ByteTrackerConfig
from test_torch_bf16 import PROB_BAR, PROB_PIN
from test_torch_bf16_loop import bf16_engines  # noqa: F401
from test_torch_byte_pipeline import CROP_HW, engines  # noqa: F401

TINY = (0.33, 0.125, 1)
# not 64x96: busca_tpu's step aborts in XLA's CPU compiler when the resized
# frame fills the canvas (ROADMAP Queue 3), and the sequence is 256x384
TEST_SIZE = (64, 128)
CONF = 0.05
BOX_TOL = 1e-3
# canvases: at most this share of values 1 LSB apart (measured: 1 of 18,432
# at 96x128, none at 50x70)
CANVAS_LSB_SHARE = 1e-3
# the loop's boxes in frame pixels (4 per canvas pixel): those rare 1-LSB
# canvas values move the random model's boxes by up to ~0.03 frame pixels
LOOP_BOX_TOL = 0.1
N_FRAMES = 8
TRACKER_KW = dict(use_busca=True, crop_hw=CROP_HW, track_thresh=0.6,
                  busca_thresh=0.1, select_highest_candidate=False)
# every score threshold the loop applies: the detector's, BYTE's low
# bound, track_thresh and det_thresh = track_thresh + 0.1
THRESHOLDS = (CONF, 0.1, 0.6, 0.7)


def _frames(n=N_FRAMES):
    seq = default_dropout_sequence(40)
    # start before the dropout window, so that the third round runs
    start = next(t for t in range(seq.num_frames)
                 if not seq.objects[0].detected_at(t)) - 3
    return [seq.frame(t) for t in range(start, start + n)]


def calibrated_state(config, seed, frames, test_size, box_hw):
    """The port's seeded init, calibrated on ``frames`` (BN statistics,
    obj 1.0 and cls 1.0 biases, ~``box_hw`` canvas-pixel boxes), so that
    scores spread over 0.3-0.8."""
    det = tdetector.YoloxDetector(config, None, test_size=test_size,
                                  device="cpu", seed=seed)
    det.calibrate_random_weights(frames, 1.0, 1.0, box_hw)
    return det.model.state_dict()


@pytest.fixture(scope="module")
def detectors():
    d, w, c = TINY
    sd = calibrated_state(YoloxConfig(d, w, c), 21, _frames(), TEST_SIZE,
                          (28.0, 14.0))
    jcfg = JConfig(depth=d, width=w, num_classes=c)
    variables = convert_yolox_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jcfg)
    kw = dict(test_size=TEST_SIZE, conf_thresh=CONF, nms_thresh=0.7,
              max_outputs=32)
    jdet = jdetector.YoloxDetector(jcfg, variables, **kw)
    tdet = tdetector.YoloxDetector(YoloxConfig(d, w, c), sd, device="cpu",
                                   **kw)
    return jdet, tdet, sd


@pytest.mark.parametrize("hw", [(50, 70), (96, 128)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_detect_matches_jax(detectors, hw):
    jdet, tdet, _ = detectors
    # a seeded window of a sequence frame (the calibration's distribution)
    rng = np.random.RandomState(hw[0])
    full = _frames()[rng.randint(N_FRAMES)]
    y, x = rng.randint(0, full.shape[0] - hw[0]), rng.randint(
        0, full.shape[1] - hw[1])
    frame = np.ascontiguousarray(full[y:y + hw[0], x:x + hw[1]])
    want = jdet.detect(frame)
    got = tdet.detect(frame)
    assert got.scale == want.scale
    assert torch.is_tensor(got.image) and got.image.dtype == torch.uint8
    # bit for bit but where XLA's CPU blend lands a value a few ulp from
    # the port's across a .5 rounding boundary (ROADMAP Queue 3)
    diff = np.abs(got.image.numpy().astype(int) - np.asarray(want.image))
    assert diff.max() <= 1 and (diff > 0).mean() <= CANVAS_LSB_SHARE
    r = got.scale
    assert (got.image.numpy()[int(hw[0] * r):] == 114).all()
    assert len(got.scores) == len(want.scores) > 0
    np.testing.assert_allclose(got.boxes_tlbr, want.boxes_tlbr, rtol=0,
                               atol=BOX_TOL)
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=BOX_TOL)
    # the upload handle takes the same path
    again = tdet.detect(tdet.put_frame(frame))
    np.testing.assert_array_equal(again.boxes_tlbr, got.boxes_tlbr)


def _spy(engine, count):
    orig = engine.associate

    def associate(*a, **k):
        count[0] += 1
        return orig(*a, **k)

    engine.associate = associate
    return orig


def test_loop_matches_jax_frame_by_frame(detectors, engines):
    jdet, tdet, _ = detectors
    jeng, teng = engines
    frames = _frames()
    JTrack.reset_id_counter()
    Track.reset_id_counter()
    jtrk = JByte(JByteCfg(**TRACKER_KW), jeng)
    ttrk = ByteTracker(ByteTrackerConfig(**TRACKER_KW), teng)
    jlog, tlog = [], []
    jrounds, trounds = [0], [0]
    jorig, torig = _spy(jeng, jrounds), _spy(teng, trounds)
    try:
        want = jdetector.track_frames_with_detector(
            jdet, jtrk, frames, min_box_area=0.0, det_log=jlog)
        got = tdetector.track_frames_with_detector(
            tdet, ttrk, frames, min_box_area=0.0, det_log=tlog)
    finally:
        jeng.associate, teng.associate = jorig, torig
    assert got.num_frames == want.num_frames == N_FRAMES
    for (fj, bj, sj), (ft, bt, st) in zip(jlog, tlog):
        assert ft == fj and len(st) == len(sj), f"frame {fj}"
        np.testing.assert_allclose(bt, bj, rtol=0, atol=LOOP_BOX_TOL)
        np.testing.assert_allclose(st, sj, rtol=0, atol=BOX_TOL)
        gaps = np.abs(np.asarray(sj)[:, None] - np.asarray(THRESHOLDS))
        assert gaps.min() > 1e-5, f"frame {fj}: a score sits on a threshold"
    for (fj, tl_j, ids_j, _), (ft, tl_t, ids_t, _) in zip(want.results,
                                                          got.results):
        assert ids_t == ids_j, f"frame {fj}: ids diverged"
        np.testing.assert_allclose(np.reshape(tl_t, (-1, 4)),
                                   np.reshape(tl_j, (-1, 4)), rtol=0,
                                   atol=LOOP_BOX_TOL)
    assert sum(len(r[2]) for r in got.results) > 0, "no track was output"
    assert trounds[0] == jrounds[0] >= 1, "the third round never ran"


class _SerialOnly:
    """Detector proxy hiding ``detect_async``: the loop runs serially."""

    def __init__(self, det):
        self.put_frame = det.put_frame
        self.detect = det.detect


def test_pipelined_loop_matches_serial(detectors, engines):
    _, tdet, _ = detectors
    _, teng = engines
    frames = _frames()
    runs = []
    for det in (tdet, _SerialOnly(tdet)):
        Track.reset_id_counter()
        trk = ByteTracker(ByteTrackerConfig(**TRACKER_KW), teng)
        runs.append(tdetector.track_frames_with_detector(
            det, trk, frames, min_box_area=0.0))
    piped, serial = runs
    assert len(piped.results) == len(serial.results) == N_FRAMES
    for (fa, ta, ia, ca), (fb, tb, ib, cb) in zip(piped.results,
                                                  serial.results):
        assert fa == fb and ia == ib
        np.testing.assert_array_equal(np.asarray(ta), np.asarray(tb))
        np.testing.assert_array_equal(np.asarray(ca), np.asarray(cb))
    assert sum(len(r[2]) for r in piped.results) > 0


@pytest.fixture(scope="module")
def mot_sequence(tmp_path_factory):
    """The synthetic dropout sequence's first frames as a MOTChallenge
    directory: seqinfo.ini, img1/*.jpg and gt/gt.txt."""
    import cv2

    seq = default_dropout_sequence(40)
    n = 10
    root = tmp_path_factory.mktemp("mot") / "MOT17-05-FRCNN"
    (root / "img1").mkdir(parents=True)
    (root / "gt").mkdir()
    gt = seq.ground_truth()
    with open(root / "gt" / "gt.txt", "w") as f:
        for t in range(n):
            cv2.imwrite(str(root / "img1" / f"{t + 1:06d}.jpg"), seq.frame(t))
            for tlwh, gid in zip(*gt.get(t + 1, (np.zeros((0, 4)), []))):
                f.write(f"{t + 1},{gid},{tlwh[0]:.2f},{tlwh[1]:.2f},"
                        f"{tlwh[2]:.2f},{tlwh[3]:.2f},1,1,1\n")
    with open(root / "seqinfo.ini", "w") as f:
        f.write("[Sequence]\nname=MOT17-05-FRCNN\nimDir=img1\nframeRate=30\n"
                f"seqLength={n}\nimWidth={seq.width}\n"
                f"imHeight={seq.height}\nimExt=.jpg\n")
    return str(root)


def test_mot_dir_cli_matches_jax(mot_sequence, engines, tmp_path):
    """``--mot-dir --detector yolox-tiny`` with BUSCA through both
    packages' ``main``: the same YOLOX ``.pth`` and BUSCA weights, the same
    results (frames and ids equal, boxes within the loop's tolerance) and
    CLEAR counts, the CLEAR ratios within 1e-3."""
    import yaml

    from busca_tpu.eval import run as jrun
    from busca_tpu_torch.eval import run as trun
    from test_torch_byte_pipeline import SMALL

    _, teng = engines
    yolox = str(tmp_path / "yolox_tiny.pth")
    seq = default_dropout_sequence(40)
    torch.save(calibrated_state(YoloxConfig.size("tiny"), 22,
                                [seq.frame(t) for t in range(10)],
                                (128, 224), (56.0, 28.0)), yolox)
    busca = str(tmp_path / "busca.pth")
    torch.save(teng.model.state_dict(), busca)
    cfg = str(tmp_path / "busca.yml")
    with open(cfg, "w") as f:
        yaml.safe_dump({"transformer": dict(
            SMALL, reid_layers=list(SMALL["reid_layers"])),
            "tracker": {"busca_thresh": 0.1,
                        "select_highest_candidate": False}}, f)
    common = ["--mot-dir", mot_sequence, "--detector", "yolox-tiny",
              "--detector-ckpt", yolox, "--test-h", "128", "--test-w", "224",
              "--det-conf", "0.3", "--use-busca", "--busca-config", cfg,
              "--busca-ckpt", busca, "--crop-bank-slots", "2048",
              "--crop-h", str(CROP_HW[0]), "--crop-w", str(CROP_HW[1])]
    JTrack.reset_id_counter()
    want = jrun.main(common + ["--output-dir", str(tmp_path / "jax"),
                               "--busca-dtype", "float32"])
    Track.reset_id_counter()
    got = trun.main(common + ["--output-dir", str(tmp_path / "torch"),
                              "--busca-dtype", "float32", "--device", "cpu"])
    name = os.path.basename(mot_sequence)
    want_rows = np.loadtxt(tmp_path / "jax" / f"{name}.txt", delimiter=",")
    got_rows = np.loadtxt(tmp_path / "torch" / f"{name}.txt", delimiter=",")
    assert len(want_rows) > 5, "no track was written"
    # frames and ids exactly; the %.2f boxes and scores within the loop's
    # tolerance plus one printed step
    assert got_rows.shape == want_rows.shape
    np.testing.assert_array_equal(got_rows[:, :2], want_rows[:, :2])
    np.testing.assert_allclose(got_rows[:, 2:6], want_rows[:, 2:6], rtol=0,
                               atol=LOOP_BOX_TOL + 0.01)
    np.testing.assert_allclose(got_rows[:, 6], want_rows[:, 6], rtol=0,
                               atol=0.011)
    assert set(got) == set(want) == {name}
    a, b = got[name].as_dict(), want[name].as_dict()
    assert set(a) == set(b)
    for k in a:
        if isinstance(b[k], float):
            assert a[k] == pytest.approx(b[k], rel=0, abs=1e-3), k
        else:
            assert a[k] == b[k], k


def test_cli_refuses_flags_of_later_items(mot_sequence, tmp_path, capsys,
                                         monkeypatch):
    from busca_tpu_torch.eval import run as trun

    # --lockstep and --mem-cap are ported (tests/test_torch_lockstep*.py);
    # the modes of later items are refused, naming them
    base = ["--mot-dir", mot_sequence, "--device", "cpu"]
    for argv, item in ((["--detector", "yolox-tiny", "--lockstep",
                         "--lockstep-dp", "2"], "item 23"),
                       (["--online-visualization"], "item 25")):
        with pytest.raises(SystemExit):
            trun.main(base + argv)
        assert item in capsys.readouterr().err
    # --reid-stats frozen|auto are ported (items 7 and 24): the live-
    # detector run hands them to build_engine and runs to its report
    seen = []
    monkeypatch.setattr(trun, "build_engine",
                        lambda *a, **kw: seen.append(kw) or (None, {}))
    for mode in ("frozen", "auto"):
        trun.main(base + ["--detector", "yolox-tiny", "--test-h", "64",
                          "--test-w", "96", "--max-frames", "2",
                          "--use-busca", "--reid-stats", mode,
                          "--output-dir", str(tmp_path / mode)])
        assert seen[-1]["reid_stats"] == mode
        assert os.path.exists(tmp_path / mode / "MOT17-05-FRCNN.txt")


# bf16.  A random tiny YOLOX cannot be held frame by frame in bf16: its
# rounding noise grows layer by layer to half the spread of its obj logits
# (busca_tpu's own jitted and op-by-op bf16 forwards differ by up to 0.11
# in score on these frames), so which of its near-equal cells pass a
# threshold is noise.  The loop's YOLOX is instead a designed one, all
# weights zero but for one channel from the stem to level 0's obj output: a
# colour detector (R + 2G + B over each 2x2 block, above BRIGHT_THRESH per
# pixel) that the synthetic objects pass by a wide margin and the dark
# background and the grey letterbox fill do not.  Every layer still runs in
# bf16 in both packages; the random-weight numerics are held per module in
# tests/test_torch_bf16_detectors.py.
BRIGHT_GAIN, BRIGHT_THRESH = 32.0, 0.35
# measured on these frames: scores within 0.0039 (one bf16 step below 1;
# a cell on an object's edge scores between 0 and 1), boxes equal (the reg
# output is its bias); held to two steps
BF16_SCORE_TOL, BF16_BOX_TOL = 0.008, 0.0
# no score within this of a threshold (the float32 test's check, at the
# bf16 score step near 1)
BF16_THRESHOLD_GAP = 0.008


def bright_object_state(config, box_hw=(28.0, 14.0)):
    """The designed YOLOX's state dict: every BatchNorm the identity, every
    convolution zero but channel 0 carried through the stem, dark2, dark3,
    C3_p3, head stem 0 and reg_convs 0 (center tap 1, the CSP layers through
    their conv2 branch); level 0's obj output is that channel less 4, the
    other levels' obj biases are -30, the cls biases 4, the boxes ``box_hw``
    canvas pixels."""
    import math

    from busca_tpu_torch.models.yolox import BN_EPS

    sd = {k: torch.zeros_like(v)
          for k, v in YOLOX(config).state_dict().items()}
    for k in sd:
        if k.endswith("running_var"):
            sd[k].fill_(1.0 - BN_EPS)
        elif k.endswith("bn.weight"):
            sd[k].fill_(1.0)
    b = "backbone.backbone."
    # s2d groups (tl, bl, tr, br) of RGB: R + 2G + B of each pixel
    sd[b + "stem.conv.conv.weight"][0, :, 1, 1] = BRIGHT_GAIN * torch.tensor(
        [1.0, 2.0, 1.0] * 4)
    sd[b + "stem.conv.bn.bias"][0] = -BRIGHT_GAIN * 4 * BRIGHT_THRESH
    for name, src in ((b + "dark2.0.conv", 0), (b + "dark2.1.conv2.conv", 0),
                      (b + "dark2.1.conv3.conv", 8), (b + "dark3.0.conv", 0),
                      (b + "dark3.1.conv2.conv", 0),
                      (b + "dark3.1.conv3.conv", 16),
                      ("backbone.C3_p3.conv2.conv", 32),
                      ("backbone.C3_p3.conv3.conv", 16),
                      ("head.stems.0.conv", 0), ("head.reg_convs.0.0.conv", 0),
                      ("head.reg_convs.0.1.conv", 0)):
        w = sd[name + ".weight"]
        w[0, src, w.shape[2] // 2, w.shape[3] // 2] = 1.0
    sd["head.obj_preds.0.weight"][0, 0] = 1.0
    for lvl, stride in enumerate(config.strides):
        sd[f"head.obj_preds.{lvl}.bias"].fill_(-4.0 if lvl == 0 else -30.0)
        sd[f"head.cls_preds.{lvl}.bias"].fill_(4.0)
        sd[f"head.reg_preds.{lvl}.bias"][2] = math.log(box_hw[1] / stride)
        sd[f"head.reg_preds.{lvl}.bias"][3] = math.log(box_hw[0] / stride)
    return sd


def _bf16_frames(n=N_FRAMES):
    """:func:`_frames`, with the first object drawn in the background's
    colours while it is in its detection dropout window: the designed
    colour detector misses it there, as the sequence's detector does."""
    import dataclasses

    from busca_tpu_torch.eval.synthetic import SyntheticSequence

    seq = default_dropout_sequence(40)
    obj = seq.objects[0]
    hidden = SyntheticSequence(
        [dataclasses.replace(obj, color=np.array([40.0, 40.0, 40.0])),
         *seq.objects[1:]], num_frames=seq.num_frames, height=seq.height,
        width=seq.width, seed=seq.seed)
    start = next(t for t in range(seq.num_frames)
                 if not obj.detected_at(t)) - 3
    return [(seq if obj.detected_at(t) else hidden).frame(t)
            for t in range(start, start + n)]


@pytest.fixture(scope="module")
def bf16_detectors():
    d, w, c = TINY
    cfg = YoloxConfig(d, w, c, dtype="bfloat16")
    sd = bright_object_state(cfg)
    jcfg = JConfig(depth=d, width=w, num_classes=c, dtype="bfloat16")
    variables = convert_yolox_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jcfg)
    kw = dict(test_size=TEST_SIZE, conf_thresh=CONF, nms_thresh=0.7,
              max_outputs=32)
    return (jdetector.YoloxDetector(jcfg, variables, **kw),
            tdetector.YoloxDetector(cfg, sd, device="cpu", **kw))


def test_bf16_loop_matches_jax_frame_by_frame(bf16_detectors, bf16_engines):
    """The loop in busca_tpu's bf16 mode, the designed YOLOX and BUSCA
    (tests/test_torch_bf16_loop.py's engines) in bf16 in both packages:
    detection counts, scores and boxes, ids and track boxes per frame, and
    the third-round probabilities within tests/test_bf16.py's 0.12."""
    jdet, tdet = bf16_detectors
    jeng, teng = bf16_engines
    frames = _bf16_frames()
    JTrack.reset_id_counter()
    Track.reset_id_counter()
    jtrk = JByte(JByteCfg(**TRACKER_KW), jeng)
    ttrk = ByteTracker(ByteTrackerConfig(**TRACKER_KW), teng)
    jlog, tlog = [], []
    probs = {"j": [], "t": []}
    orig = {}
    for key, eng in (("j", jeng), ("t", teng)):
        orig[key] = eng.associate

        def associate(*a, _orig=orig[key], _log=probs[key], **k):
            out = _orig(*a, **k)
            _log.append(None if out[0] is None else np.array(out[0]))
            return out

        eng.associate = associate
    try:
        want = jdetector.track_frames_with_detector(
            jdet, jtrk, frames, min_box_area=0.0, det_log=jlog)
        got = tdetector.track_frames_with_detector(
            tdet, ttrk, frames, min_box_area=0.0, det_log=tlog)
    finally:
        jeng.associate, teng.associate = orig["j"], orig["t"]
    score_gap = 0.0
    for (fj, bj, sj), (ft, bt, st) in zip(jlog, tlog):
        assert ft == fj and len(st) == len(sj) > 0, f"frame {fj}"
        np.testing.assert_allclose(bt, bj, rtol=0, atol=BF16_BOX_TOL)
        score_gap = max(score_gap, float(np.abs(st - sj).max()))
        gaps = np.abs(np.asarray(sj)[:, None] - np.asarray(THRESHOLDS))
        assert gaps.min() > BF16_THRESHOLD_GAP, \
            f"frame {fj}: a score sits on a threshold"
    for (fj, tl_j, ids_j, _), (ft, tl_t, ids_t, _) in zip(want.results,
                                                          got.results):
        assert ids_t == ids_j, f"frame {fj}: ids diverged"
        np.testing.assert_allclose(np.reshape(tl_t, (-1, 4)),
                                   np.reshape(tl_j, (-1, 4)), rtol=0,
                                   atol=LOOP_BOX_TOL)
    assert len(probs["t"]) == len(probs["j"]) >= 1, "no third round ran"
    prob_gap = 0.0
    for a, b in zip(probs["t"], probs["j"]):
        assert (a is None) == (b is None)
        if a is not None:
            prob_gap = max(prob_gap, float(np.abs(a - b).max()))
    print(f"bf16 YOLOX loop: detections per frame {[len(x[2]) for x in tlog]}"
          f", scores within {score_gap:.3g}, third-round |dp| "
          f"{prob_gap:.3g} over {len(probs['t'])} rounds")
    assert score_gap <= BF16_SCORE_TOL
    assert prob_gap <= min(PROB_BAR, PROB_PIN)
    assert sum(len(r[2]) for r in got.results) > 0, "no track was output"
