"""The port's CenterTrack loop (busca_tpu_torch/eval/detector.py's
``CenterTrackDetector`` and ``track_frames_centertrack``, with
``CenterTrackAdapter`` and BUSCA) against busca_tpu's on the CPU.

The detector is a tiny DLA designed as a colour detector
(:func:`colour_detector_state`; a random net's peaks sit at the borders and
do not move with the objects), loaded into the port as it is and into
busca_tpu through its ``convert_centertrack_state_dict``: each object
becomes one smooth peak through five DCN nodes sampling at fractional
offsets.  The frames are the synthetic dropout sequence at 256x384 into a
128x256 input (letterboxed), object 1 painted over during its dropout
window, so that BUSCA's third round keeps its track alive there.

- ``gaussian_radius`` and the prior heatmap's rendering are equal, empty
  and degenerate tracks included;
- ``detect``: the canvas equal but for the letterbox's known 1-LSB
  difference (ROADMAP Queue 3), the dict detections within 1e-3 on frames
  where no score lies within 1e-4 of ``out_thresh``;
- the loop with BUSCA (the small model of tests/test_torch_byte_pipeline.py)
  frame by frame: ids equal, boxes within 0.1 frame pixels, third-round
  probabilities within 0.0242 (tests/test_torch_byte_pipeline.py's bar).
"""

import numpy as np
import pytest
import torch

from busca_tpu.eval import detector as jdet
from busca_tpu.eval.synthetic import default_dropout_sequence
from busca_tpu.models import centertrack as jct
from busca_tpu.trackers.base import Track as JTrack
from busca_tpu.trackers.byte import ByteTrackerConfig as JByteCfg
from busca_tpu.trackers.centertrack import CenterTrackAdapter as JAdapter
from busca_tpu_torch.eval import detector as tdet
from busca_tpu_torch.models import centertrack as tct
from busca_tpu_torch.trackers.base import Track
from busca_tpu_torch.trackers.byte import ByteTrackerConfig
from busca_tpu_torch.trackers.centertrack import CenterTrackAdapter
from test_torch_byte_pipeline import (  # noqa: F401 (the fixture)
    CROP_HW,
    PROB_TOL,
    _logged,
    engines,
)
from test_torch_strongsort import one_torch_thread  # noqa: F401

TEST_SIZE = (128, 256)  # 256x384 frames at r = 0.5, letterboxed
OUT_THRESH = 0.3
DET_TOL = 1e-3
BOX_TOL = 0.1  # frame pixels
N_FRAMES = 30
# the designed detector (see colour_detector_state)
GR_THRESH = 190.0  # G + R above this is object colour
HM_GAIN, HM_BIAS = 3.0, -2.5
BOX_CELLS = (4.75, 9.5)  # w, h in stride-4 cells: 38x76 frame pixels
# each DCN tap sampled 0.25 px further out per unit of its grid position
TAP_SPREAD = 0.25


def colour_detector_state():
    """A tiny CenterTrack designed as a colour detector, as a published-
    layout state dict: the stem's channel 0 is ``10 * relu((G + R) / 255 -
    GR_THRESH / 255)`` (both synthetic objects pass, the background and the
    letterbox fill do not) plus half the prior heatmap; the trunk carries it
    to stride 4 (Trees and roots pass it, the deeper levels are zero); the
    five DCN nodes on its path (three in ``dla_up.ida_2``, two in
    ``ida_up``) are each a 3x3 box filter sampled at fractional offsets
    (tap grid spread by TAP_SPREAD) with the mask at sigmoid(0) = 0.5, so
    an object becomes one smooth peak; ``hm`` reads it with HM_GAIN and
    HM_BIAS, ``wh`` is the constant BOX_CELLS, ``reg`` a small multiple of
    the response.  Every BN is the identity."""
    model = tct.CenterTrackNet(tct.CenterTrackConfig.tiny())
    bns = {n for n, m in model.named_modules()
           if isinstance(m, torch.nn.BatchNorm2d)}
    sd = {}
    for k, v in model.state_dict().items():
        owner, leaf = k.rsplit(".", 1)
        one = owner in bns and leaf in ("weight", "running_var")
        sd[k] = torch.ones_like(v) if one else torch.zeros_like(v)
    mean, std = jdet.CENTERNET_MEAN_BGR, jdet.CENTERNET_STD_BGR
    gain = 10.0
    # BGR input: (G + R) / 255 = x_G * std_G + mean_G + x_R * std_R + mean_R
    sd["base.base_layer.0.weight"][0, 1, 3, 3] = gain * std[1]
    sd["base.base_layer.0.weight"][0, 2, 3, 3] = gain * std[2]
    sd["base.base_layer.1.bias"][0] = gain * (mean[1] + mean[2]
                                              - GR_THRESH / 255.0)
    sd["base.pre_hm_layer.0.weight"][0, 0, 3, 3] = 0.5
    sd["base.level0.0.weight"][0, 0, 1, 1] = 1.0
    sd["base.level1.0.weight"][0, 0, 1, 1] = 1.0
    sd["base.level2.root.conv.weight"][0, 0] = 1.0  # tree2's channel 0
    box = [(i, ky, kx) for i, (ky, kx) in enumerate(
        (ky, kx) for ky in range(3) for kx in range(3))]
    for node in ("dla_up.ida_2.node_1", "dla_up.ida_2.node_2",
                 "dla_up.ida_2.node_3", "ida_up.node_1", "ida_up.node_2"):
        sd[f"{node}.conv.weight"][0, 0] = 2.0 / 9.0
        bias = sd[f"{node}.conv.conv_offset_mask.bias"]
        for t, ky, kx in box:
            bias[2 * t] = TAP_SPREAD * (ky - 1)
            bias[2 * t + 1] = TAP_SPREAD * (kx - 1)
    for k, v in sd.items():
        if k.endswith("weight") and ".up_" in k:
            v.copy_(torch.from_numpy(tct.bilinear_up_kernel(v.shape[-1])))
    sd["hm.0.weight"][0, 0, 1, 1] = 1.0
    sd["hm.2.weight"][0, 0] = HM_GAIN
    sd["hm.2.bias"][0] = HM_BIAS
    sd["reg.0.weight"][0, 0, 1, 1] = 1.0
    sd["reg.2.weight"][:, 0, 0, 0] = torch.tensor([0.05, -0.03])
    sd["wh.0.bias"][0] = 1.0
    sd["wh.2.weight"][:, 0, 0, 0] = torch.tensor(BOX_CELLS)
    return sd


def occluded_frames(n=N_FRAMES):
    """The dropout sequence's frames with object 1 painted over in the
    background's grey during its dropout window, so that the detector
    misses it there."""
    seq = default_dropout_sequence(n)
    obj = seq.objects[0]
    frames = []
    for t in range(n):
        frame = seq.frame(t)
        if not obj.detected_at(t):
            x, y, w, h = obj.box_at(t)
            frame[max(int(y) - 2, 0):int(y + h) + 3,
                  max(int(x) - 2, 0):int(x + w) + 3] = 40
        frames.append(frame)
    return frames


@pytest.fixture(scope="module")
def detectors():
    from busca_tpu.models.convert import convert_centertrack_state_dict

    sd = colour_detector_state()
    variables = convert_centertrack_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    jd = jdet.CenterTrackDetector(jct.CenterTrackConfig.tiny(), variables,
                                  TEST_SIZE, OUT_THRESH)
    td = tdet.CenterTrackDetector(tct.CenterTrackConfig.tiny(), sd,
                                  TEST_SIZE, OUT_THRESH, device="cpu")
    return jd, td


@pytest.mark.parametrize("hw", [(10, 10), (40, 40), (24, 80), (3.5, 7.25),
                                (0.0, 12.0), (200.0, 60.0)])
def test_gaussian_radius_matches_jax(hw):
    assert tdet.gaussian_radius(hw) == jdet.gaussian_radius(hw)


TRACK_SETS = {
    "none": None,
    "empty": [],
    "degenerate": [{"bbox": np.array([5.0, 5.0, 5.0, 9.0])},
                   {"bbox": np.array([9.0, 5.0, 4.0, 12.0])}],
    "mixed": [{"bbox": np.array([4.0, 4.0, 16.0, 20.0])},
              {"bbox": np.array([-30.0, 10.0, 12.0, 90.0])},  # partly out
              {"bbox": np.array([100.5, 30.25, 140.0, 70.0])},
              {"bbox": np.array([400.0, 300.0, 460.0, 380.0])}],  # outside
}


@pytest.mark.parametrize("tracks", sorted(TRACK_SETS))
@pytest.mark.parametrize("r", [1.0, 0.25])
def test_render_pre_hm_matches_jax(detectors, tracks, r):
    jd, td = detectors
    want = jd._render_pre_hm(TRACK_SETS[tracks], r)
    got = td._render_pre_hm(TRACK_SETS[tracks], r)
    assert got.shape == want.shape == TEST_SIZE + (1,)
    np.testing.assert_array_equal(got, want)
    if tracks in ("none", "empty", "degenerate"):
        assert not got.any()


def canvas_and_dicts(jd, td, frame, tracks):
    jres, jcanvas, jr = jd.detect(frame, tracks=tracks)
    tres, tcanvas, tr = td.detect(frame, tracks=tracks)
    assert tr == jr
    assert torch.is_tensor(tcanvas) and tcanvas.dtype == torch.uint8
    diff = np.abs(tcanvas.numpy().astype(int) - np.asarray(jcanvas, int))
    assert diff.max() <= 1, "the canvases differ by more than one step"
    return jres, tres


def test_detect_matches_jax(one_torch_thread, detectors):  # noqa: F811
    jd, td = detectors
    jd.reset()
    td.reset()
    frames = occluded_frames()
    tracks = None
    compared = 0
    for t in range(0, N_FRAMES, 3):
        jres, tres = canvas_and_dicts(jd, td, frames[t], tracks)
        scores = [d["score"] for d in jres]
        near = any(abs(s - OUT_THRESH) < 1e-4 for s in scores)
        if not near:
            compared += 1
            assert len(tres) == len(jres), f"frame {t}"
            for a, b in zip(tres, jres):
                assert a["class"] == b["class"] == 1
                for k in ("bbox", "tracking", "ct"):
                    np.testing.assert_allclose(a[k], b[k], rtol=0,
                                               atol=DET_TOL, err_msg=k)
                assert abs(a["score"] - b["score"]) <= DET_TOL
        # the next frame's prior heatmap from this frame's detections
        tracks = [{"bbox": d["bbox"]} for d in jres]
    assert compared >= 8


def test_loop_with_busca_matches_jax(one_torch_thread, detectors,  # noqa
                                     engines):  # noqa: F811
    jd, td = detectors
    jeng, teng = engines
    frames = occluded_frames()
    kw = dict(use_busca=True, crop_hw=CROP_HW, busca_thresh=0.1,
              select_highest_candidate=False, track_thresh=0.5)
    jd.reset()
    td.reset()
    JTrack.reset_id_counter()
    Track.reset_id_counter()
    jlog, tlog = [], []
    jorig, torig = _logged(jeng, jlog), _logged(teng, tlog)
    try:
        want = jdet.track_frames_centertrack(
            jd, JAdapter(JByteCfg(**kw), jeng), frames, name="ct")
        got = tdet.track_frames_centertrack(
            td, CenterTrackAdapter(ByteTrackerConfig(**kw), teng), frames,
            name="ct")
    finally:
        jeng.associate, teng.associate = jorig, torig
    assert got.num_frames == want.num_frames == N_FRAMES
    n_tracks = 0
    for (fa, ta, ia, ca), (fb, tb, ib, cb) in zip(got.results, want.results):
        assert fa == fb and ia == ib, f"frame {fa}: ids diverged"
        np.testing.assert_allclose(np.reshape(ta, (-1, 4)),
                                   np.reshape(tb, (-1, 4)), rtol=0,
                                   atol=BOX_TOL, err_msg=f"frame {fa}")
        np.testing.assert_allclose(ca, cb, rtol=0, atol=DET_TOL)
        n_tracks += len(ia)
    assert len(tlog) == len(jlog)
    third_rounds = 0
    for pt, pj in zip(tlog, jlog):
        assert (pt is None) == (pj is None)
        if pj is not None:
            third_rounds += 1
            np.testing.assert_allclose(pt, pj, rtol=0, atol=PROB_TOL)
    assert n_tracks == 2 * N_FRAMES, "a track was lost"
    assert third_rounds >= 1, "the loop never reached the third round"
    assert set(got.stage_times) == {"detector_s", "tracker_s"}


def test_adapter_lockstep_prefetch_refused():
    """The adapter's ECC prefetch, refused before the lockstep drivers were
    ported, now forwards to its inner BYTE: nothing to align without BUSCA
    or before a frame, a submitted solve after one."""
    from test_torch_strongsort import StubEngine

    adapter = CenterTrackAdapter(ByteTrackerConfig())
    assert adapter.tracker.cfg.mot20 and adapter.tracker.det_thresh == 0.4
    frame = np.random.RandomState(2).randint(0, 255, (64, 96, 3), np.uint8)
    assert adapter.cmc_prefetch(frame) is None  # no BUSCA engine
    adapter = CenterTrackAdapter(ByteTrackerConfig(use_busca=True),
                                 StubEngine())
    assert adapter.cmc_prefetch(frame) is None  # no previous frame
    adapter.step([{"bbox": np.array([10.0, 10, 30, 50]), "score": 0.9,
                   "class": 1}], frame, 1.0)
    fut = adapter.cmc_prefetch(frame)
    assert fut is not None and adapter.tracker._warp_hint is not None
    np.testing.assert_allclose(fut.result()[1], np.eye(2, 3), atol=1e-4)
