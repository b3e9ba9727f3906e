"""The port's batch-B YOLOX step and the live-detector lockstep loop on the
CPU, with the calibrated tiny YOLOX of tests/test_torch_yolox_loop.py:

- ``detect_batch`` against ``detect`` frame by frame: canvases equal (each
  frame letterboxed by the crop op into its slice of one canvas batch),
  detection counts equal, boxes and scores within rtol 1e-4, atol 1e-3
  (tests/test_detector_loop.py's bound: the batched forward sums in
  another order);
- ``detect_batch`` against busca_tpu's ``detect_batch``: canvases within 1
  LSB on <= 0.1% of values, counts equal, boxes within 0.1 frame px (as
  tests/test_torch_yolox_loop.py::test_detect_matches_jax);
- ``track_sequences_lockstep`` with ByteTracker + the small BUSCA engine
  over two streams of 8 and 5 frames of the dropout sequence (the shorter
  one is padded with its last frame; both reach the dropout, so one grouped
  association serves both third rounds): each sequence equal to its own
  pipelined ``track_frames_with_detector`` loop, and to busca_tpu's lockstep run
  (ids relabelled by first appearance, boxes within 0.1 frame px).
"""

import numpy as np
import torch

from busca_tpu.eval import detector as jdetector
from busca_tpu.eval.synthetic import default_dropout_sequence
from busca_tpu.trackers.base import Track as JTrack
from busca_tpu.trackers.byte import ByteTracker as JByte
from busca_tpu.trackers.byte import ByteTrackerConfig as JByteCfg
from busca_tpu_torch.eval import detector as tdetector
from busca_tpu_torch.trackers.base import Track
from busca_tpu_torch.trackers.byte import ByteTracker, ByteTrackerConfig
from test_torch_byte_pipeline import engines  # noqa: F401 (the fixture)
from test_torch_strongsort import one_torch_thread  # noqa: F401
from test_torch_yolox_loop import (  # noqa: F401 (the fixture)
    CANVAS_LSB_SHARE,
    LOOP_BOX_TOL,
    TRACKER_KW,
    _frames,
    detectors,
)

RTOL, ATOL = 1e-4, 1e-3  # tests/test_detector_loop.py:222
LENGTHS = (8, 5)


def _other_frames(n):
    """A second sequence at the same resolution: the dropout sequence of
    another seed, over the same window."""
    seq = default_dropout_sequence(40, seed=3)
    start = next(t for t in range(seq.num_frames)
                 if not seq.objects[0].detected_at(t)) - 3
    return [seq.frame(t) for t in range(start, start + n)]


def _batch():
    return np.stack([_frames()[0], _frames()[5], _other_frames(5)[2],
                     _other_frames(5)[4]])


def test_detect_batch_matches_detect(detectors):
    _, tdet, _ = detectors
    frames = _batch()
    fallbacks = tdet.nms_fallbacks
    got = tdet.detect_batch(frames)
    assert len(got) == len(frames)
    for frame, out in zip(frames, got):
        want = tdet.detect(frame)
        assert torch.is_tensor(out.image) and out.image.is_contiguous()
        assert torch.equal(out.image, want.image)
        assert out.scale == want.scale
        assert len(out.scores) == len(want.scores) > 0
        np.testing.assert_allclose(out.boxes_tlbr, want.boxes_tlbr,
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(out.scores, want.scores, rtol=RTOL,
                                   atol=ATOL)
    # the handle path, a device-tensor batch and an upload take one step
    again = tdet.wait_batch(tdet.detect_batch_async(
        torch.from_numpy(frames)))
    for a, b in zip(again, got):
        np.testing.assert_array_equal(a.boxes_tlbr, b.boxes_tlbr)
    assert tdet.nms_fallbacks == fallbacks


def test_detect_batch_falls_back_per_frame(detectors):
    """A frame whose NMS has not reached its fixed point in the step's
    fixed steps is finished in ``wait_batch`` with the iterated NMS, on
    its own: the same detections."""
    _, tdet, _ = detectors
    frames = _batch()
    want = tdet.detect_batch(frames)
    handle = tdet.detect_batch_async(frames)
    handle.converged[1] = False
    fallbacks = tdet.nms_fallbacks
    got = tdet.wait_batch(handle)
    assert tdet.nms_fallbacks == fallbacks + 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.boxes_tlbr, b.boxes_tlbr)
        np.testing.assert_array_equal(a.scores, b.scores)


def test_detect_batch_matches_jax(detectors):
    jdet, tdet, _ = detectors
    frames = _batch()
    want = jdet.detect_batch(frames)
    got = tdet.detect_batch(frames)
    for g, w in zip(got, want):
        diff = np.abs(g.image.numpy().astype(int) - np.asarray(w.image))
        assert diff.max() <= 1 and (diff > 0).mean() <= CANVAS_LSB_SHARE
        assert g.scale == w.scale
        assert len(g.scores) == len(w.scores) > 0
        np.testing.assert_allclose(g.boxes_tlbr / g.scale,
                                   w.boxes_tlbr / w.scale, rtol=0,
                                   atol=LOOP_BOX_TOL)
        np.testing.assert_allclose(g.scores, w.scores, rtol=0, atol=1e-3)


def _canon(results):
    """Per frame: (ids relabelled by first appearance, tlwh rows)."""
    relabel, out = {}, []
    for frame_id, tlwhs, ids, _ in results:
        out.append((frame_id,
                    [relabel.setdefault(i, len(relabel)) for i in ids],
                    np.reshape(np.asarray(tlwhs), (-1, 4))))
    return out


def _assert_close(got, want):
    assert len(got) == len(want)
    for (fg, ig, bg), (fw, iw, bw) in zip(_canon(got), _canon(want)):
        assert fg == fw and ig == iw, f"frame {fg}: ids differ"
        np.testing.assert_allclose(bg, bw, rtol=0, atol=LOOP_BOX_TOL)


def test_lockstep_loop_pads_and_matches_sequential_and_jax(detectors,
                                                           engines):
    jdet, tdet, _ = detectors
    jeng, teng = engines
    # the second stream is the first one's first frames: both reach the
    # dropout with a lost track (a stream starting a frame later has none)
    seqs = [_frames(LENGTHS[0]), _frames(LENGTHS[1])]
    many = []
    orig = teng.associate_many
    teng.associate_many = lambda reqs, **kw: (many.append(len(reqs))
                                              or orig(reqs, **kw))
    try:
        Track.reset_id_counter()
        got = tdetector.track_sequences_lockstep(
            tdet, [ByteTracker(ByteTrackerConfig(**TRACKER_KW), teng)
                   for _ in seqs],
            [iter(s) for s in seqs], names=["a", "b"], min_box_area=0.0)
    finally:
        teng.associate_many = orig
    assert [r.num_frames for r in got] == list(LENGTHS)
    assert 2 in many, "no frame served both sequences' third rounds"
    assert sum(len(r[2]) for res in got for r in res.results) > 0
    for res, frames in zip(got, seqs):
        Track.reset_id_counter()
        solo = tdetector.track_frames_with_detector(
            tdet, ByteTracker(ByteTrackerConfig(**TRACKER_KW), teng),
            frames, min_box_area=0.0)
        _assert_close(res.results, solo.results)
    JTrack.reset_id_counter()
    want = jdetector.track_sequences_lockstep(
        jdet, [JByte(JByteCfg(**TRACKER_KW), jeng) for _ in seqs],
        [iter(s) for s in seqs], names=["a", "b"], min_box_area=0.0)
    for g, w in zip(got, want):
        assert g.num_frames == w.num_frames
        _assert_close(g.results, w.results)
