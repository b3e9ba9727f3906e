"""The dp-split lockstep detector (``YoloxDetector.shard_lockstep``) against
the unsplit one on the CPU, over two devices (``local_devices(2, "cpu")``:
two replicas on the one CPU, the split's code path): every frame's boxes,
scores and canvas bit for bit, with a batch that splits evenly and one
padded with its last frame (busca_tpu's
tests/test_sharded_numerics.py::test_sharded_lockstep_detector_matches_unsharded
holds its split exactly too); and ``track_sequences_lockstep`` over the
split detector equal to the unsplit run, row for row.  The CLIs'
``--lockstep-dp`` are in tests/test_torch_yolox_loop.py and
tests/test_torch_server.py.
"""

import numpy as np
import pytest
import torch

from busca_tpu_torch.eval.detector import (
    YoloxDetector,
    track_sequences_lockstep,
)
from busca_tpu_torch.models.yolox import YoloxConfig
from busca_tpu_torch.parallel.mesh import local_devices
from busca_tpu_torch.trackers.base import Track
from busca_tpu_torch.trackers.byte import ByteTracker, ByteTrackerConfig
from test_torch_strongsort import one_torch_thread  # noqa: F401
from test_torch_yolox_loop import TINY, _frames, calibrated_state

TEST_SIZE = (64, 128)
KW = dict(test_size=TEST_SIZE, conf_thresh=0.05, nms_thresh=0.7,
          max_outputs=32, device="cpu")


@pytest.fixture(scope="module")
def state():
    """tests/test_torch_yolox_loop.py's calibrated tiny YOLOX, which
    detects the dropout sequence's objects."""
    return calibrated_state(YoloxConfig(*TINY), 21, _frames(), TEST_SIZE,
                            (28.0, 14.0))


def _detectors(state):
    cfg = YoloxConfig(*TINY)
    base = YoloxDetector(cfg, state_dict=state, **KW)
    split = YoloxDetector(cfg, state_dict=state, **KW)
    return base, split.shard_lockstep(local_devices(2, "cpu"))


def _assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.scale == b.scale
        np.testing.assert_array_equal(a.boxes_tlbr, b.boxes_tlbr)
        np.testing.assert_array_equal(a.scores, b.scores)
        assert torch.equal(torch.as_tensor(a.image), torch.as_tensor(b.image))


@pytest.mark.parametrize("batch", [4, 3])
def test_split_batch_equals_unsplit(state, batch):
    base, split = _detectors(state)
    assert len(split._shards) == 2 and split._shards[0] is split
    frames = np.random.RandomState(3).randint(
        0, 256, (batch, 50, 70, 3)).astype(np.uint8)
    got = split.detect_batch(frames)
    # the same per-device batch: one replica's frames in one step
    want = base.detect_batch(frames[:2]) + base.detect_batch(
        np.concatenate([frames[2:], frames[-1:]])[:2])[:batch - 2]
    _assert_same(got, want)
    # and the whole batch in one unsplit step
    _assert_same(got, base.detect_batch(frames))


def test_lockstep_loop_over_split_detector_equals_unsplit(state):
    base, split = _detectors(state)
    frames = _frames()
    seqs = [frames[:6], frames[1:5], frames[2:8]]
    rows = []
    for det in (base, split):
        Track.reset_id_counter()
        trackers = [ByteTracker(ByteTrackerConfig(track_thresh=0.05))
                    for _ in seqs]
        out = track_sequences_lockstep(det, trackers,
                                       [iter(s) for s in seqs])
        rows.append([[(f, [list(t) for t in tl], ids) for f, tl, ids, _
                      in r.results] for r in out])
    assert rows[0] == rows[1]
    assert any(ids for seq in rows[0] for _, _, ids in seq)


def test_lockstep_server_with_split_live_detector(state):
    """busca_tpu's multi-chip serving case
    (tests/test_lockstep_server.py::test_lockstep_server_with_dp_sharded_live_detector):
    the lockstep server over the split live detector; here every stream's
    replies also equal those of the server over the unsplit detector (ids
    and tlwh exactly)."""
    from busca_tpu_torch.serve.lockstep import LockstepTrackingServer
    from test_torch_lockstep_server import _rows, _run_streams

    frames = _frames()
    streams = [frames[:5], frames[2:7], frames[1:6]]

    def make():
        return ByteTracker(ByteTrackerConfig(track_thresh=0.3))

    got = []
    for det in _detectors(state):
        Track.reset_id_counter()
        server = LockstepTrackingServer(det, make, tick_timeout=0.25)
        got.append([_rows(r) for r in _run_streams(server, streams)])
    assert [[r[0] for r in s] for s in got[1]] == [[1, 2, 3, 4, 5]] * 3
    assert got[0] == got[1]
    assert any(r[2] for s in got[1] for r in s)
