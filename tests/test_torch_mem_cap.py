"""``--mem-cap`` in the port (tests/test_mem_cap.py's CLI and propagation
cases): the cap reaches every tracker kind that stores appearance memory,
through ``make_tracker`` and through the CLI; it is validated as in
busca_tpu, and refused for SORT and MOTDT, which store none.
"""

import numpy as np
import pytest

from busca_tpu.eval import run as jrun
from busca_tpu_torch.eval import run as trun
from busca_tpu_torch.trackers.base import Track
from busca_tpu_torch.trackers.byte import ByteTracker, ByteTrackerConfig
from busca_tpu_torch.trackers.ghost import GhostConfig, GhostTracker
from busca_tpu_torch.trackers.strongsort import (
    StrongSortConfig,
    StrongSortTracker,
)
from test_run_cli import mot_fixture  # noqa: F401 (the fixture)

H, W = 32, 16


def _crop(rng):
    return rng.randint(0, 255, (H, W, 3), dtype=np.uint8)


def _cfg_of(tracker):
    """The memory-bearing config under a tracker or its adapter."""
    inner = getattr(tracker, "tracker", tracker)
    return inner.cfg


@pytest.mark.parametrize("name", trun.MEM_CAP_TRACKERS)
def test_make_tracker_carries_mem_cap(name):
    trk = trun.make_tracker(name, {"mem_cap": 20}, None)
    assert _cfg_of(trk).mem_cap == 20
    jtrk = jrun.make_tracker(name, {"mem_cap": 20}, None)
    assert _cfg_of(jtrk).mem_cap == 20


@pytest.mark.parametrize("name", ["sort", "motdt"])
def test_mem_cap_rejected_for_unsupported_tracker(name, mot_fixture,  # noqa
                                                  capsys):
    for make in (trun.make_tracker, jrun.make_tracker):
        with pytest.raises(ValueError, match="mem-cap"):
            make(name, {"mem_cap": 64}, None)
    with pytest.raises(SystemExit):
        trun.main(["--mot-dir", mot_fixture, "--tracker", name,
                   "--mem-cap", "64", "--device", "cpu"])
    assert "--mem-cap only applies" in capsys.readouterr().err


@pytest.mark.parametrize("tracker", ["byte", "strongsort", "deepsort",
                                     "ghost"])
def test_cli_mem_cap_reaches_the_tracker(tracker, mot_fixture,  # noqa
                                         tmp_path, monkeypatch):
    made = []
    orig = trun.make_tracker

    def spy(name, kwargs, *a, **k):
        trk = orig(name, kwargs, *a, **k)
        made.append(_cfg_of(trk).mem_cap)
        return trk

    monkeypatch.setattr(trun, "make_tracker", spy)
    for lockstep in ([], ["--lockstep"]):
        made.clear()
        trun.main(["--mot-dir", mot_fixture, "--tracker", tracker,
                   "--mem-cap", "12", "--output-dir", str(tmp_path),
                   "--device", "cpu"] + lockstep)
        assert made == [12]


def test_tracker_propagates_mem_cap():
    Track.reset_id_counter()
    tracker = ByteTracker(ByteTrackerConfig(
        track_thresh=0.5, mem_cap=8, use_camera_motion_compensation=False))
    box = np.array([[40.0, 40, 80, 120]])
    for f in range(120):
        online = tracker.update(box + f, np.array([0.9]))
    assert len(online) == 1
    tr = online[0]
    assert tr.mem_cap == 8 and len(tr.tlwh_mem) <= 8
    assert tr.track_id == 1  # one object keeps one id through compaction


def test_mem_cap_validation():
    with pytest.raises(ValueError, match="mem_cap"):
        ByteTracker(ByteTrackerConfig(mem_cap=1))
    with pytest.raises(ValueError, match="last_n_frames"):
        GhostTracker(GhostConfig(mem_cap=8, last_n_frames=16))
    GhostTracker(GhostConfig(mem_cap=16, last_n_frames=5))
    with pytest.raises(ValueError, match="mem_cap"):
        StrongSortTracker(StrongSortConfig(mem_cap=2))
    with pytest.raises(ValueError, match="mem_cap"):
        GhostTracker(GhostConfig(mem_cap=3))


def test_strongsort_ghost_config_propagation():
    rng = np.random.RandomState(0)
    st = StrongSortTracker(StrongSortConfig(mem_cap=16))
    st._initiate(np.array([60.0, 80, 0.5, 60]), 0.9, None, _crop(rng))
    assert st.tracks[0].mem_cap == 16
    gt = GhostTracker(GhostConfig(mem_cap=16))
    gt.frame_id = 1
    gt._new_track(np.array([10.0, 20, 40, 80]), rng.randn(8), 0.9,
                  _crop(rng))
    assert gt.tracks[1].mem_cap == 16
