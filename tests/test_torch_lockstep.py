"""Lockstep evaluation across sequences in the port against busca_tpu on the
CPU: every case of tests/test_lockstep_busca.py, run through both packages'
drivers on the same stub batch detector, stub engines and frames, plus
StrongSORT's ``.npy`` lockstep runner and the lockstep driver with a real
(small) BUSCA engine, whose third rounds go through ``associate_many``.

Each case holds the port's lockstep output against the port's own
sequential run (per-frame box sets, as busca_tpu's test does) and against
busca_tpu's lockstep run: equal per-frame boxes and equal ids after
relabelling by first appearance (the two packages' id counters are
separate).
"""

import os

import numpy as np
import pytest

from busca_tpu.eval import detector as jdetector
from busca_tpu.eval import run as jrun
from busca_tpu.eval import runner as jrunner
from busca_tpu.eval import strongsort_io as jss_io
from busca_tpu.trackers import GhostConfig as JGhostCfg
from busca_tpu.trackers import GhostTracker as JGhost
from busca_tpu.trackers import StrongSortConfig as JSSCfg
from busca_tpu.trackers import StrongSortTracker as JSS
from busca_tpu.trackers import cmc as jcmc
from busca_tpu.trackers.base import Track as JTrack
from busca_tpu.trackers.byte import ByteTracker as JByte
from busca_tpu.trackers.byte import ByteTrackerConfig as JByteCfg
from busca_tpu_torch.eval import detector as tdetector
from busca_tpu_torch.eval import run as trun
from busca_tpu_torch.eval import runner as trunner
from busca_tpu_torch.eval import strongsort_io as tss_io
from busca_tpu_torch.eval.synthetic import (
    SyntheticObject,
    SyntheticSequence,
    default_dropout_sequence,
)
from busca_tpu_torch.trackers import cmc as tcmc
from busca_tpu_torch.trackers.base import Track
from busca_tpu_torch.trackers.byte import ByteTracker, ByteTrackerConfig
from busca_tpu_torch.trackers.ghost import GhostConfig, GhostTracker
from busca_tpu_torch.trackers.strongsort import (
    StrongSortConfig,
    StrongSortTracker,
)
from test_byte_tracker import StubEngine as JStubEngine
from test_torch_byte_pipeline import (  # noqa: F401 (the fixture)
    CROP_HW,
    engines,
)
from test_torch_strongsort import StubEngine, one_torch_thread  # noqa: F401


class StubBatchDetector:
    """``detect_batch`` stand-in (tests/test_lockstep_busca.py): the frames
    are ignored but for the image handed on; the detections come from
    per-sequence lists, dropout windows included."""

    def __init__(self, dets_per_seq):
        self.dets = dets_per_seq
        self.t = -1

    def detect_batch(self, frames):
        self.t += 1
        outs = []
        for i, d in enumerate(self.dets):
            boxes, scores = d[min(self.t, len(d) - 1)]
            outs.append(tdetector.DetectorOutput(
                boxes_tlbr=boxes, scores=scores, image=np.asarray(frames[i]),
                scale=1.0))
        return outs


def _canon(results):
    """Per-frame rows sorted as whole boxes, ids relabelled by first
    appearance (tests/test_lockstep_busca.py's view)."""
    relabel, out = {}, []
    for frame_id, tlwhs, ids, _confs in results:
        rows = []
        for tlwh, tid in zip(tlwhs, ids):
            relabel.setdefault(tid, len(relabel))
            rows.append(tuple(round(float(v), 6) for v in tlwh[:4])
                        + (relabel[tid],))
        out.append((frame_id, sorted(rows)))
    return out


def _boxes(tlwhs):
    return sorted((round(float(t[0]), 6), round(float(t[1]), 6))
                  for t in tlwhs)


def _dropout_inputs(n, seeds):
    seqs = [default_dropout_sequence(n, seed=s) for s in seeds]
    dets = [[s.detections(t) for t in range(n)] for s in seqs]
    frames = [[s.frame(t) for t in range(n)] for s in seqs]
    return dets, frames


def _byte(engine=None, jax=False, **cfg_kw):
    if jax:
        return JByte(JByteCfg(use_busca=True, **cfg_kw),
                     assoc_engine=engine or JStubEngine(kalman_prob=1.0))
    return ByteTracker(ByteTrackerConfig(use_busca=True, **cfg_kw),
                       assoc_engine=engine or StubEngine(kalman_prob=1.0))


def _both_lockstep(dets, frames, make):
    """The same stub batch detector and frames through both packages'
    ``track_sequences_lockstep``; ``make(jax)`` builds a tracker."""
    out = []
    for jax, mod, reset in ((False, tdetector, Track.reset_id_counter),
                            (True, jdetector, JTrack.reset_id_counter)):
        reset()
        trackers = [make(jax) for _ in dets]
        res = mod.track_sequences_lockstep(
            StubBatchDetector(dets), trackers, [iter(f) for f in frames],
            names=["a", "b"])
        out.append((res, trackers))
    return out


def _sequential_boxes(dets, frames, make):
    Track.reset_id_counter()
    seq = []
    for si in range(len(dets)):
        trk = make(False)
        rows = []
        for t in range(len(frames[si])):
            boxes, scores = dets[si][t]
            online = trk.update(boxes, scores, 1.0, frames[si][t])
            rows.append(_boxes(o.tlwh for o in online
                               if o.tlwh[2] * o.tlwh[3] > 100))
        seq.append(rows)
    return seq


def _assert_lockstep(dets, frames, make):
    (got, got_trk), (want, want_trk) = _both_lockstep(dets, frames, make)
    seq = _sequential_boxes(dets, frames, make)
    for i, res in enumerate(got):
        assert res.num_frames == len(frames[i])
        assert [_boxes(r[1]) for r in res.results] == seq[i], f"seq {i}"
        assert _canon(res.results) == _canon(want[i].results), f"seq {i}"
        assert set(res.stage_times) == {"detector_s", "tracker_s"}
    return got, got_trk, want_trk


def test_lockstep_batched_third_round_matches_sequential():
    dets, frames = _dropout_inputs(24, (0, 3))
    _assert_lockstep(dets, frames, lambda jax: _byte(jax=jax))


def test_lockstep_rescues_through_dropout():
    dets, frames = _dropout_inputs(24, (0, 1))
    got, trackers, jtrackers = _assert_lockstep(
        dets, frames, lambda jax: _byte(jax=jax))
    for trk, jtrk in zip(trackers, jtrackers):
        assert trk.engine.calls == jtrk.engine.calls > 0
    for res in got:
        counts = [len(ids) for _, _, ids, _ in res.results]
        assert min(counts[3:]) >= 2


def test_lockstep_cmc_warp_prefetch_matches_inline(monkeypatch):
    """CMC on: the driver prefetches each sequence's ECC warp on the CMC
    pool, one solve per sequence per frame pair, in both packages; the
    outputs equal the inline path's."""
    pytest.importorskip("cv2")
    n = 20
    dets, frames = _dropout_inputs(n, (0, 3))
    submits = {"torch": 0, "jax": 0}
    for tag, mod in (("torch", tcmc), ("jax", jcmc)):
        orig = mod.submit_warp

        def counted(p, c, scale=1.0, _orig=orig, _tag=tag, **kw):
            submits[_tag] += 1
            return _orig(p, c, scale=scale, **kw)

        monkeypatch.setattr(mod, "submit_warp", counted)
    _, trackers, jtrackers = _assert_lockstep(
        dets, frames,
        lambda jax: _byte(jax=jax, use_camera_motion_compensation=True))
    assert submits == {"torch": 2 * (n - 1), "jax": 2 * (n - 1)}
    assert all(t._warp_hint is None for t in trackers + jtrackers)


def test_lockstep_with_busca_engine_matches_sequential(engines):
    """The small BUSCA model: the lockstep third rounds go through
    ``associate_many`` (grouped BN) and reproduce the sequential loop; the
    same against busca_tpu's lockstep run."""
    jeng, teng = engines
    calls = []
    orig = teng.associate_many
    teng.associate_many = lambda reqs, **kw: (calls.append(len(reqs))
                                              or orig(reqs, **kw))
    kw = dict(crop_hw=CROP_HW, busca_thresh=0.1,
              select_highest_candidate=False,
              use_camera_motion_compensation=False)
    try:
        dets, frames = _dropout_inputs(24, (0, 3))
        _assert_lockstep(dets, frames, lambda jax: _byte(
            jeng if jax else teng, jax=jax, **kw))
    finally:
        teng.associate_many = orig
    assert calls and max(calls) == 2, calls


def _write_sequence(root, name, seed, color, x0, n=8, features=False):
    """A one-object MOTChallenge sequence (tests/test_lockstep_busca.py's):
    img1/*.jpg, det/det.txt, gt/gt.txt, seqinfo.ini; with ``features`` also
    ``<root>/<name>.npy`` (det rows + a constant 8-d feature)."""
    import cv2

    d = root / name
    (d / "img1").mkdir(parents=True)
    (d / "det").mkdir()
    (d / "gt").mkdir()
    seq = SyntheticSequence(
        [SyntheticObject(color=np.array(color, np.float64), x0=x0, y0=40,
                         vx=2.0, vy=0.5, w=26, h=56)],
        num_frames=n, height=160, width=280, seed=seed)
    rows = []
    for t in range(n):
        cv2.imwrite(str(d / "img1" / f"{t + 1:06d}.jpg"), seq.frame(t))
        boxes, scores = seq.detections(t)
        for b, s in zip(boxes, scores):
            rows.append(f"{t + 1},-1,{b[0]:.2f},{b[1]:.2f},"
                        f"{b[2] - b[0]:.2f},{b[3] - b[1]:.2f},{s:.3f},"
                        "-1,-1,-1")
    (d / "det" / "det.txt").write_text("\n".join(rows) + "\n")
    (d / "gt" / "gt.txt").write_text("".join(
        f"{f},{gid},{b[0]:.2f},{b[1]:.2f},{b[2]:.2f},{b[3]:.2f},1,1,1\n"
        for f, (boxes, ids) in sorted(seq.ground_truth().items())
        for b, gid in zip(boxes, ids)))
    (d / "seqinfo.ini").write_text(
        f"[Sequence]\nname={name}\nimDir=img1\nframeRate=30\n"
        f"seqLength={n}\nimWidth=280\nimHeight=160\nimExt=.jpg\n")
    if features:
        det = np.loadtxt(d / "det" / "det.txt", delimiter=",", ndmin=2)
        feats = np.tile(np.eye(1, 8, seed % 8), (len(det), 1))
        np.save(root / f"{name}.npy", np.concatenate([det, feats], 1))
    return str(d)


def _assert_runs_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.num_frames == w.num_frames
        assert _canon(g.results) == _canon(w.results)


def test_cached_det_lockstep_matches_run_mot_sequence(tmp_path):
    pytest.importorskip("cv2")
    dirs = [_write_sequence(tmp_path, f"CD-{si}", si,
                            [60 + 90 * si, 180, 90], 30 + 40 * si)
            for si in range(2)]
    Track.reset_id_counter()
    lock = trunner.run_mot_sequences_lockstep(dirs, [_byte(), _byte()])
    solos = []
    for d in dirs:
        Track.reset_id_counter()
        solos.append(trunner.run_mot_sequence(d, _byte()))
    _assert_runs_equal(lock, solos)
    JTrack.reset_id_counter()
    want = jrunner.run_mot_sequences_lockstep(
        dirs, [_byte(jax=True), _byte(jax=True)])
    _assert_runs_equal(lock, want)


def test_ghost_lockstep_via_shim_matches_standalone(tmp_path):
    pytest.importorskip("cv2")
    dirs = [_write_sequence(tmp_path, f"GL-{si}", si + 5,
                            [70 + 60 * si, 170, 100], 30 + 50 * si)
            for si in range(2)]

    def mk(jax=False):
        if jax:
            return jrun.FeatureShim(JGhost(JGhostCfg(use_busca=True),
                                           JStubEngine(kalman_prob=1.0)))
        return trun.FeatureShim(GhostTracker(GhostConfig(use_busca=True),
                                             StubEngine(kalman_prob=1.0)))

    lock = trunner.run_mot_sequences_lockstep(dirs, [mk(), mk()])
    solos = [trunner.run_mot_sequence(d, mk()) for d in dirs]
    _assert_runs_equal(lock, solos)
    want = jrunner.run_mot_sequences_lockstep(dirs, [mk(True), mk(True)])
    _assert_runs_equal(lock, want)


def test_strongsort_npy_lockstep_matches_run_cached_sequence(tmp_path):
    """StrongSORT's ``.npy`` artifacts: the lockstep runner (sequences of
    8 and 6 frames, one with an ECC warp) against ``run_cached_sequence``
    per sequence and against busca_tpu's lockstep runner."""
    pytest.importorskip("cv2")
    dirs = [_write_sequence(tmp_path, f"SS-{si}", si + 2,
                            [80 + 70 * si, 160, 110], 30 + 60 * si,
                            n=8 - 2 * si, features=True)
            for si in range(2)]
    warps = {3: np.array([[1.0, 0, 2.5], [0, 1, -1.0], [0, 0, 1]])}
    specs = [(d, str(tmp_path / f"{os.path.basename(d)}.npy"), w)
             for d, w in zip(dirs, (warps, None))]

    def mk(jax=False):
        if jax:
            return JSS(JSSCfg(use_busca=True), JStubEngine(kalman_prob=1.0))
        return StrongSortTracker(StrongSortConfig(use_busca=True),
                                 StubEngine(kalman_prob=1.0))

    kw = dict(min_confidence=0.3)
    Track.reset_id_counter()
    lock = tss_io.run_cached_sequences_lockstep(specs, [mk(), mk()], **kw)
    solos = []
    for d, f, w in specs:
        Track.reset_id_counter()
        solos.append(tss_io.run_cached_sequence(d, f, mk(), ecc_warps=w,
                                                **kw))
    assert [r.num_frames for r in lock] == [8, 6]
    assert sum(len(r[2]) for res in lock for r in res.results) > 0
    _assert_runs_equal(lock, solos)
    JTrack.reset_id_counter()
    want = jss_io.run_cached_sequences_lockstep(specs, [mk(True), mk(True)],
                                                **kw)
    _assert_runs_equal(lock, want)
