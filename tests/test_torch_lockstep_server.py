"""The port's lockstep tracking server (busca_tpu_torch/serve/lockstep.py)
on the CPU: every case of tests/test_lockstep_server.py but the dp-sharded
one (ROADMAP.md Queue 1 item 23), on the port (each stream equals its own
sequential loop after relabelling ids by first appearance; ticks coalesce;
a straggler does not stall its peers; streams join and leave; a tick's
failure errors only the streams it has not serviced; unix-socket serving;
one grouped association across resolution groups), plus

- parity with busca_tpu's ``LockstepTrackingServer``: the same
  content-keyed stub detections through both servers with ByteTrack + BUSCA
  on the small engines of tests/test_torch_byte_pipeline.py (weights
  converted from busca_tpu's): every stream's replies equal, ids after
  relabelling, tlwh within 0.1 px, third-round probabilities within 0.0242
  (PERF.md section 2's bars);
- the port's one deliberate difference, pinned: the detector sees each
  tick's unpadded batch sizes where busca_tpu pads to powers of two;
- a lockstep stream snapshotted mid-run and restored on a fresh server
  over a new connection equals the unbroken stream;
- the CLI's ``--lockstep`` / ``--tick-timeout`` / ``--mem-cap``: a
  ``--device cpu`` drive with two clients, and busca_tpu's refusals.
"""

import socket
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from busca_tpu_torch.eval.synthetic import default_dropout_sequence
from busca_tpu_torch.serve import lockstep as lockstep_mod
from busca_tpu_torch.serve import server as server_mod
from busca_tpu_torch.serve.lockstep import LockstepTrackingServer
from busca_tpu_torch.serve.server import TrackingClient
from busca_tpu_torch.trackers.base import Track
from busca_tpu_torch.trackers.byte import ByteTracker, ByteTrackerConfig
from test_torch_byte_pipeline import (  # noqa: F401 (the fixture)
    CROP_HW,
    PROB_TOL,
    SMALL,
    engines,
)
from test_torch_lockstep import _canon
from test_torch_server import _frames as _noise_frames
from test_torch_server import _wait_for_socket
from test_torch_strongsort import StubEngine, one_torch_thread  # noqa: F401
from test_torch_yolox_loop import LOOP_BOX_TOL

# stub-engine trackers crop small (the default 384x128 crops only slow the
# CPU down: the stub's vote does not read them)
STUB_KW = dict(use_busca=True, crop_hw=CROP_HW,
               use_camera_motion_compensation=False)


class StubBatchDetector:
    """Content-keyed stub (tests/test_lockstep_server.py's): each frame's
    [0, 0] pixel encodes (sequence, t), so detections do not depend on the
    tick's composition or order.  ``batch_sizes`` logs each call's size."""

    def __init__(self, dets_per_seq):
        self.dets = dets_per_seq
        self.batch_sizes = []

    def detect_batch(self, frames):
        frames = np.asarray(frames)
        self.batch_sizes.append(len(frames))
        outs = []
        for f in frames:
            si, t = int(f[0, 0, 0]), int(f[0, 0, 1])
            boxes, scores = self.dets[si][t]
            outs.append(types.SimpleNamespace(
                boxes_tlbr=boxes, scores=scores, scale=1.0, image=f))
        return outs

    def detect(self, frame):
        return self.detect_batch(np.asarray(frame)[None])[0]


def _mk_tracker():
    return ByteTracker(ByteTrackerConfig(**STUB_KW),
                       assoc_engine=StubEngine(kalman_prob=1.0))


def _marked_sequences(n_seqs=3, n_frames=20):
    seqs = [default_dropout_sequence(n_frames, seed=s) for s in range(n_seqs)]
    dets, frames = [], []
    for si, s in enumerate(seqs):
        dets.append([s.detections(t) for t in range(n_frames)])
        fs = []
        for t in range(n_frames):
            f = s.frame(t).copy()
            f[0, 0] = (si, t, 0)
            fs.append(f)
        frames.append(fs)
    return dets, frames


def _rows(replies):
    return [(r["frame_id"], [t["tlwh"] for t in r["tracks"]],
             [t["id"] for t in r["tracks"]],
             [t["score"] for t in r["tracks"]]) for r in replies]


def _sequential_reference(dets, frames, make=_mk_tracker):
    from busca_tpu_torch.eval.runner import filter_output_tracks

    want = []
    for si in range(len(dets)):
        Track.reset_id_counter()
        trk = make()
        rows = []
        for t, ((boxes, scores), frame) in enumerate(zip(dets[si],
                                                         frames[si])):
            online = trk.update(boxes, scores, 1.0, frame)
            tlwhs, ids, confs = filter_output_tracks(online, 100.0, 1.6)
            rows.append((t + 1, tlwhs, ids, confs))
        want.append(_canon(rows))
    return want


def _connect(server, n):
    """``n`` socketpair connections served on threads of ``server``."""
    conns = [socket.socketpair() for _ in range(n)]
    threads = [threading.Thread(target=server.serve_connection, args=(srv,),
                                daemon=True) for srv, _ in conns]
    for t in threads:
        t.start()
    return [TrackingClient(c) for _, c in conns], threads


def _run_streams(server, frames, barrier=True, stagger=0.0, client_cls=None):
    """One client thread per stream, each frame submitted together (a
    barrier) or freely; returns each stream's replies."""
    n = len(frames)
    server.start_scheduler()
    clients, threads = _connect(server, n)
    if client_cls is not None:
        clients = [client_cls(c.conn) for c in clients]
    gate = threading.Barrier(n) if barrier else None

    def run(si):
        time.sleep(stagger * si)
        client = clients[si]
        assert client.start(f"seq-{si}")["ok"]
        out = []
        for frame in frames[si]:
            if gate is not None:
                gate.wait(timeout=60)
            r = client.frame(frame)
            assert r["ok"], r
            out.append(r)
        client.stop()
        return out

    with ThreadPoolExecutor(n) as pool:
        got = list(pool.map(run, range(n)))
    for t in threads:
        t.join(timeout=10)
    server.close()
    return got


# -------------------- the cases of tests/test_lockstep_server.py -----------

def test_lockstep_server_matches_sequential_and_batches():
    dets, frames = _marked_sequences(n_seqs=3, n_frames=20)
    detector = StubBatchDetector(dets)
    server = LockstepTrackingServer(detector, _mk_tracker, tick_timeout=0.25)
    got = _run_streams(server, frames)
    want = _sequential_reference(dets, frames)
    for si in range(3):
        assert _canon(_rows(got[si])) == want[si], f"stream {si} diverged"
    # the scheduler batched: three synchronized streams coalesce, and the
    # detector sees the unpadded batch (busca_tpu pads 3 to 4)
    assert max(detector.batch_sizes) == 3, detector.batch_sizes
    assert sum(detector.batch_sizes) == 60  # every frame, no pad lane
    assert all(r["batch"] >= 1 for rs in got for r in rs)


def test_straggler_does_not_stall_peers():
    dets, frames = _marked_sequences(n_seqs=2, n_frames=3)
    server = LockstepTrackingServer(StubBatchDetector(dets), _mk_tracker,
                                    tick_timeout=0.05)
    server.start_scheduler()
    (fast, slow), threads = _connect(server, 2)
    fast.start("fast")
    slow.start("slow")  # active, but never sends a frame
    t0 = time.monotonic()
    for t in range(3):
        assert fast.frame(frames[0][t])["ok"]
    # 3 frames, each waiting at most tick_timeout for the idle peer
    assert time.monotonic() - t0 < 3.0
    fast.stop()
    slow.stop()
    for t in threads:
        t.join(timeout=10)
    server.close()


def test_chaotic_joins_and_leaves_keep_streams_independent():
    """Streams of different lengths joining at staggered times: each equals
    its own sequential loop whatever ticks it shared."""
    lengths = [6, 14, 10, 18, 4]
    dets, frames = _marked_sequences(n_seqs=5, n_frames=20)
    dets = [d[:n] for d, n in zip(dets, lengths)]
    frames = [f[:n] for f, n in zip(frames, lengths)]
    server = LockstepTrackingServer(
        StubBatchDetector([d + d[-1:] * 20 for d in dets]), _mk_tracker,
        tick_timeout=0.02)
    got = _run_streams(server, frames, barrier=False, stagger=0.01)
    want = _sequential_reference(dets, frames)
    for si in range(5):
        assert _canon(_rows(got[si])) == want[si], f"stream {si} diverged"


def test_tick_error_isolated_to_unserviced_streams():
    """A stream whose output breaks mid-tick gets an error reply; a stream
    already serviced in the same tick keeps its good reply, and the
    scheduler keeps serving."""
    dets, frames = _marked_sequences(n_seqs=2, n_frames=4)

    class _Poison:
        pass  # no .tlwh: filter_output_tracks raises

    made = []

    def factory():
        trk = _mk_tracker()
        if len(made) == 1:  # the second stream to start
            orig = trk.update_deferred
            calls = [0]

            def poisoned(*a, **k):
                calls[0] += 1
                if calls[0] == 1:
                    # poison output on frame 1 only: the reply loop chokes
                    # on it after the first stream was serviced
                    def gen():
                        return [_Poison()]
                        yield  # pragma: no cover - makes a generator

                    return gen()
                return orig(*a, **k)

            trk.update_deferred = poisoned
        made.append(trk)
        return trk

    server = LockstepTrackingServer(StubBatchDetector(dets), factory,
                                    tick_timeout=0.25)
    server.start_scheduler()
    (a, b), threads = _connect(server, 2)
    assert a.start("a")["ok"]
    assert b.start("b")["ok"]
    barrier = threading.Barrier(2)
    replies = {0: [], 1: []}

    def run(si, client):
        for t in range(4):
            barrier.wait(timeout=30)
            replies[si].append(client.frame(frames[si][t]))
        client.stop()

    ta = threading.Thread(target=run, args=(0, a), daemon=True)
    tb = threading.Thread(target=run, args=(1, b), daemon=True)
    ta.start(), tb.start()
    ta.join(timeout=30), tb.join(timeout=30)
    for t in threads:
        t.join(timeout=10)
    server.close()
    assert all(r["ok"] for r in replies[0]), replies[0]
    assert not replies[1][0]["ok"]
    assert all(r["ok"] for r in replies[1][1:]), replies[1]


def test_unix_socket_lockstep_serving(tmp_path):
    dets, frames = _marked_sequences(n_seqs=2, n_frames=4)
    path = str(tmp_path / "lock.sock")
    server = LockstepTrackingServer(StubBatchDetector(dets), _mk_tracker,
                                    tick_timeout=0.05)
    t = threading.Thread(target=server.serve_unix, args=(path,),
                         kwargs={"max_connections": 2}, daemon=True)
    t.start()

    def stream(si):
        client = _wait_for_socket(path)
        client.start(f"s{si}")
        out = [client.frame(f)["ok"] for f in frames[si]]
        client.stop()
        return out

    with ThreadPoolExecutor(2) as pool:
        oks = list(pool.map(stream, range(2)))
    assert all(all(o) for o in oks)
    t.join(timeout=30)
    assert not t.is_alive()


def test_mixed_resolution_tick_batches_one_association(monkeypatch):
    """Streams at different resolutions split the detector batch by shape
    but share ONE grouped third-round association per tick."""
    from busca_tpu_torch.trackers import base as base_mod

    dets, frames = _marked_sequences(n_seqs=2, n_frames=6)
    frames[1] = [np.pad(f, ((0, 16), (0, 0), (0, 0))) for f in frames[1]]
    det = StubBatchDetector(dets)
    calls = []
    real = base_mod.service_deferred_updates

    def counting(pending):
        calls.append(len(pending))
        return real(pending)

    monkeypatch.setattr(base_mod, "service_deferred_updates", counting)
    server = lockstep_mod.LockstepTrackingServer(det, _mk_tracker,
                                                 tick_timeout=0.5)
    server.start_scheduler()
    try:
        sessions = []
        for _ in range(2):
            with server._lock:
                s = lockstep_mod._Session(next(server._sid))
                server._sessions[s.sid] = s
                s.tracker = _mk_tracker()
            sessions.append(s)
        for t in range(6):
            replies = {}

            def submit(s, f):
                replies[s.sid] = server._submit_frame(
                    s, {"cmd": "frame", "shape": list(f.shape)}, f.tobytes())

            ths = [threading.Thread(target=submit, args=(s, frames[si][t]))
                   for si, s in enumerate(sessions)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=30)
            assert all(r["ok"] for r in replies.values()), replies
    finally:
        server.close()
    # two resolutions per tick, one detector call each ...
    assert det.batch_sizes == [1] * 12, det.batch_sizes
    # ... but one association whenever both streams deferred a third round
    assert any(c == 2 for c in calls), calls


# ----------------------------- added here -----------------------------------

def _pool_logged(engine, log):
    """Spy on ``associate_many``: each request's pool track ids and its
    probability matrix."""
    orig = engine.associate_many

    def associate_many(requests, **kw):
        out = orig(requests, **kw)
        for (tracks, *_), (probs, _) in zip(requests, out):
            log.append(([t.track_id for t in tracks],
                        None if probs is None else np.array(probs)))
        return out

    engine.associate_many = associate_many
    return orig


def _probs_by_stream(log, replies):
    """The logged third-round probabilities per stream, in order: a pool's
    tracks were output by one stream (raw ids are unique per package)."""
    owner = {t["id"]: si for si, rs in enumerate(replies)
             for r in rs for t in r["tracks"]}
    out = [[] for _ in replies]
    for ids, probs in log:
        if probs is not None:
            out[owner[ids[0]]].append(probs)
    return out


def test_lockstep_server_matches_busca_tpu_server(engines):
    """The same content-keyed stub detections through busca_tpu's and the
    port's lockstep servers, ByteTrack + BUSCA on the small engines with
    the same weights, every tick full (a barrier per frame): every stream's
    replies equal after relabelling ids, tlwh within 0.1 px, third-round
    probabilities within 0.0242; busca_tpu's detector sees the batches
    padded to powers of two, the port's does not."""
    from busca_tpu.serve.lockstep import LockstepTrackingServer as JServer
    from busca_tpu.serve.server import TrackingClient as JClient
    from busca_tpu.trackers.base import Track as JTrack
    from busca_tpu.trackers.byte import ByteTracker as JByte
    from busca_tpu.trackers.byte import ByteTrackerConfig as JByteCfg

    jeng, teng = engines
    kw = dict(use_busca=True, crop_hw=CROP_HW, busca_thresh=0.1,
              select_highest_candidate=False,
              use_camera_motion_compensation=False)
    dets, frames = _marked_sequences(n_seqs=3, n_frames=28)
    got, logs, sizes = {}, {}, {}
    for key, server_cls, client_cls, make, reset, eng in (
            ("j", JServer, JClient, lambda: JByte(JByteCfg(**kw), jeng),
             JTrack.reset_id_counter, jeng),
            ("t", LockstepTrackingServer, TrackingClient,
             lambda: ByteTracker(ByteTrackerConfig(**kw), teng),
             Track.reset_id_counter, teng)):
        reset()
        det = StubBatchDetector(dets)
        logs[key] = []
        orig = _pool_logged(eng, logs[key])
        try:
            got[key] = _run_streams(server_cls(det, make, tick_timeout=1.0),
                                    frames, client_cls=client_cls)
        finally:
            eng.associate_many = orig
        sizes[key] = det.batch_sizes
    assert sizes["j"] == [4] * 28 and sizes["t"] == [3] * 28, sizes
    jprobs = _probs_by_stream(logs["j"], got["j"])
    tprobs = _probs_by_stream(logs["t"], got["t"])
    third = 0
    for si in range(3):
        want, have = _canon(_rows(got["j"][si])), _canon(_rows(got["t"][si]))
        assert [f for f, _ in have] == [f for f, _ in want]
        for (fid, hrows), (_, wrows) in zip(have, want):
            assert [r[4] for r in hrows] == [r[4] for r in wrows], \
                f"stream {si} frame {fid}: ids diverged"
            np.testing.assert_allclose(
                np.array([r[:4] for r in hrows]).reshape(-1, 4),
                np.array([r[:4] for r in wrows]).reshape(-1, 4), rtol=0,
                atol=LOOP_BOX_TOL, err_msg=f"stream {si} frame {fid}")
        assert len(tprobs[si]) == len(jprobs[si]), f"stream {si}"
        for pt, pj in zip(tprobs[si], jprobs[si]):
            np.testing.assert_allclose(pt, pj, rtol=0, atol=PROB_TOL)
            third += 1
    assert third >= 6, "the dropouts never reached the third round"


def test_lockstep_snapshot_restore_on_fresh_server():
    """Stream 0 of two lockstep streams is snapshotted after frame 5 and
    restored on a fresh server over a new connection, beside a fresh
    stream 1: its replies equal the unbroken stream's (ids relabelled: the
    id counter is shared by every stream in the process)."""
    dets, frames = _marked_sequences(n_seqs=2, n_frames=16)
    cut = 5
    Track.reset_id_counter()
    unbroken = _run_streams(LockstepTrackingServer(
        StubBatchDetector(dets), _mk_tracker, tick_timeout=0.25), frames)

    key = b"lockstep-snapshot-key"
    Track.reset_id_counter()
    server = LockstepTrackingServer(StubBatchDetector(dets), _mk_tracker,
                                    tick_timeout=0.25, snapshot_key=key)
    server.start_scheduler()
    (a,), threads = _connect(server, 1)
    assert a.start("a")["ok"]
    head = [a.frame(f) for f in frames[0][:cut]]
    header, blob = a.snapshot()
    assert header["frame_id"] == cut and blob.startswith(b"BSNPSIG1")
    a.stop()
    threads[0].join(timeout=10)
    server.close()

    Track.reset_id_counter()  # a fresh process
    server = LockstepTrackingServer(StubBatchDetector(dets), _mk_tracker,
                                    tick_timeout=0.25, snapshot_key=key)
    server.start_scheduler()
    (a, b), threads = _connect(server, 2)
    reply = a.restore(blob)
    assert reply["ok"] and reply["frame_id"] == cut, reply
    assert b.start("b")["ok"]
    tail = []

    def run_b():
        for f in frames[1]:
            assert b.frame(f)["ok"]

    tb = threading.Thread(target=run_b)
    tb.start()
    for f in frames[0][cut:]:
        tail.append(a.frame(f))
    tb.join(timeout=60)
    a.stop()
    b.stop()
    for t in threads:
        t.join(timeout=10)
    server.close()
    assert [r["frame_id"] for r in tail] == list(range(cut + 1, 17))
    assert _canon(_rows(head + tail)) == _canon(_rows(unbroken[0]))


# --------------------------------- the CLI ----------------------------------

def test_serve_cli_lockstep_mem_cap_cpu_drive(tmp_path,
                                              one_torch_thread):  # noqa
    """``python -m busca_tpu_torch.serve.server --lockstep --tick-timeout
    0.05 --mem-cap 64 --device cpu`` end to end: YOLOX-tiny (random
    weights) and BUSCA (a small YAML model), two clients at once."""
    import yaml

    cfg = str(tmp_path / "busca.yml")
    with open(cfg, "w") as f:
        yaml.safe_dump({"transformer": dict(
            SMALL, reid_layers=list(SMALL["reid_layers"]))}, f)
    path = str(tmp_path / "lockstep.sock")
    made = []
    real = server_mod.build_tracker_runtime

    def spy(args):
        engine, factory = real(args)

        def factory_spy():
            made.append(factory())
            return made[-1]
        return engine, factory_spy

    t = threading.Thread(target=_main_with, args=(spy, [
        "--socket", path, "--detector", "yolox-tiny", "--test-h", "64",
        "--test-w", "128", "--use-busca", "--busca-config", cfg,
        "--crop-h", str(CROP_HW[0]), "--crop-w", str(CROP_HW[1]),
        "--lockstep", "--tick-timeout", "0.05", "--mem-cap", "64",
        "--device", "cpu", "--max-connections", "2"]), daemon=True)
    t.start()
    frames = _noise_frames(np.random.RandomState(5), n=3, hw=(64, 128))

    def stream(si):
        client = _wait_for_socket(path)
        assert client.start(f"cli-{si}")["ok"]
        out = [client.frame(f) for f in frames]
        client.stop()
        return out

    with ThreadPoolExecutor(2) as pool:
        got = list(pool.map(stream, range(2)))
    t.join(timeout=60)
    assert not t.is_alive()
    for replies in got:
        assert [r["frame_id"] for r in replies] == [1, 2, 3], replies
        assert all(r["ok"] and r["batch"] in (1, 2) for r in replies)
    assert len(made) == 2 and all(m.cfg.mem_cap == 64 for m in made)


def _main_with(spy, argv):
    orig = server_mod.build_tracker_runtime
    server_mod.build_tracker_runtime = spy
    try:
        server_mod.main(argv)
    finally:
        server_mod.build_tracker_runtime = orig


@pytest.mark.parametrize("argv,message", [
    (["--detector", "transcenter", "--tracker", "transcenter",
      "--lockstep"], "transcenter cannot lockstep"),
    (["--detector", "centertrack", "--tracker", "centertrack",
      "--lockstep"], "centertrack cannot lockstep"),
    (["--detector", "yolox-tiny", "--mem-cap", "2"],
     "--mem-cap must be >= 4"),
    (["--detector", "yolox-tiny", "--tracker", "sort", "--mem-cap", "64"],
     "--mem-cap only applies to the byte-family trackers"),
    (["--detector", "yolox-tiny", "--lockstep", "--lockstep-dp", "2"],
     "ROADMAP.md Queue 1 item 23"),
])
def test_serve_cli_lockstep_and_mem_cap_refusals(argv, message, capsys):
    with pytest.raises(SystemExit) as e:
        server_mod.main(["--socket", "/tmp/x.sock", "--test-h", "64",
                         "--test-w", "128", "--device", "cpu"] + argv)
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_build_tracker_runtime_mem_cap_checks():
    """``build_tracker_runtime`` validates ``mem_cap`` at start-up with
    busca_tpu's messages, and its trackers carry the cap."""
    from busca_tpu.serve.server import build_tracker_runtime as jbuild

    for build in (server_mod.build_tracker_runtime, jbuild):
        args = types.SimpleNamespace(use_busca=False, reid_ckpt=None,
                                     tracker="byte", track_thresh=0.5,
                                     mem_cap=3)
        with pytest.raises(ValueError, match="must be >= 4"):
            build(args)
        args.mem_cap, args.tracker = 64, "motdt"
        with pytest.raises(ValueError, match="byte-family trackers"):
            build(args)
        args.tracker = "byte"
        _, factory = build(args)
        assert factory().cfg.mem_cap == 64
