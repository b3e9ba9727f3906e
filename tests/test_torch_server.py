"""The port's tracking server (busca_tpu_torch/serve/server.py) on the CPU:
every test of tests/test_server.py but the lockstep ones, on the port (the
wire protocol, equality with the in-process loop, in-band errors, the
feedback hook, unix-socket serving and its robustness, the CLI's runtime
wiring), plus

- parity with busca_tpu's server: the same frames through both packages'
  ``TrackingServer`` with the same weights (the designed colour YOLOX of
  tests/test_torch_yolox_loop.py, so that decisions have margins, and the
  small BUSCA engines of tests/test_torch_byte_pipeline.py): ids equal,
  tlwh within the YOLOX loop's 0.1 frame pixels;
- the frame arrives writable (no copy, no warning on its upload);
- the CLI: a ``--device cpu`` drive end to end, the servers its
  ``--detector-artifact``, ``--lockstep``, ``--tick-timeout`` and
  ``--mem-cap`` build, and its refusal of every flag whose machinery is
  not ported, naming the ROADMAP item.

The lockstep server has its own file, tests/test_torch_lockstep_server.py.
"""

import socket
import struct
import threading
import time
import types
import warnings

import numpy as np
import pytest
import torch

from busca_tpu_torch.serve import server as server_mod
from busca_tpu_torch.serve.server import (
    TrackingClient,
    TrackingServer,
    recv_msg,
    send_msg,
)
from test_torch_byte_pipeline import CROP_HW, SMALL, engines  # noqa: F401
from test_torch_strongsort import StubEngine, one_torch_thread  # noqa: F401


def _tiny_detector():
    from busca_tpu_torch.eval.detector import YoloxDetector
    from busca_tpu_torch.models.yolox import YoloxConfig

    return YoloxDetector(YoloxConfig(depth=0.33, width=0.125, num_classes=1),
                         None, test_size=(64, 96), conf_thresh=0.05,
                         max_outputs=16, pre_nms_topk=64, device="cpu")


def colour_yolox():
    """The port's tiny YOLOX designed as a colour detector (float32
    ``bright_object_state`` of tests/test_torch_yolox_loop.py: margins on
    every decision) and its frames (the dropout sequence, object 1 drawn
    dark in its dropout window)."""
    from busca_tpu_torch.eval.detector import YoloxDetector
    from busca_tpu_torch.models.yolox import YoloxConfig
    from test_torch_yolox_loop import (
        CONF,
        TEST_SIZE,
        TINY,
        _bf16_frames,
        bright_object_state,
    )

    cfg = YoloxConfig(*TINY)
    det = YoloxDetector(cfg, bright_object_state(cfg), test_size=TEST_SIZE,
                        conf_thresh=CONF, nms_thresh=0.7, max_outputs=32,
                        device="cpu")
    return det, _bf16_frames


def _byte_factory():
    from busca_tpu_torch.trackers.base import Track
    from busca_tpu_torch.trackers.byte import ByteTracker, ByteTrackerConfig

    Track.reset_id_counter()
    return ByteTracker(ByteTrackerConfig(track_thresh=0.3), None)


def _frames(rng, n=5, hw=(48, 80)):
    frames = []
    for f in range(n):
        img = rng.randint(0, 255, (*hw, 3)).astype(np.uint8)
        x = 8 + 4 * f
        img[16:40, x:x + 14] = (0, 255, 0)
        frames.append(img)
    return frames


def _serve_on_thread(server):
    srv_sock, cli_sock = socket.socketpair()
    t = threading.Thread(target=server.serve_connection, args=(srv_sock,),
                         daemon=True)
    t.start()
    return TrackingClient(cli_sock), t


SOCKET_WAIT_S = 60.0


def _wait_for_socket(path):
    """Connect once the server listens.  The wait covers start-up, not a
    bar on it: a server that first loads three exported programs takes
    ~7 s to listen on an idle CPU and more beside the suite's workers."""
    deadline = time.monotonic() + SOCKET_WAIT_S
    while time.monotonic() < deadline:
        try:
            return TrackingClient.connect_unix(path)
        except (FileNotFoundError, ConnectionRefusedError):
            time.sleep(0.05)
    pytest.fail("server socket never came up")


@pytest.fixture(scope="module")
def detector():
    return _tiny_detector()


def test_protocol_roundtrip():
    a, b = socket.socketpair()
    payload = bytes(range(256))
    send_msg(a, {"cmd": "frame", "shape": [2, 2]}, payload)
    header, got = recv_msg(b)
    assert header["cmd"] == "frame" and header["payload_bytes"] == 256
    assert got == payload
    # close -> None (a clean EOF), not an exception
    a.close()
    assert recv_msg(b) is None
    b.close()


def test_protocol_is_busca_tpus():
    """The same bytes on the wire as busca_tpu's: a message written by one
    package is read by the other's."""
    from busca_tpu.serve import server as jserver

    a, b = socket.socketpair()
    jserver.send_msg(a, {"cmd": "frame", "shape": [1, 2, 3]}, b"abcdef")
    assert recv_msg(b) == ({"cmd": "frame", "shape": [1, 2, 3],
                            "payload_bytes": 6}, b"abcdef")
    send_msg(b, {"ok": True}, memoryview(b"xyz"))
    assert jserver.recv_msg(a) == ({"ok": True, "payload_bytes": 3}, b"xyz")
    a.close()
    b.close()


def test_server_matches_inprocess_loop(detector,
                                       one_torch_thread):  # noqa: F811
    from busca_tpu_torch.eval.runner import filter_output_tracks

    server = TrackingServer(detector, _byte_factory)
    client, thread = _serve_on_thread(server)
    frames = _frames(np.random.RandomState(0))
    assert client.start("seq-a")["ok"]
    via_server = [client.frame(f) for f in frames]
    assert client.stop()["ok"]
    thread.join(timeout=10)
    assert not thread.is_alive()

    tracker = _byte_factory()
    for reply, frame in zip(via_server, frames):
        det = detector.detect(frame)
        online = tracker.update(det.boxes_tlbr / det.scale, det.scores,
                                det.scale, det.image)
        tlwhs, ids, confs = filter_output_tracks(online, 100.0, 1.6)
        assert reply["ok"]
        assert [t["id"] for t in reply["tracks"]] == [int(i) for i in ids]
        for t, tlwh, c in zip(reply["tracks"], tlwhs, confs):
            assert t["tlwh"] == [float(v) for v in tlwh]
            assert t["score"] == float(c)


def test_server_error_handling_keeps_serving(detector):
    server = TrackingServer(detector, _byte_factory)
    client, thread = _serve_on_thread(server)
    frame = _frames(np.random.RandomState(1), n=1)[0]
    # a frame before start: an error, the connection survives
    r = client.frame(frame)
    assert not r["ok"] and "start" in r["error"]
    assert client.start()["ok"]
    # a bad payload size: an error, the sequence survives
    r = client._roundtrip({"cmd": "frame", "shape": [48, 80, 3]}, b"xy")
    assert not r["ok"] and "bytes" in r["error"]
    r = client._roundtrip({"cmd": "frame", "shape": [48, 80]}, b"xy")
    assert not r["ok"] and "shape" in r["error"]
    r = client._roundtrip({"cmd": "nope"})
    assert not r["ok"]
    # the sequence still tracks
    assert client.frame(frame)["ok"]
    client.stop()
    thread.join(timeout=10)


def test_start_resets_sequence(detector):
    server = TrackingServer(detector, _byte_factory)
    client, thread = _serve_on_thread(server)
    frame = _frames(np.random.RandomState(2), n=1)[0]
    client.start("a")
    assert client.frame(frame)["frame_id"] == 1
    assert client.frame(frame)["frame_id"] == 2
    client.start("b")
    assert client.frame(frame)["frame_id"] == 1  # a fresh tracker + counter
    client.stop()
    thread.join(timeout=10)


class _StubDetector:
    """Replays a sequence's detections, one frame per call."""

    def __init__(self, dets):
        self.dets, self.t = dets, -1

    def detect(self, frame):
        from busca_tpu_torch.eval.detector import DetectorOutput

        self.t += 1
        boxes, scores = self.dets[self.t]
        return DetectorOutput(boxes, scores, np.asarray(frame), 1.0)


def test_server_busca_rescue_through_dropout():
    """BUSCA through the serving surface: a detector dropout window does not
    end the track when the third round votes for the Kalman candidate."""
    from busca_tpu_torch.eval.synthetic import default_dropout_sequence
    from busca_tpu_torch.trackers.base import Track
    from busca_tpu_torch.trackers.byte import ByteTracker, ByteTrackerConfig

    n = 24
    seq = default_dropout_sequence(n, seed=0)

    def factory():
        Track.reset_id_counter()
        return ByteTracker(ByteTrackerConfig(use_busca=True),
                           assoc_engine=StubEngine(kalman_prob=1.0))

    server = TrackingServer(
        _StubDetector([seq.detections(t) for t in range(n)]), factory)
    client, thread = _serve_on_thread(server)
    assert client.start("dropout")["ok"]
    counts = []
    for t in range(n):
        r = client.frame(seq.frame(t))
        assert r["ok"] and "ms" in r
        counts.append(len(r["tracks"]))
    client.stop()
    thread.join(timeout=10)
    # through the dropout window every object stays tracked
    assert min(counts[3:]) >= 2


def test_server_passes_feedback_to_stateful_detector():
    """A ``uses_feedback`` detector gets the tracker's current positions
    each frame, and a per-sequence reset first."""
    from busca_tpu_torch.eval.detector import DetectorOutput
    from busca_tpu_torch.trackers.byte import ByteTrackerConfig
    from busca_tpu_torch.trackers.transcenter import TransCenterByteTracker

    seen = []

    class _FeedbackDetector:
        uses_feedback = True

        def reset(self):
            seen.append("reset")

        def detect(self, frame, current_pos="MISSING"):
            # an empty tracker exports None; the point is that the keyword
            # was passed, not defaulted
            seen.append(current_pos)
            return DetectorOutput(np.zeros((0, 4)), np.zeros(0),
                                  np.asarray(frame), 1.0)

    server = TrackingServer(
        _FeedbackDetector(),
        lambda: TransCenterByteTracker(ByteTrackerConfig()))
    client, thread = _serve_on_thread(server)
    assert client.start("tc")["ok"]
    frame = np.zeros((48, 80, 3), np.uint8)
    assert client.frame(frame)["ok"]
    assert client.frame(frame)["ok"]
    client.stop()
    thread.join(timeout=10)
    assert seen[0] == "reset"  # per sequence (mot_evaluator.py:148-150)
    assert len(seen) == 3 and all(s is None for s in seen[1:])


def test_served_frame_is_writable_and_uploads_without_warning():
    """The frame wraps the received buffer, which is writable: it goes to a
    tensor with no copy and no non-writable-array warning."""
    from busca_tpu_torch.eval.detector import DetectorOutput

    got = []

    class _Probe:
        def detect(self, frame):
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                tensor = torch.as_tensor(frame)
            got.append((frame.flags.writeable, frame.flags.owndata,
                        tensor.data_ptr() == frame.ctypes.data,
                        frame.copy()))
            return DetectorOutput(np.zeros((0, 4)), np.zeros(0), frame, 1.0)

    server = TrackingServer(_Probe(), _byte_factory)
    client, thread = _serve_on_thread(server)
    frame = _frames(np.random.RandomState(4), n=1)[0]
    assert client.start()["ok"]
    assert client.frame(frame)["ok"]
    client.stop()
    thread.join(timeout=10)
    writeable, owndata, shared, seen = got[0]
    assert writeable and not owndata and shared
    np.testing.assert_array_equal(seen, frame)


def test_bind_refuses_live_socket_and_replaces_stale(tmp_path):
    from busca_tpu_torch.serve.server import _bind_unix

    path = str(tmp_path / "live.sock")
    srv = _bind_unix(path)
    with pytest.raises(OSError, match="live server"):
        _bind_unix(path)  # a live listener is never taken
    srv.close()
    # the closed listener left a stale file: replaced silently
    srv2 = _bind_unix(path)
    srv2.close()


def test_misbehaving_client_does_not_kill_accept_loop(detector, tmp_path):
    """A client that sends garbled framing ends only its own connection;
    the next client is served."""
    path = str(tmp_path / "robust.sock")
    server = TrackingServer(detector, _byte_factory)
    t = threading.Thread(target=server.serve_unix, args=(path,),
                         kwargs={"max_connections": 3}, daemon=True)
    t.start()
    bad = _wait_for_socket(path).conn
    bad.sendall(struct.pack(">I", 1 << 30))  # an oversized header length
    bad.close()
    bad = TrackingClient.connect_unix(path).conn
    raw = b"[1, 2]"  # a header that is not an object
    bad.sendall(struct.pack(">I", len(raw)) + raw)
    assert recv_msg(bad)[0]["ok"] is False
    bad.close()
    client = TrackingClient.connect_unix(path)
    assert client.start("ok")["ok"]
    assert client.frame(np.zeros((48, 80, 3), np.uint8))["ok"]
    client.stop()
    t.join(timeout=30)
    assert not t.is_alive()


def test_unix_socket_serving(detector, tmp_path):
    path = str(tmp_path / "trk.sock")
    server = TrackingServer(detector, _byte_factory)
    t = threading.Thread(target=server.serve_unix, args=(path,),
                         kwargs={"max_connections": 1}, daemon=True)
    t.start()
    client = _wait_for_socket(path)
    assert client.start()["ok"]
    assert client.frame(_frames(np.random.RandomState(3), n=1)[0])["ok"]
    client.stop()
    t.join(timeout=10)
    assert not t.is_alive()


def colour_centertrack():
    """The port's tiny CenterTrack designed as a colour detector
    (tests/test_torch_centertrack_loop.py) and its frames: the dropout
    sequence with object 1 painted over in its dropout window."""
    from busca_tpu_torch.eval.detector import CenterTrackDetector
    from busca_tpu_torch.models.centertrack import CenterTrackConfig
    from test_torch_centertrack_loop import (
        OUT_THRESH,
        TEST_SIZE,
        colour_detector_state,
        occluded_frames,
    )

    det = CenterTrackDetector(CenterTrackConfig.tiny(),
                              colour_detector_state(), TEST_SIZE, OUT_THRESH,
                              device="cpu")
    return det, occluded_frames


def test_server_centertrack_matches_inprocess_loop():
    """Served CenterTrack (the stateful detector through
    ``CenterTrackRunnerDetector``, the dict-IO adapter behind the runner
    shim, the tracks fed back as the prior heatmap) reproduces
    ``track_frames_centertrack`` frame by frame."""
    from busca_tpu_torch.eval.detector import (
        CenterTrackRunnerDetector,
        track_frames_centertrack,
    )
    from busca_tpu_torch.eval.run import make_tracker, shim_for_runner
    from busca_tpu_torch.trackers.base import Track

    det, occluded_frames = colour_centertrack()
    frames = occluded_frames(4)

    Track.reset_id_counter()
    det.reset()
    ref = track_frames_centertrack(
        det, make_tracker("centertrack", {"track_thresh": 0.3}, None), frames)

    def factory():
        Track.reset_id_counter()
        return shim_for_runner("centertrack", make_tracker(
            "centertrack", {"track_thresh": 0.3}, None))

    server = TrackingServer(CenterTrackRunnerDetector(det), factory,
                            min_box_area=0.0, vertical_thresh=None)
    client, thread = _serve_on_thread(server)
    assert client.start("seq")["ok"]
    got = [client.frame(f) for f in frames]
    client.stop()
    thread.join(timeout=10)

    n = 0
    for (fid, tlwhs, ids, _), rep in zip(ref.results, got):
        assert rep["ok"], rep
        want = {int(i): np.asarray(t) for t, i in zip(tlwhs, ids)
                if t[2] * t[3] > 0}  # the server filter drops empty boxes
        have = {t["id"]: np.asarray(t["tlwh"]) for t in rep["tracks"]}
        assert sorted(have) == sorted(want), (fid, sorted(have), sorted(want))
        for i in want:
            np.testing.assert_allclose(have[i], want[i], rtol=1e-5,
                                       atol=1e-4)
        n += len(want)
    assert n > 0, "no track was served"


# ------------------------ parity with busca_tpu's server --------------------

def test_server_matches_busca_tpu_server(engines):
    """The same frames through busca_tpu's and the port's ``TrackingServer``
    with the same weights: ByteTrack + BUSCA behind the designed colour
    YOLOX; ids equal, tlwh within 0.1 frame pixels, scores within 1e-3."""
    from busca_tpu.eval import detector as jdetector
    from busca_tpu.models.yolox import YoloxConfig as JConfig
    from busca_tpu.models.yolox import convert_yolox_state_dict
    from busca_tpu.serve.server import TrackingClient as JClient
    from busca_tpu.serve.server import TrackingServer as JServer
    from busca_tpu.trackers.base import Track as JTrack
    from busca_tpu.trackers.byte import ByteTracker as JByte
    from busca_tpu.trackers.byte import ByteTrackerConfig as JByteCfg
    from busca_tpu_torch.eval import detector as tdetector
    from busca_tpu_torch.models.yolox import YoloxConfig
    from busca_tpu_torch.trackers.base import Track
    from busca_tpu_torch.trackers.byte import ByteTracker, ByteTrackerConfig
    from test_torch_yolox_loop import (
        CONF,
        LOOP_BOX_TOL,
        TEST_SIZE,
        TINY,
        TRACKER_KW,
        _bf16_frames,
        bright_object_state,
    )

    d, w, c = TINY
    sd = bright_object_state(YoloxConfig(d, w, c))
    jcfg = JConfig(depth=d, width=w, num_classes=c)
    kw = dict(test_size=TEST_SIZE, conf_thresh=CONF, nms_thresh=0.7,
              max_outputs=32)
    jdet = jdetector.YoloxDetector(jcfg, convert_yolox_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jcfg), **kw)
    tdet = tdetector.YoloxDetector(YoloxConfig(d, w, c), sd, device="cpu",
                                   **kw)
    jeng, teng = engines
    rounds = {"j": 0, "t": 0}
    orig = {"j": jeng.associate, "t": teng.associate}

    def counted(key):
        def associate(*a, **k):
            rounds[key] += 1
            return orig[key](*a, **k)

        return associate

    def jfactory():
        JTrack.reset_id_counter()
        return JByte(JByteCfg(**TRACKER_KW), jeng)

    def tfactory():
        Track.reset_id_counter()
        return ByteTracker(ByteTrackerConfig(**TRACKER_KW), teng)

    frames = _bf16_frames()
    replies = {}
    jeng.associate, teng.associate = counted("j"), counted("t")
    try:
        for key, server, client_cls in (
                ("j", JServer(jdet, jfactory, min_box_area=0.0), JClient),
                ("t", TrackingServer(tdet, tfactory, min_box_area=0.0),
                 TrackingClient)):
            srv_sock, cli_sock = socket.socketpair()
            thread = threading.Thread(target=server.serve_connection,
                                      args=(srv_sock,), daemon=True)
            thread.start()
            client = client_cls(cli_sock)
            assert client.start("parity")["ok"]
            replies[key] = [client.frame(f) for f in frames]
            client.stop()
            thread.join(timeout=30)
    finally:
        jeng.associate, teng.associate = orig["j"], orig["t"]
    n = 0
    for rj, rt in zip(replies["j"], replies["t"]):
        assert rj["ok"] and rt["ok"] and rj["frame_id"] == rt["frame_id"]
        assert [t["id"] for t in rt["tracks"]] == \
            [t["id"] for t in rj["tracks"]], f"frame {rj['frame_id']}"
        for a, b in zip(rt["tracks"], rj["tracks"]):
            np.testing.assert_allclose(a["tlwh"], b["tlwh"], rtol=0,
                                       atol=LOOP_BOX_TOL)
            assert abs(a["score"] - b["score"]) <= 1e-3
        n += len(rt["tracks"])
    assert n > 0, "no track was served"
    assert rounds["t"] == rounds["j"] >= 1, "the third round never ran"


# ------------------------------- the CLI ------------------------------------

def test_build_tracker_runtime_unpacks_engine(monkeypatch):
    """``--use-busca`` wiring: ``build_engine`` returns ``(engine,
    tracker_kwargs)``; the tracker gets the engine (not the tuple), the YAML
    bundle's tracker kwargs apply, and explicit flags win."""
    import busca_tpu_torch.eval.run as run_mod
    from busca_tpu_torch.serve.server import build_tracker_runtime

    sentinel = object()
    seen = {}

    def fake_build_engine(config, ckpt=None, device="cuda",
                          crop_hw=(384, 128), bank_slots=None, seed=0,
                          dtype=None, reid_stats="batch"):
        seen.update(config=config, ckpt=ckpt, device=device,
                    crop_hw=crop_hw, seed=seed, dtype=dtype,
                    reid_stats=reid_stats)
        return sentinel, {"seq_len": 7, "busca_thresh": 0.4,
                          "track_thresh": 0.9}

    monkeypatch.setattr(run_mod, "build_engine", fake_build_engine)
    args = types.SimpleNamespace(
        use_busca=True, busca_config="cfg.yml", busca_ckpt=None,
        busca_dtype="float32", reid_ckpt=None, tracker="byte",
        track_thresh=0.3, device="cpu", seed=3, crop_hw=(64, 32))
    engine, factory = build_tracker_runtime(args)
    assert engine is sentinel
    assert seen == {"config": "cfg.yml", "ckpt": None, "device": "cpu",
                    "crop_hw": (64, 32), "seed": 3, "dtype": "float32",
                    "reid_stats": "batch"}
    trk = factory()
    assert trk.engine is sentinel
    assert trk.cfg.use_busca is True
    assert trk.cfg.seq_len == 7  # the YAML bundle's kwargs apply
    assert trk.cfg.busca_thresh == 0.4
    assert trk.cfg.track_thresh == 0.3  # the flag wins over the YAML
    assert trk.cfg.crop_hw == (64, 32)


def test_build_tracker_runtime_no_busca():
    from busca_tpu_torch.serve.server import build_tracker_runtime

    args = types.SimpleNamespace(use_busca=False, reid_ckpt=None,
                                 tracker="byte", track_thresh=0.45)
    engine, factory = build_tracker_runtime(args)
    assert engine is None
    trk = factory()
    assert trk.engine is None
    assert trk.cfg.track_thresh == 0.45


def test_build_tracker_runtime_yaml_track_thresh_wins_when_flag_unset(
        monkeypatch):
    """An unset ``--track-thresh`` keeps the YAML bundle's value, and
    without one ByteTrack's 0.6."""
    import busca_tpu_torch.eval.run as run_mod
    from busca_tpu_torch.serve.server import build_tracker_runtime

    monkeypatch.setattr(run_mod, "build_engine",
                        lambda *a, **k: (object(), {"track_thresh": 0.9}))
    args = types.SimpleNamespace(
        use_busca=True, busca_config="cfg.yml", busca_ckpt=None,
        busca_dtype="bfloat16", reid_ckpt=None, tracker="byte",
        track_thresh=None)
    _, factory = build_tracker_runtime(args)
    assert factory().cfg.track_thresh == 0.9

    monkeypatch.setattr(run_mod, "build_engine",
                        lambda *a, **k: (object(), {}))
    _, factory = build_tracker_runtime(args)
    assert factory().cfg.track_thresh == 0.6


def _parsed_args(argv):
    """``main``'s parsed arguments, stopping before any server work."""
    import argparse
    import unittest.mock as mock

    captured = {}
    real_parse = argparse.ArgumentParser.parse_args

    def spy(self, args=None, namespace=None):
        ns = real_parse(self, args, namespace)
        captured.update(vars(ns))
        raise SystemExit(0)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", spy):
        with pytest.raises(SystemExit):
            server_mod.main(argv)
    return captured


def test_serve_cli_defaults_match_eval():
    """``--busca-dtype`` defaults to bfloat16 as the eval CLI does, an unset
    ``--track-thresh`` is None, and the device is the card."""
    args = _parsed_args(["--socket", "/tmp/x.sock"])
    assert args["busca_dtype"] == "bfloat16"
    assert args["track_thresh"] is None
    assert args["device"] == "cuda"


@pytest.mark.parametrize("argv,item", [
    (["--lockstep-dp", "2"], "--lockstep-dp requires --lockstep"),
    (["--lockstep", "--lockstep-dp", "2", "--detector-artifact", "art/"],
     "needs a live --detector"),
    (["--lockstep", "--lockstep-dp", "2", "--device", "cuda"],
     "CUDA device(s) are visible"),
], ids=["without-lockstep", "with-artifact", "above-device-count"])
def test_serve_cli_refuses_unported_flags(argv, item, capsys):
    """Every flag of busca_tpu's server is ported; ``--lockstep-dp`` keeps
    busca_tpu's refusals (busca_tpu/serve/server.py:605-615): it needs
    ``--lockstep`` and a live detector, and a count above the visible
    devices is refused by name (this host has no card)."""
    with pytest.raises(SystemExit) as e:
        server_mod.main(["--socket", "/tmp/x.sock", "--detector", "yolox-x",
                         "--device", "cpu"] + argv)
    assert e.value.code == 2
    assert item in capsys.readouterr().err


@pytest.mark.parametrize("mode", ["frozen", "auto"])
def test_serve_cli_hands_reid_stats_to_build_engine(mode, monkeypatch):
    """``--reid-stats frozen|auto`` (ported with items 7 and 24) reaches
    ``build_engine`` through the server CLI, as busca_tpu's does
    (tests/test_server.py's runtime wiring test)."""
    import busca_tpu_torch.eval.run as run_mod

    seen = {}

    def fake_build_engine(config, ckpt, **kw):
        seen.update(kw, config=config)
        return None, {}

    monkeypatch.setattr(run_mod, "build_engine", fake_build_engine)
    monkeypatch.setattr(TrackingServer, "serve_unix",
                        lambda self, *a, **k: None)
    server_mod.main(["--socket", "/tmp/x.sock", "--detector", "yolox-tiny",
                     "--test-h", "64", "--test-w", "128", "--use-busca",
                     "--busca-config", "cfg.yml", "--reid-stats", mode,
                     "--device", "cpu"])
    assert seen["reid_stats"] == mode and seen["config"] == "cfg.yml"
    assert seen["device"] == "cpu" and seen["dtype"] == "bfloat16"


def _served(argv, monkeypatch):
    """The server ``main`` builds from ``argv`` (a tiny YOLOX on the CPU),
    caught at ``serve_unix``."""
    from busca_tpu_torch.serve.lockstep import LockstepTrackingServer

    built = []
    for cls in (TrackingServer, LockstepTrackingServer):
        monkeypatch.setattr(cls, "serve_unix",
                            lambda self, *a, **k: built.append(self))
    server_mod.main(["--socket", "/tmp/x.sock", "--test-h", "64",
                     "--test-w", "128", "--device", "cpu"] + argv)
    (server,) = built
    return server


@pytest.mark.parametrize("argv,check", [
    (["--detector-artifact", "art/"],
     lambda s: type(s) is TrackingServer and s.detector == "artifact art/"),
    (["--detector", "yolox-tiny", "--lockstep"],
     lambda s: type(s).__name__ == "LockstepTrackingServer"
     and s.tick_timeout == 0.010),
    (["--detector", "yolox-tiny", "--mem-cap", "64"],
     lambda s: type(s) is TrackingServer
     and s.tracker_factory().cfg.mem_cap == 64),
    (["--detector", "yolox-tiny", "--lockstep", "--tick-timeout", "0.05"],
     lambda s: s.tick_timeout == 0.05),
    (["--detector", "yolox-tiny", "--lockstep", "--lockstep-dp", "2"],
     lambda s: len(s.detector._shards) == 2
     and s.detector._shards[0] is s.detector),
], ids=["detector-artifact", "lockstep", "mem-cap", "tick-timeout",
        "lockstep-dp"])
def test_serve_cli_accepts_ported_flags(argv, check, monkeypatch):
    """The ported flags that test_serve_cli_refuses_unported_flags once
    refused build their server: an artifact's detector, the lockstep
    server, its tick timeout, the memory cap on every stream's tracker,
    the lockstep batch split over two (CPU) devices."""
    monkeypatch.setattr(server_mod, "load_artifact_detector",
                        lambda d, device: f"artifact {d}")
    assert check(_served(argv, monkeypatch))


@pytest.mark.parametrize("detector,extra", [
    ("yolox-tiny", ["--tracker", "byte"]),
    ("transcenter", ["--tracker", "transcenter"]),
    ("centertrack", ["--tracker", "centertrack", "--centertrack-arch",
                     "tiny"]),
])
def test_serve_cli_cpu_drive(detector, extra, tmp_path,
                             one_torch_thread):  # noqa: F811
    """``python -m busca_tpu_torch.serve.server ... --device cpu`` end to
    end with each live detector (random weights) and BUSCA (a small YAML
    model, random weights): one client, signed snapshots."""
    import yaml

    cfg = str(tmp_path / "busca.yml")
    with open(cfg, "w") as f:
        yaml.safe_dump({"transformer": dict(
            SMALL, reid_layers=list(SMALL["reid_layers"]))}, f)
    key = tmp_path / "key"
    key.write_bytes(b"serve-cli-key\n")
    path = str(tmp_path / "cli.sock")
    t = threading.Thread(target=server_mod.main, args=([
        "--socket", path, "--detector", detector, "--test-h", "64",
        "--test-w", "128", "--use-busca", "--busca-config", cfg,
        "--crop-h", str(CROP_HW[0]), "--crop-w", str(CROP_HW[1]),
        "--snapshot-key-file", str(key), "--device", "cpu",
        "--max-connections", "1"] + extra,), daemon=True)
    t.start()
    client = _wait_for_socket(path)
    assert client.start("cli")["ok"]
    for f in _frames(np.random.RandomState(5), n=3, hw=(64, 128)):
        assert client.frame(f)["ok"]
    header, blob = client.snapshot()
    assert header["frame_id"] == 3 and blob.startswith(b"BSNPSIG1")
    assert client.restore(blob)["frame_id"] == 3
    client.stop()
    t.join(timeout=30)
    assert not t.is_alive()
