"""Tracker snapshot and restore in the port (busca_tpu_torch/serve/
snapshot.py) on the CPU: every test of tests/test_snapshot.py but the
lockstep server's, on the port.  A stream resumed from a snapshot in a fresh
process (the id counters reset) continues bit for bit; the exact allowlist
admits every tracker flavour and wrapper chain of the port and refuses
anything else; HMAC-signed blobs; the server's snapshot and restore commands
with the stream position and the stateful detectors' canvases in the blob.

Added here: a busca_tpu blob (its classes) and a blob holding a
``torch.Tensor`` (torch's rebuild functions) are refused by the port's
unpickler, and ``snapshot_bytes`` refuses tracker state that holds a torch
object; served streams of ByteTrack + BUSCA (YOLOX), TransCenter + BUSCA,
CenterTrack + BUSCA and StrongSORT through its ``FeatureShim``, snapshotted
mid-stream (signed and unsigned) and restored on a fresh server with a fresh
detector, equal the unbroken streams exactly.  The trackers here get their
frames as tensors where the card hands them tensors.
"""

import pickle
import socket
import threading

import numpy as np
import pytest
import torch

from busca_tpu_torch.serve.server import TrackingClient, TrackingServer
from busca_tpu_torch.serve.snapshot import (
    restore_bytes,
    restore_with_meta,
    snapshot_bytes,
)
from busca_tpu_torch.trackers.base import IdCounter, Track
from busca_tpu_torch.trackers.byte import ByteTracker, ByteTrackerConfig
from test_torch_strongsort import one_torch_thread  # noqa: F401

H, W = 32, 16
SEQ_LEN, NUM_CAN = 3, 2
KEY = b"test-hmac-key-32-bytes-aaaaaaaaa"


@pytest.fixture(scope="module", name="engine")
def _engine_fixture():
    from busca_tpu_torch.assoc.bank import DeviceCropBank
    from busca_tpu_torch.assoc.engine import AssociationEngine
    from busca_tpu_torch.models.busca import BuscaConfig, BuscaModel

    cfg = BuscaConfig(num_layer=1, reid_num_classes=5,
                      reid_layers=(1, 1, 1, 1))
    model = BuscaModel(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    return AssociationEngine(cfg, model.eval(), seq_len=SEQ_LEN,
                             num_candidates=NUM_CAN, crop_hw=(H, W),
                             buckets=(1, 2, 4),
                             bank=DeviceCropBank((H, W), 64, "cpu"))


def _byte_cfg(**kw):
    return ByteTrackerConfig(**dict(
        dict(track_thresh=0.3, use_busca=True, busca_thresh=0.01,
             seq_len=SEQ_LEN, num_candidates=NUM_CAN, crop_hw=(H, W),
             use_camera_motion_compensation=False), **kw))


def _stream(num_frames=24):
    from busca_tpu_torch.eval.synthetic import default_dropout_sequence

    seq = default_dropout_sequence(num_frames)
    return [(seq.frame(t), *seq.detections(t)) for t in range(num_frames)]


def _outputs(online):
    return sorted((int(t.track_id), tuple(np.round(np.asarray(t.tlwh, float),
                                                   6)))
                  for t in online)


def _reset_ids():
    from busca_tpu_torch.trackers import motdt, sort

    Track.reset_id_counter()
    sort.SortTrack._count = IdCounter(1)
    motdt.MotdtTrack._count = IdCounter(1)


def test_byte_snapshot_resume_identical(engine,
                                        one_torch_thread):  # noqa: F811
    """Snapshot mid-stream, go on with the original, then replay the tail on
    a restored tracker in a simulated fresh process (the id counter back at
    1): identical ids and boxes frame by frame, tracks born after the
    restore point included."""
    stream = _stream()
    cut = 10
    Track.reset_id_counter()
    tracker = ByteTracker(_byte_cfg(), engine)
    for frame, boxes, scores in stream[:cut]:
        tracker.update(boxes, scores, 1.0, torch.from_numpy(frame))
    blob = snapshot_bytes(tracker)
    assert tracker.engine is engine  # the live tracker has its handle back
    rounds = [0]
    orig = engine.associate

    def counted(*a, **k):
        rounds[0] += 1
        return orig(*a, **k)

    engine.associate = counted
    try:
        expected = [_outputs(tracker.update(boxes, scores, 1.0,
                                            torch.from_numpy(frame)))
                    for frame, boxes, scores in stream[cut:]]
        Track.reset_id_counter()
        restored = restore_bytes(blob, engine=engine)
        assert restored is not tracker and restored.engine is engine
        got = [_outputs(restored.update(boxes, scores, 1.0,
                                        torch.from_numpy(frame)))
               for frame, boxes, scores in stream[cut:]]
    finally:
        engine.associate = orig
    assert got == expected
    assert any(len(o) for o in got)
    assert rounds[0] >= 2, "the third round did not run after the cut"


def test_snapshot_ids_never_collide_when_counter_is_ahead(engine):
    """Restoring into a process whose id counter is ahead of the snapshot
    does not move it back: new tracks keep minting fresh ids."""
    stream = _stream(8)
    Track.reset_id_counter()
    tracker = ByteTracker(_byte_cfg(), engine)
    for frame, boxes, scores in stream[:4]:
        tracker.update(boxes, scores, 1.0, frame)
    blob = snapshot_bytes(tracker)
    old_ids = {t.track_id for t in tracker.tracked + tracker.lost}
    burned = {Track.next_id() for _ in range(5)}  # another tracker's ids
    restored = restore_bytes(blob, engine=engine)
    fresh = Track.next_id()
    assert fresh not in burned
    assert fresh not in {t.track_id for t in restored.tracked + restored.lost}
    assert old_ids and fresh > max(old_ids | burned)


def test_restore_without_engine_fails_loudly(engine):
    tracker = ByteTracker(_byte_cfg(), engine)
    for frame, boxes, scores in _stream(6):
        tracker.update(boxes, scores, 1.0, frame)
    with pytest.raises(ValueError, match="use_busca"):
        restore_bytes(snapshot_bytes(tracker))


class _Features:
    """A stand-in ReID extractor on the CPU: the ``FeatureShim`` uploads
    the frame to its device and hands the tracker a tensor, as on the
    card."""

    device = torch.device("cpu")

    def __call__(self, crops):
        c = crops.to(torch.float32).mean(dim=(1, 2)).numpy()
        return np.concatenate([c, np.ones((len(c), 5))], axis=1)


def _strongsort_factory():
    from busca_tpu_torch.eval.run import FeatureShim
    from busca_tpu_torch.trackers.strongsort import (
        StrongSortConfig,
        StrongSortTracker,
    )

    return FeatureShim(StrongSortTracker(StrongSortConfig(n_init=1)),
                       _Features(), (H, W), call_predict=True)


def test_snapshot_strongsort_shim_chain_roundtrip():
    """The FeatureShim -> StrongSortTracker chain snapshots and restores
    through a donor built by the same factory (the server's restore path);
    the continuation equals the unbroken run."""
    rng = np.random.RandomState(3)
    frames = [rng.randint(0, 255, (64, 96, 3), dtype=np.uint8)
              for _ in range(10)]
    boxes = np.array([[8.0, 8, 24, 40], [50.0, 10, 70, 44]])
    scores = np.array([0.9, 0.8])
    shim = _strongsort_factory()
    for f in frames[:5]:
        shim.update(boxes, scores, 1.0, f)
    blob = snapshot_bytes(shim)
    expected = [_outputs(shim.update(boxes, scores, 1.0, f))
                for f in frames[5:]]
    restored = restore_bytes(blob, donor=_strongsort_factory())
    assert restored.trk is not shim.trk and restored.feat_fn is not None
    got = [_outputs(restored.update(boxes, scores, 1.0, f))
           for f in frames[5:]]
    assert got == expected
    assert any(len(o) == 2 for o in expected)


def test_snapshot_ghost_roundtrip():
    from busca_tpu_torch.trackers.ghost import GhostConfig, GhostTracker

    rng = np.random.RandomState(5)
    frames = [rng.randint(0, 255, (64, 96, 3), dtype=np.uint8)
              for _ in range(8)]
    boxes = np.array([[8.0, 8, 24, 40]])
    feats = rng.randn(1, 16)
    trk = GhostTracker(GhostConfig())
    for f in frames[:4]:
        trk.update(boxes, np.array([0.9]), feats, f)
    blob = snapshot_bytes(trk)

    def key(tracks):
        return sorted((int(t.track_id),
                       tuple(np.round(np.asarray(t.pos, float), 6)))
                      for t in tracks)

    expected = [key(trk.update(boxes, np.array([0.9]), feats, f))
                for f in frames[4:]]
    restored = restore_bytes(blob)
    got = [key(restored.update(boxes, np.array([0.9]), feats, f))
           for f in frames[4:]]
    assert got == expected and any(expected)
    assert restored.frame_id == trk.frame_id
    assert set(restored.tracks) == set(trk.tracks)


def _evil_blob(target, *args):
    class Evil:
        def __reduce__(self):
            return (target, args)

    return pickle.dumps({"version": 2, "counters": {}, "meta": {},
                         "tracker": Evil()},
                        protocol=pickle.HIGHEST_PROTOCOL)


def test_restricted_unpickler_rejects_forbidden_globals():
    """A blob cannot smuggle a constructor: anything outside the port's
    state classes, numpy and the stdlib containers is refused at load."""
    import os

    with pytest.raises(pickle.UnpicklingError, match="forbidden"):
        restore_bytes(_evil_blob(os.system, "true"))


@pytest.mark.parametrize("version", [1, 99])
def test_restore_rejects_wrong_version(engine, version):
    """Only the port's own format restores: busca_tpu's version-1 layout
    was never written by the port and is refused like any other."""
    blob = snapshot_bytes(ByteTracker(_byte_cfg(), engine))
    payload = pickle.loads(blob)
    payload["version"] = version
    with pytest.raises(ValueError, match="format"):
        restore_bytes(pickle.dumps(payload))


def test_save_and_load_a_file(engine, tmp_path):
    """``save``/``load``: the blob through a file, signed."""
    from busca_tpu_torch.serve.snapshot import load, save

    tracker = ByteTracker(_byte_cfg(), engine)
    for frame, boxes, scores in _stream(6):
        tracker.update(boxes, scores, 1.0, frame)
    path = str(tmp_path / "stream.snap")
    save(tracker, path, meta={"frame_id": 6}, key=KEY)
    restored = load(path, engine=engine, key=KEY)
    assert _outputs(restored.tracked) == _outputs(tracker.tracked)
    with pytest.raises(ValueError, match="HMAC"):
        load(path, engine=engine, key=b"other-key")


def _serve(server):
    srv_sock, cli_sock = socket.socketpair()
    threading.Thread(target=server.serve_connection, args=(srv_sock,),
                     daemon=True).start()
    return TrackingClient(cli_sock)


def _tiny_yolox():
    from test_torch_server import colour_yolox

    return colour_yolox()[0]


def _server_frames(n):
    from test_torch_server import colour_yolox

    return colour_yolox()[1](n)


def test_server_snapshot_restore_across_servers():
    """A client streams to server A, snapshots, and resumes on a freshly
    built server B (a fresh process: the id counter reset): the remaining
    frames give the unbroken run's replies."""
    detector = _tiny_yolox()

    def make_server():
        return TrackingServer(
            detector, lambda: ByteTracker(ByteTrackerConfig(
                track_thresh=0.01), None),
            min_box_area=0.0, vertical_thresh=None)

    frames = _server_frames(8)
    Track.reset_id_counter()
    ref_client = _serve(make_server())
    assert ref_client.start("seq")["ok"]
    ref = [ref_client.frame(f) for f in frames]
    ref_client.stop()

    Track.reset_id_counter()
    client_a = _serve(make_server())
    assert client_a.start("seq")["ok"]
    for f in frames[:4]:
        client_a.frame(f)
    header, blob = client_a.snapshot()
    assert header["frame_id"] == 4
    client_a.stop()

    Track.reset_id_counter()  # server B: a fresh process
    client_b = _serve(make_server())
    reply = client_b.restore(blob, frame_id=header["frame_id"],
                             name=header["name"])
    assert reply["ok"], reply
    got = [client_b.frame(f) for f in frames[4:]]
    client_b.stop()
    for r, g in zip(ref[4:], got):
        assert r["frame_id"] == g["frame_id"] and r["tracks"] == g["tracks"]
    assert any(r["tracks"] for r in ref[4:]), "the tail saw no tracks"


def test_server_snapshot_without_sequence_errors():
    client = _serve(TrackingServer(
        _tiny_yolox(), lambda: ByteTracker(ByteTrackerConfig(), None)))
    with pytest.raises(RuntimeError, match="no sequence"):
        client.snapshot()
    client.stop()


# ---------------------------------------------------------------------------
# the allowlist, HMAC signing, meta, stateful detectors
# ---------------------------------------------------------------------------

def _tracker_flavours(engine):
    """Every port tracker flavour and wrapper chain, driven six frames; the
    BYTE family and the feature trackers get tensor frames, as the card
    hands them."""
    from busca_tpu_torch.eval.run import make_tracker, shim_for_runner
    from busca_tpu_torch.trackers.ghost import GhostConfig, GhostTracker
    from busca_tpu_torch.trackers.motdt import MotdtTracker
    from busca_tpu_torch.trackers.sort import SortTracker
    from busca_tpu_torch.trackers.transcenter import TransCenterByteTracker

    rng = np.random.RandomState(0)
    frames = [torch.from_numpy(rng.randint(0, 255, (64, 96, 3),
                                           dtype=np.uint8))
              for _ in range(6)]
    boxes = np.array([[8.0, 8, 24, 40], [50.0, 10, 70, 44]])
    scores = np.array([0.9, 0.8])
    feats = rng.randn(2, 16)
    built = []

    def drive(name, trk, restore_kw, step):
        for f in frames:
            step(trk, f)
        built.append((name, trk, restore_kw))

    def runner_step(trk, f):
        trk.update(boxes, scores, 1.0, f)

    drive("byte", ByteTracker(_byte_cfg(), engine), dict(engine=engine),
          runner_step)
    drive("byte+mem_cap", ByteTracker(_byte_cfg(mem_cap=8), engine),
          dict(engine=engine), runner_step)
    drive("transcenter", TransCenterByteTracker(_byte_cfg(), engine),
          dict(engine=engine), runner_step)
    kw = dict(track_thresh=0.3, use_busca=True, seq_len=SEQ_LEN,
              num_candidates=NUM_CAN, use_camera_motion_compensation=False)

    def centertrack_step(trk, f):
        trk.update(boxes[:1], scores[:1], 1.0, f)

    drive("centertrack", shim_for_runner("centertrack", make_tracker(
        "centertrack", kw, engine, (H, W))), dict(engine=engine),
        centertrack_step)
    for name in ("strongsort", "deepsort", "motdt"):
        trk = make_tracker(name, {"n_init": 1}, None, (H, W))
        drive(name, shim_for_runner(name, trk, _Features(), (H, W)),
              dict(feature_extractor=_Features()), runner_step)
    drive("strongsort+busca", shim_for_runner("strongsort", make_tracker(
        "strongsort", {"n_init": 1}, engine, (H, W)), _Features(), (H, W)),
        dict(engine=engine, feature_extractor=_Features()), runner_step)
    drive("ghost", GhostTracker(GhostConfig()), {},
          lambda trk, f: trk.update(boxes, scores, feats, f))
    drive("ghost shim", shim_for_runner("ghost", make_tracker(
        "ghost", {}, engine, (H, W)), _Features(), (H, W)),
        dict(engine=engine, feature_extractor=_Features()), runner_step)
    drive("sort", SortTracker(), {},
          lambda trk, f: trk.update(boxes, scores))
    drive("motdt", MotdtTracker(), {},
          lambda trk, f: trk.update(boxes, scores, feats, f.numpy()))
    return built


def test_allowlist_covers_every_tracker_flavor(engine):
    """Every port tracker flavour and wrapper chain (byte, byte with a
    memory cap, transcenter, centertrack through its shim, strongsort,
    deepsort and motdt through the FeatureShim, strongsort with BUSCA,
    ghost alone and through the shim, sort, motdt) snapshots and restores
    under the exact allowlist: a newly pickled class must be added to
    ``snapshot._ALLOWED`` on purpose.  No state holds a torch object."""
    _reset_ids()
    for name, tracker, kw in _tracker_flavours(engine):
        blob = snapshot_bytes(tracker)
        restored = restore_bytes(blob, **kw)
        assert type(restored).__name__ == type(tracker).__name__, name
        assert b"torch" not in blob.replace(b"busca_tpu_torch.", b""), name


@pytest.mark.parametrize("module,name", [
    ("numpy.testing._private.utils", "runstring"),
    ("numpy", "load"),
    ("busca_tpu_torch.serve.snapshot", "save"),
    ("busca_tpu_torch.trackers.base", "IdCounter"),  # a class, not state
    ("torch._utils", "_rebuild_tensor_v2"),
    ("torch", "device"),
    ("builtins", "eval"),
    ("os", "system"),
])
def test_unpickler_rejects_call_gadgets(module, name):
    """A module-prefix allowlist would admit numpy's exec helper, a port
    function or torch's rebuild functions as call gadgets; the exact
    allowlist refuses each by name."""
    import importlib

    target = importlib.import_module(module)
    for part in name.split("."):
        target = getattr(target, part)
    with pytest.raises(pickle.UnpicklingError, match="forbidden"):
        restore_bytes(_evil_blob(target, "nop"))


def test_unpickler_refuses_a_pickled_tensor():
    """A blob holding a ``torch.Tensor`` (torch's rebuild functions) is
    refused before anything is built."""
    blob = pickle.dumps({"version": 2, "counters": {}, "meta": {},
                         "tracker": {"frame": torch.zeros(2, 3)}})
    with pytest.raises(pickle.UnpicklingError, match="forbidden torch"):
        restore_bytes(blob)


def test_snapshot_refuses_torch_state(engine):
    """Tracker state that holds a torch object fails when it is
    snapshotted, not at restore, and the live tracker keeps its handles."""
    tracker = ByteTracker(_byte_cfg(), engine)
    tracker.last_image = torch.zeros(4, 4, 3, dtype=torch.uint8)
    with pytest.raises(pickle.PicklingError, match="torch.Tensor"):
        snapshot_bytes(tracker)
    assert tracker.engine is engine
    with pytest.raises(pickle.PicklingError, match="torch.device"):
        snapshot_bytes(tracker, meta={"device": torch.device("cpu")})


def test_busca_tpu_blob_refused(engine):
    """A blob does not move between the two packages: a busca_tpu snapshot
    names busca_tpu's classes, which the port's allowlist refuses."""
    from busca_tpu.serve.snapshot import snapshot_bytes as j_snapshot
    from busca_tpu.trackers.byte import ByteTracker as JByte
    from busca_tpu.trackers.byte import ByteTrackerConfig as JByteCfg

    jtrk = JByte(JByteCfg(track_thresh=0.3))
    for frame, boxes, scores in _stream(3):
        jtrk.update(boxes, scores, 1.0, frame)
    blob = j_snapshot(jtrk, meta={"frame_id": 3}, key=KEY)
    with pytest.raises(pickle.UnpicklingError,
                       match="forbidden busca_tpu.trackers"):
        restore_bytes(blob, key=KEY)


def test_hmac_signed_roundtrip_and_rejections(engine):
    """With a key: signed blobs restore; unsigned and tampered blobs are
    refused before unpickling."""
    tracker = ByteTracker(_byte_cfg(), engine)
    for frame, boxes, scores in _stream(8)[:4]:
        tracker.update(boxes, scores, 1.0, frame)
    blob = snapshot_bytes(tracker, meta={"frame_id": 4}, key=KEY)
    _, meta = restore_with_meta(blob, engine=engine, key=KEY)
    assert meta["frame_id"] == 4
    with pytest.raises(ValueError, match="unsigned"):
        restore_bytes(snapshot_bytes(tracker), engine=engine, key=KEY)
    bad = bytearray(blob)
    bad[-1] ^= 0xFF
    with pytest.raises(ValueError, match="HMAC"):
        restore_bytes(bytes(bad), engine=engine, key=KEY)
    with pytest.raises(ValueError, match="HMAC"):
        restore_bytes(blob, engine=engine, key=b"other-key")
    # no key configured: a signed blob still restores (the unpickler's
    # trust level, verify_blob)
    assert restore_bytes(blob, engine=engine) is not None


def test_server_restore_uses_blob_frame_id():
    """The stream position rides in the blob: a restore without a frame id
    resumes numbering where the snapshot left off."""
    detector = _tiny_yolox()

    def serve():
        return _serve(TrackingServer(
            detector, lambda: ByteTracker(ByteTrackerConfig(
                track_thresh=0.01), None),
            min_box_area=0.0, vertical_thresh=None))

    frames = _server_frames(6)
    client_a = serve()
    assert client_a.start("seq")["ok"]
    for f in frames[:3]:
        client_a.frame(f)
    _, blob = client_a.snapshot()
    client_a.stop()
    client_b = serve()
    reply = client_b.restore(blob)  # no frame_id, no name
    assert reply["ok"] and reply["frame_id"] == 3 and reply["name"] == "seq"
    assert client_b.frame(frames[3])["frame_id"] == 4
    client_b.stop()


class _StatefulStubDetector:
    """A feedback detector with cross-frame state: its box shifts by the
    previous frame's brightness delta, so that a reset or a transient after
    the restore changes the output."""

    uses_feedback = True

    def __init__(self):
        self.reset_calls = 0
        self.reset()

    def reset(self):
        self.reset_calls += 1
        self._pre = None

    def state_dict(self):
        return {"pre": None if self._pre is None else np.asarray(self._pre)}

    def load_state_dict(self, state):
        self._pre = state.get("pre")

    def detect(self, frame, current_pos=None):
        from busca_tpu_torch.eval.detector import DetectorOutput

        mean = float(np.asarray(frame, np.float32).mean())
        prev = mean if self._pre is None else float(self._pre)
        shift = (mean - prev) * 0.1
        self._pre = mean
        return DetectorOutput(
            np.array([[10.0 + shift, 10.0, 30.0 + shift, 42.0]]),
            np.array([0.9]), np.asarray(frame), 1.0)


def test_server_stateful_detector_snapshot_resume_bitequal():
    """With a stateful feedback detector, the restored stream equals the
    unbroken one: the detector's state rides in the blob and restore loads
    it rather than reset it."""
    def factory():
        Track.reset_id_counter()
        return ByteTracker(ByteTrackerConfig(track_thresh=0.3), None)

    def serve(detector):
        return _serve(TrackingServer(detector, factory, min_box_area=0.0,
                                     vertical_thresh=None))

    rng = np.random.RandomState(7)
    frames = [rng.randint(0, 255, (48, 64, 3), dtype=np.uint8)
              for _ in range(8)]
    ref_client = serve(_StatefulStubDetector())
    assert ref_client.start("seq")["ok"]
    ref = [ref_client.frame(f) for f in frames]
    ref_client.stop()

    det_a = _StatefulStubDetector()
    client_a = serve(det_a)
    assert client_a.start("seq")["ok"]
    for f in frames[:4]:
        client_a.frame(f)
    _, blob = client_a.snapshot()
    client_a.stop()

    det_b = _StatefulStubDetector()
    client_b = serve(det_b)
    resets = det_b.reset_calls
    assert client_b.restore(blob)["ok"]
    assert det_b.reset_calls == resets and det_b._pre == det_a._pre
    got = [client_b.frame(f) for f in frames[4:]]
    client_b.stop()
    for r, g in zip(ref[4:], got):
        assert r["frame_id"] == g["frame_id"] and r["tracks"] == g["tracks"]
    assert any(r["tracks"] for r in ref[4:])


def test_id_counter_is_thread_safe_under_snapshot():
    """Concurrent ``next_id()`` and the snapshot's peek/advance mint no id
    twice."""
    from busca_tpu_torch.serve.snapshot import _counter_classes

    Track.reset_id_counter()
    minted = []
    stop = threading.Event()

    def mint():
        while not stop.is_set():
            minted.append(Track.next_id())

    threads = [threading.Thread(target=mint) for _ in range(4)]
    for t in threads:
        t.start()
    for _ in range(200):
        counter = _counter_classes()["base.Track"]._count
        counter.peek()
        counter.advance_to(1)  # a no-op advance takes the lock
    stop.set()
    for t in threads:
        t.join(timeout=10)
    assert len(minted) == len(set(minted)), "duplicate track ids minted"


def _tiny_transcenter(seed=12):
    """The port's tiny TransCenter with seeded busca_tpu-shaped weights
    (tests/test_torch_transcenter_loop.py's: tracks start on its frames)."""
    import jax

    from busca_tpu.models.transcenter import TransCenterConfig as JConfig
    from busca_tpu.models.transcenter import TransCenterDETR as JDETR
    from busca_tpu_torch.eval.detector import TransCenterDetector
    from busca_tpu_torch.models.convert import (
        transcenter_state_dict_from_flax,
    )
    from busca_tpu_torch.models.transcenter import TransCenterConfig
    from test_torch_transcenter_model import random_params

    th, tw = 64, 96
    z = np.zeros((1, th, tw, 3), np.float32)
    hm = np.zeros((1, th // 4, tw // 4, 1), np.float32)
    variables = jax.tree_util.tree_map(np.asarray, random_params(
        JDETR(JConfig.tiny()), z, z, hm, seed=seed))
    variables["params"]["wh_out"]["bias"] = np.array([4.0, 8.0], np.float32)
    sd = transcenter_state_dict_from_flax(variables)
    return lambda: TransCenterDetector(TransCenterConfig.tiny(), sd,
                                       test_size=(th, tw), out_thresh=0.3,
                                       device="cpu")


def test_real_stateful_detector_state_dict_resume():
    """The real stateful detectors' ``state_dict``: a tiny CenterTrack and a
    tiny TransCenter resumed from the captured canvas give the unbroken
    run's detections exactly."""
    from test_torch_server import colour_centertrack

    ct, occluded = colour_centertrack()
    ct_frames = occluded(4)
    tc_make = _tiny_transcenter()
    tc_frames = [f for f, _, _ in _stream(4)]

    def check(make, frames, detect):
        ref = make()
        want = [detect(ref, f) for f in frames]
        a = make()
        for f in frames[:2]:
            detect(a, f)
        state = a.state_dict()
        assert state["pre_canvas"].dtype == np.uint8
        b = make()
        b.load_state_dict(state)
        got = [detect(b, f) for f in frames[2:]]
        for w, g in zip(want[2:], got):
            for x, y in zip(w, g):
                np.testing.assert_array_equal(x, y)
        assert any(len(w[1]) for w in want[2:])

    def ct_make():
        from busca_tpu_torch.eval.detector import CenterTrackDetector

        return CenterTrackDetector(ct.config, ct.model.state_dict(),
                                   ct.test_size, ct.out_thresh, device="cpu")

    def ct_detect(det, f):
        results, _, _ = det.detect(f, tracks=[])
        return (np.array([r["bbox"] for r in results]),
                np.array([r["score"] for r in results]))

    def tc_detect(det, f):
        out = det.detect(f, current_pos=np.zeros((0, 4)))
        return out.boxes_tlbr, out.scores

    check(ct_make, ct_frames, ct_detect)
    check(tc_make, tc_frames, tc_detect)


# ------------------- served streams restored bit for bit --------------------

def _served(make_detector, factory, frames, cut=None, key=None):
    """The replies to ``frames`` on one server; with ``cut``, a snapshot
    after ``cut`` frames is restored on a second server built with a fresh
    detector (the same weights) and the stream finishes there.  Every
    server starts in a fresh process: the id counters reset."""
    def serve():
        return _serve(TrackingServer(make_detector(), factory,
                                     min_box_area=0.0, vertical_thresh=None,
                                     snapshot_key=key))

    _reset_ids()
    client = serve()
    assert client.start("seq")["ok"]
    replies = [client.frame(f) for f in frames[:cut]]
    if cut is not None:
        header, blob = client.snapshot()
        assert header["frame_id"] == cut
        client.stop()
        if key is not None:
            assert blob.startswith(b"BSNPSIG1")
            forged = bytearray(blob)
            forged[40] ^= 0x01
            client = serve()
            r = client.restore(bytes(forged))
            assert not r["ok"] and "HMAC" in r["error"]
            r = client.restore(blob[40:])
            assert not r["ok"] and "unsigned" in r["error"]
            client.stop()
        _reset_ids()
        client = serve()
        reply = client.restore(blob)
        assert reply["ok"] and reply["frame_id"] == cut, reply
        replies += [client.frame(f) for f in frames[cut:]]
    client.stop()
    assert all(r["ok"] for r in replies)
    return [(r["frame_id"], r["tracks"]) for r in replies]


@pytest.mark.parametrize("key", [None, KEY], ids=["unsigned", "signed"])
@pytest.mark.parametrize("flavour", ["byte_yolox", "transcenter",
                                     "centertrack", "strongsort_shim"])
def test_served_stream_restored_bitequal(flavour, key, engine):
    """A served stream snapshotted after frame 3 (signed or not) and
    restored on a fresh server with a fresh detector equals the unbroken
    stream exactly: ByteTrack + BUSCA behind YOLOX, TransCenter + BUSCA
    (its canvas in the blob), CenterTrack + BUSCA through
    ``CenterTrackRunnerDetector``, and StrongSORT through its
    ``FeatureShim``."""
    from busca_tpu_torch.eval.detector import CenterTrackRunnerDetector
    from busca_tpu_torch.eval.run import make_tracker, shim_for_runner

    kw = dict(track_thresh=0.3, use_busca=True, busca_thresh=0.01,
              seq_len=SEQ_LEN, num_candidates=NUM_CAN,
              use_camera_motion_compensation=False)
    if flavour == "byte_yolox":
        det = _tiny_yolox()
        make_detector = lambda: det  # noqa: E731 (stateless)
        frames = _server_frames(6)
        kw["track_thresh"] = 0.01
        factory = lambda: make_tracker("byte", kw, engine, (H, W))  # noqa
    elif flavour == "transcenter":
        make_detector = _tiny_transcenter()
        frames = [f for f, _, _ in _stream(6)]
        factory = lambda: make_tracker("transcenter", kw, engine,  # noqa
                                       (H, W))
    elif flavour == "centertrack":
        from test_torch_server import colour_centertrack

        ct, occluded = colour_centertrack()
        frames = occluded(30)[10:16]  # through object 1's dropout window

        def make_detector():
            from busca_tpu_torch.eval.detector import CenterTrackDetector

            return CenterTrackRunnerDetector(CenterTrackDetector(
                ct.config, ct.model.state_dict(), ct.test_size,
                ct.out_thresh, device="cpu"))

        factory = lambda: shim_for_runner("centertrack", make_tracker(  # noqa
            "centertrack", kw, engine, (H, W)))
    else:
        det = _tiny_yolox()
        make_detector = lambda: det  # noqa: E731
        frames = _server_frames(6)
        factory = _strongsort_factory
    want = _served(make_detector, factory, frames)
    got = _served(make_detector, factory, frames, cut=3, key=key)
    assert got == want
    assert any(tracks for _, tracks in want[3:]), "the tail saw no tracks"
