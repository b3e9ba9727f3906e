"""Online tracking server: frames in over a socket, tracks out (port of
``busca_tpu.serve.server``'s sequential mode).

A long-lived process owns the detector (live YOLOX, TransCenter or
CenterTrack on the card) and a tracker (optionally with the BUSCA engine),
and clients stream frames to it: the serving shape of the reference's eval
loop (mot_evaluator.py:131-235), with its per-sequence tracker reset
(mot_evaluator.py:166-173).

Wire protocol, the same both ways and the same bytes as busca_tpu's::

    [4-byte big-endian header length][JSON header][payload bytes]

where ``header["payload_bytes"]`` (default 0) sizes the raw payload.
Client -> server commands:

- ``{"cmd": "start", "name": ...}``: begin a sequence (a fresh tracker).
- ``{"cmd": "frame", "shape": [H, W, 3], "payload_bytes": N}`` + the uint8
  BGR pixels: track one frame; the reply carries the online tracks.
- ``{"cmd": "snapshot"}``: the reply's payload is the serialized tracker
  state (``serve/snapshot.py``), with the stream position and a feedback
  detector's previous canvas, so that a restored stream is bit-equal to the
  unbroken one.
- ``{"cmd": "restore", "name": ...}`` + a snapshot payload: resume a
  sequence from a snapshot instead of ``start``.  Live handles come from
  this server's factory; the frame id, name and detector state from the
  blob (a ``"frame_id"`` in the header overrides the blob's).  With a
  snapshot key, only blobs signed with it are accepted.
- ``{"cmd": "stop"}``: close the connection.

Replies are ``{"ok": true, ...}`` or ``{"ok": false, "error": msg}``: a bad
request is reported and the sequence survives it.

The device work per frame is the eval loop's, so the served ms/frame is the
loop's plus one frame's trip through the socket and its upload.  One
sequence per connection; connections are served one at a time per
:meth:`TrackingServer.serve_unix` loop.  ``--lockstep`` serves concurrent
connections instead, one batched device step per tick
(:mod:`busca_tpu_torch.serve.lockstep`); ``--detector-artifact`` serves an
exported detector (:mod:`busca_tpu_torch.serve.export`).
"""

from __future__ import annotations

import json
import os
import socket
import struct
import sys
import time
from typing import Callable, Optional

import numpy as np

_LEN = struct.Struct(">I")
_MAX_HEADER = 1 << 20
_MAX_PAYLOAD = 1 << 28


def _recv_exact(conn: socket.socket, n: int) -> Optional[bytearray]:
    """Exactly ``n`` bytes, received straight into one buffer (writable, so
    that a frame wraps it without a copy), or None on a closed
    connection."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = conn.recv_into(view[got:], n - got)
        if not k:
            return None
        got += k
    return buf


def send_msg(conn: socket.socket, header: dict, payload: bytes = b""):
    if payload:
        header = dict(header, payload_bytes=len(payload))
    raw = json.dumps(header).encode()
    conn.sendall(_LEN.pack(len(raw)) + raw)
    if payload:
        conn.sendall(payload)


def recv_msg(conn: socket.socket):
    """``(header, payload)``, or None on a closed connection.  The payload
    is a writable ``bytearray`` (``b""`` when there is none)."""
    raw = _recv_exact(conn, _LEN.size)
    if raw is None:
        return None
    (hlen,) = _LEN.unpack(raw)
    if hlen > _MAX_HEADER:
        raise ValueError(f"header too large: {hlen}")
    hraw = _recv_exact(conn, hlen)
    if hraw is None:
        return None
    header = json.loads(hraw)
    n = int(header.get("payload_bytes", 0)) if isinstance(header, dict) else 0
    if not 0 <= n <= _MAX_PAYLOAD:
        raise ValueError(f"bad payload size: {n}")
    payload = _recv_exact(conn, n) if n else b""
    if payload is None:
        return None
    return header, payload


def _unlink_quiet(path: str):
    try:
        os.unlink(path)
    except OSError:
        pass


def _bind_unix(path: str, backlog: int = 16) -> socket.socket:
    """Bind a unix listener, replacing a stale socket file of a dead server
    (which would otherwise leave 'Address already in use').  A live server's
    socket (one that accepts a connection) is never taken."""
    import errno
    import stat

    try:
        if stat.S_ISSOCK(os.stat(path).st_mode):
            probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                probe.settimeout(1.0)
                probe.connect(path)
            except OSError as e:
                if e.errno == errno.ECONNREFUSED:
                    os.unlink(path)  # confirmed stale
                # a timeout or another error: leave it, bind reports it
            else:
                raise OSError(errno.EADDRINUSE,
                              f"a live server is already bound to {path}")
            finally:
                probe.close()
    except FileNotFoundError:
        pass
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    srv.listen(backlog)
    return srv


class TrackingServer:
    """Serve one detector + tracker pipeline over stream sockets.

    Args:
      detector: a frame-loop detector (``detect(frame) -> DetectorOutput``);
        one with ``uses_feedback`` gets the tracker's
        ``get_detector_positions()`` each frame, and one with
        ``state_dict`` has its cross-frame state carried in snapshots.
      tracker_factory: a zero-argument callable returning a fresh tracker
        per sequence (e.g. :func:`build_tracker_runtime`'s).
      min_box_area / vertical_thresh: the eval loop's output filters
        (mot_evaluator.py:211-220).
      snapshot_key: an HMAC key: snapshots are signed with it and restore
        accepts only blobs that verify.
    """

    def __init__(self, detector, tracker_factory: Callable[[], object],
                 min_box_area: float = 100.0,
                 vertical_thresh: Optional[float] = 1.6,
                 snapshot_key: Optional[bytes] = None):
        self.detector = detector
        self.tracker_factory = tracker_factory
        self.min_box_area = min_box_area
        self.vertical_thresh = vertical_thresh
        self.snapshot_key = snapshot_key

    # ------------------------------------------------------------- handlers --
    def _handle_frame(self, state: dict, header: dict, payload) -> dict:
        from busca_tpu_torch.eval.runner import filter_output_tracks

        tracker = state["tracker"]
        if tracker is None:
            return {"ok": False, "error": "no sequence started (send 'start')"}
        shape = tuple(header.get("shape", ()))
        if len(shape) != 3 or shape[2] != 3:
            return {"ok": False, "error": f"bad frame shape {shape}"}
        want = int(np.prod(shape))
        if len(payload) != want:
            return {"ok": False,
                    "error": f"payload is {len(payload)} bytes, shape needs "
                             f"{want}"}
        # the received buffer is writable: the frame wraps it, no copy
        frame = np.frombuffer(payload, np.uint8).reshape(shape)
        if hasattr(self.detector, "reset") and state["frame_id"] == 0:
            self.detector.reset()
        t0 = time.perf_counter()
        if getattr(self.detector, "uses_feedback", False) and hasattr(
                tracker, "get_detector_positions"):
            # the stateful detector <-> tracker loop (TransCenter
            # mot_evaluator.py:158, CenterTrack's prior heatmap)
            det = self.detector.detect(
                frame, current_pos=tracker.get_detector_positions())
        else:
            det = self.detector.detect(frame)
        online = tracker.update(det.boxes_tlbr / det.scale, det.scores,
                                det.scale, det.image)
        ms = (time.perf_counter() - t0) * 1e3
        tlwhs, ids, confs = filter_output_tracks(online, self.min_box_area,
                                                 self.vertical_thresh)
        state["frame_id"] += 1
        return {
            "ok": True,
            "frame_id": state["frame_id"],
            "ms": round(ms, 3),
            "tracks": [{"id": int(i), "tlwh": [float(v) for v in t],
                        "score": float(c)}
                       for t, i, c in zip(tlwhs, ids, confs)],
        }

    def _snapshot(self, state: dict):
        """``(header, blob)`` of the live sequence: the tracker, the stream
        position and the detector's cross-frame state."""
        from busca_tpu_torch.serve.snapshot import snapshot_bytes

        meta = {"frame_id": state["frame_id"], "name": state["name"]}
        if hasattr(self.detector, "state_dict"):
            # TransCenter's pre_sample, CenterTrack's pre_images
            # (transcenter.py:89-92): restored, the next frame equals the
            # unbroken stream's
            meta["detector"] = self.detector.state_dict()
        blob = snapshot_bytes(state["tracker"], meta=meta,
                              key=self.snapshot_key)
        return {"ok": True, "frame_id": state["frame_id"],
                "name": state["name"]}, blob

    def _restore(self, state: dict, header: dict, payload) -> dict:
        from busca_tpu_torch.serve.snapshot import restore_with_meta

        tracker, meta = restore_with_meta(payload,
                                          donor=self.tracker_factory(),
                                          key=self.snapshot_key)
        state["tracker"] = tracker
        # the blob holds the stream position; a header frame_id overrides it
        if header.get("frame_id") is not None:
            state["frame_id"] = int(header["frame_id"])
        else:
            state["frame_id"] = int(meta.get("frame_id", 0))
        state["name"] = header.get("name") or meta.get("name")
        det_state = meta.get("detector")
        if det_state is not None and hasattr(self.detector,
                                             "load_state_dict"):
            self.detector.load_state_dict(det_state)
        elif hasattr(self.detector, "reset"):
            # no captured state: TransCenter re-primes from the restored
            # tracker's priors, CenterTrack takes a frame without a prior
            self.detector.reset()
        return {"ok": True, "name": state["name"],
                "frame_id": state["frame_id"]}

    # ---------------------------------------------------------------- serve --
    def serve_connection(self, conn: socket.socket):
        """The request loop of one connection (one sequence at a time).

        Handler errors are replied in-band; transport and framing errors
        (a broken pipe, an oversized or garbled message) end only this
        connection, and the caller's accept loop goes on."""
        state = {"tracker": None, "frame_id": 0, "name": None}
        while True:
            msg = recv_msg(conn)
            if msg is None:
                return
            header, payload = msg
            cmd = header.get("cmd") if isinstance(header, dict) else None
            blob = b""
            try:
                if cmd == "start":
                    state.update(tracker=self.tracker_factory(), frame_id=0,
                                 name=header.get("name"))
                    reply = {"ok": True, "name": state["name"]}
                elif cmd == "frame":
                    reply = self._handle_frame(state, header, payload)
                elif cmd == "snapshot":
                    if state["tracker"] is None:
                        reply = {"ok": False, "error": "no sequence started"}
                    else:
                        reply, blob = self._snapshot(state)
                elif cmd == "restore":
                    reply = self._restore(state, header, payload)
                elif cmd == "stop":
                    send_msg(conn, {"ok": True, "bye": True})
                    return
                else:
                    reply = {"ok": False, "error": f"unknown cmd {cmd!r}"}
            except Exception as e:  # reply, keep serving
                reply, blob = {"ok": False,
                               "error": f"{type(e).__name__}: {e}"}, b""
            send_msg(conn, reply, blob)

    def serve_unix(self, path: str, max_connections: Optional[int] = None):
        """Accept loop on a unix socket, serving connections one after the
        other (one card, one pipeline: run a server per card to scale)."""
        srv = _bind_unix(path)
        served = 0
        try:
            while max_connections is None or served < max_connections:
                conn, _ = srv.accept()
                try:
                    self.serve_connection(conn)
                except (OSError, ValueError) as e:
                    # one misbehaving client (a disconnect mid-reply, a
                    # garbled frame) must not take the server down
                    # (json.JSONDecodeError is a ValueError)
                    print(f"connection error: {type(e).__name__}: {e}",
                          file=sys.stderr, flush=True)
                finally:
                    conn.close()
                served += 1
        finally:
            srv.close()
            _unlink_quiet(path)


class TrackingClient:
    """A client of :class:`TrackingServer`."""

    def __init__(self, conn: socket.socket):
        self.conn = conn

    @classmethod
    def connect_unix(cls, path: str) -> "TrackingClient":
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.connect(path)
        return cls(conn)

    def _request(self, header: dict, payload: bytes = b""):
        send_msg(self.conn, header, payload)
        msg = recv_msg(self.conn)
        if msg is None:
            raise ConnectionError("server closed the connection")
        return msg

    def _roundtrip(self, header: dict, payload: bytes = b"") -> dict:
        return self._request(header, payload)[0]

    def start(self, name: str = "seq") -> dict:
        return self._roundtrip({"cmd": "start", "name": name})

    def frame(self, frame_bgr: np.ndarray) -> dict:
        frame_bgr = np.ascontiguousarray(frame_bgr, np.uint8)
        return self._roundtrip({"cmd": "frame",
                                "shape": list(frame_bgr.shape)},
                               memoryview(frame_bgr).cast("B"))

    def snapshot(self) -> tuple:
        """The live sequence's state, ``(header, blob)``: resume it with
        :meth:`restore` on any server built from the same factory."""
        header, blob = self._request({"cmd": "snapshot"})
        if not header.get("ok", False):
            raise RuntimeError(header.get("error", "snapshot failed"))
        return header, bytes(blob)

    def restore(self, blob: bytes, frame_id: Optional[int] = None,
                name: Optional[str] = None) -> dict:
        """Resume from a snapshot blob; the frame id and name default to the
        blob's."""
        header = {"cmd": "restore", "name": name}
        if frame_id is not None:
            header["frame_id"] = int(frame_id)
        return self._roundtrip(header, blob)

    def stop(self) -> dict:
        reply = self._roundtrip({"cmd": "stop"})
        self.conn.close()
        return reply


def build_tracker_runtime(args):
    """The engine and a per-stream tracker factory from parsed CLI args, as
    the eval CLI composes them (``eval/run.py``): the BUSCA YAML bundle's
    tracker kwargs first, explicit flags over them.  ``args`` needs
    ``use_busca``, ``tracker`` and ``reid_ckpt``; ``busca_config``,
    ``busca_ckpt``, ``busca_dtype``, ``reid_stats``, ``device``, ``seed``,
    ``crop_hw``, ``track_thresh``, ``cmc_scale`` and ``mem_cap`` are read
    where present.
    An invalid ``mem_cap`` raises ``ValueError`` here, at start-up, not in
    the factory on a client's first connection."""
    from busca_tpu_torch.eval import run as run_mod

    device = getattr(args, "device", "cuda")
    crop_hw = tuple(getattr(args, "crop_hw", (384, 128)))
    engine, busca_kwargs = None, {}
    if args.use_busca:
        engine, busca_kwargs = run_mod.build_engine(
            args.busca_config, args.busca_ckpt, device=device,
            crop_hw=crop_hw, seed=getattr(args, "seed", 0),
            dtype=getattr(args, "busca_dtype", None),
            reid_stats=getattr(args, "reid_stats", "batch"))
        busca_kwargs["use_busca"] = True

    feature_extractor = None
    if args.reid_ckpt:
        from busca_tpu_torch.eval.features import ReidFeatureExtractor

        feature_extractor = ReidFeatureExtractor.from_checkpoint(
            args.reid_ckpt, crop_hw=crop_hw, device=device)

    # an unset --track-thresh falls back to the YAML bundle's value, then to
    # ByteTrack's 0.6
    tracker_kwargs = dict(busca_kwargs)
    if getattr(args, "track_thresh", None) is not None:
        tracker_kwargs["track_thresh"] = args.track_thresh
    elif "track_thresh" not in tracker_kwargs:
        tracker_kwargs["track_thresh"] = 0.6
    if getattr(args, "cmc_scale", 1.0) != 1.0:
        tracker_kwargs["cmc_scale"] = args.cmc_scale
    if getattr(args, "mem_cap", None) is not None:
        if args.mem_cap < 4:
            raise ValueError(
                f"--mem-cap must be >= 4 (recommended >= ~5*seq_len), "
                f"got {args.mem_cap}")
        if args.tracker not in run_mod.MEM_CAP_TRACKERS:
            raise ValueError(
                f"--mem-cap only applies to the byte-family trackers "
                f"{run_mod.MEM_CAP_TRACKERS}, not --tracker {args.tracker}")
        tracker_kwargs["mem_cap"] = args.mem_cap

    def factory():
        trk = run_mod.make_tracker(args.tracker, dict(tracker_kwargs), engine,
                                   crop_hw, feature_extractor)
        return run_mod.shim_for_runner(args.tracker, trk, feature_extractor,
                                       crop_hw)

    return engine, factory


def load_artifact_detector(artifact_dir: str, device="cuda"):
    """The detector of a ``serve/export.py`` artifact directory: an
    ``ArtifactBatchDetector`` for a ``--batches`` family, else an
    ``ArtifactDetector`` (both CLIs' ``--detector-artifact``)."""
    from busca_tpu_torch.serve.detector import (
        ArtifactBatchDetector,
        ArtifactDetector,
    )

    from busca_tpu_torch.serve.export import artifact_kind

    if artifact_kind(artifact_dir) == "yolox_detector_batch_steps":
        return ArtifactBatchDetector(artifact_dir, device=device)
    return ArtifactDetector(artifact_dir, device=device)


DETECTORS = ("yolox-tiny", "yolox-s", "yolox-m", "yolox-l", "yolox-x",
             "transcenter", "centertrack")


def main(argv=None):
    """``python -m busca_tpu_torch.serve.server``: serve a live detector and
    a tracker on a unix socket, on the card (``--device cpu`` for a CPU
    drive)."""
    import argparse

    from busca_tpu_torch.trackers.cmc import parse_scale

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--socket", required=True, help="unix socket path")
    p.add_argument("--detector", default=None, choices=DETECTORS,
                   help="the live detector")
    p.add_argument("--detector-artifact", default=None,
                   help="a serve.export artifact directory to serve instead "
                        "of a live detector: a single-frame step, or a "
                        "--batches family for --lockstep")
    p.add_argument("--detector-ckpt", default=None,
                   help="official YOLOX .pth, published CenterTrack DLA-34 "
                        ".pth, or busca_tpu .npz; default: random weights "
                        "from --seed")
    p.add_argument("--centertrack-arch", default="dla34",
                   choices=("dla34", "tiny", "mobilenet"))
    p.add_argument("--centertrack-sampling", default="deformable",
                   choices=("deformable", "windowed", "local"))
    p.add_argument("--transcenter-sampling", default="local",
                   choices=("local", "deformable"),
                   help="TransCenter's decoder attention: the local "
                        "multi-scale taps (kernel K2 on the card) or the "
                        "published multi-scale deformable attention")
    p.add_argument("--test-h", type=int, default=800)
    p.add_argument("--test-w", type=int, default=1440)
    p.add_argument("--det-conf", type=float, default=0.1)
    p.add_argument("--tracker", default="byte",
                   choices=("byte", "transcenter", "centertrack",
                            "strongsort", "deepsort", "ghost", "sort",
                            "motdt"))
    p.add_argument("--cmc-scale", type=parse_scale, default=1.0,
                   help="ECC camera-motion solve resolution in (0, 1]")
    p.add_argument("--track-thresh", type=float, default=None,
                   help="first-round score threshold; default: the YAML "
                        "bundle's with --use-busca, else 0.6")
    p.add_argument("--mem-cap", type=int, default=None,
                   help="bound each track's appearance memory to this many "
                        "entries (a dense recent tail and an even-stride "
                        "archive) for long streams; default: unbounded, the "
                        "reference's semantics; >= 4, ~5*seq_len "
                        "recommended; byte-family, strongsort, deepsort and "
                        "ghost trackers")
    p.add_argument("--reid-ckpt", default=None,
                   help="ReID checkpoint for the feature trackers "
                        "(strongsort, deepsort, ghost, motdt)")
    p.add_argument("--use-busca", action="store_true")
    p.add_argument("--busca-config", default=None)
    p.add_argument("--busca-ckpt", default=None,
                   help=".npz or reference .pth; default: random weights "
                        "from --seed")
    p.add_argument("--busca-dtype", default="bfloat16",
                   choices=("bfloat16", "float32"),
                   help="BUSCA compute dtype: bfloat16 (the production "
                        "default, as the eval CLI) or float32 (parity)")
    p.add_argument("--reid-stats", choices=("batch", "frozen", "auto"),
                   default="batch",
                   help="BUSCA's ReID BN: 'batch' (the reference's batch "
                        "statistics), 'frozen' (the checkpoint's running "
                        "statistics, features cached across frames in a "
                        "device bank: an opt-in deviation) or 'auto' "
                        "(frozen numerics, the smallest calls fused)")
    p.add_argument("--snapshot-key-file", default=None,
                   help="a file holding an HMAC key: snapshots are signed "
                        "and restore refuses unsigned or forged blobs")
    p.add_argument("--max-connections", type=int, default=None)
    p.add_argument("--min-box-area", type=float, default=None,
                   help="output filter; default 100 px, 0 for --tracker "
                        "centertrack (its eval loop filters nothing)")
    p.add_argument("--vertical-thresh", type=float, default=None,
                   help="w/h output filter; default 1.6, off for --tracker "
                        "centertrack; 0 turns it off")
    p.add_argument("--lockstep", action="store_true",
                   help="serve concurrent connections with one batched "
                        "device step per tick (serve/lockstep.py) instead "
                        "of one connection at a time")
    p.add_argument("--tick-timeout", type=float, default=0.010,
                   help="the lockstep straggler wait per tick, seconds")
    p.add_argument("--lockstep-dp", type=int, default=None,
                   help="split each tick's batch over this many devices of "
                        "the process (cuda:0..N-1, one replica of the live "
                        "yolox --detector each); needs --lockstep")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights of a model without a "
                        "checkpoint")
    p.add_argument("--crop-h", type=int, default=384)
    p.add_argument("--crop-w", type=int, default=128)
    # the eval CLI's detector builder reads these; busca_tpu's server has no
    # flags for them
    p.set_defaults(detector_dataset="mot17", det_nms=0.7)
    args = p.parse_args(argv)
    args.crop_hw = (args.crop_h, args.crop_w)

    if args.use_busca and not args.busca_config:
        p.error("--use-busca requires --busca-config")
    if args.detector is None and not args.detector_artifact:
        p.error("pick --detector or --detector-artifact")
    if args.lockstep and not args.detector_artifact and args.detector in (
            "transcenter", "centertrack"):
        p.error(f"{args.detector} cannot lockstep: its detector is stateful "
                "per sequence and takes per-frame tracker feedback")
    if args.detector == "centertrack" and args.tracker != "centertrack":
        p.error("--detector centertrack needs --tracker centertrack")
    lockstep_devices = None
    if args.lockstep_dp:
        # busca_tpu's rules (busca_tpu/serve/server.py:605-615)
        if args.detector_artifact:
            p.error("--lockstep-dp needs a live --detector (an artifact's "
                    "programs hold one device)")
        if not args.lockstep:
            p.error("--lockstep-dp requires --lockstep")
        from busca_tpu_torch.parallel.mesh import local_devices

        try:
            lockstep_devices = local_devices(args.lockstep_dp, args.device)
        except ValueError as e:
            p.error(str(e))

    from busca_tpu_torch.eval.detector import CenterTrackRunnerDetector
    from busca_tpu_torch.eval.run import build_detector
    from busca_tpu_torch.utils.device import set_card_precision

    set_card_precision()
    try:
        if args.detector_artifact:
            from busca_tpu_torch.serve.export import artifact_kind

            if args.lockstep and artifact_kind(args.detector_artifact) != \
                    "yolox_detector_batch_steps":
                p.error("--lockstep needs a batch-capable detector: a live "
                        "--detector or a --batches artifact family "
                        "(python -m busca_tpu_torch.serve.export --batches "
                        "1 2 4 8)")
            detector = load_artifact_detector(args.detector_artifact,
                                              args.device)
        else:
            detector = build_detector(args)
            if args.detector == "centertrack":
                detector = CenterTrackRunnerDetector(detector)
            if lockstep_devices is not None:
                detector.shard_lockstep(lockstep_devices)
        _, factory = build_tracker_runtime(args)
    except ValueError as e:
        p.error(str(e))

    snapshot_key = None
    if args.snapshot_key_file:
        with open(args.snapshot_key_file, "rb") as f:
            snapshot_key = f.read().strip()
        if not snapshot_key:
            p.error(f"--snapshot-key-file {args.snapshot_key_file} is empty")

    # the output filters default to the matching eval loop's: the BYTE
    # runner filters (mot_evaluator.py:216-221), track_frames_centertrack
    # emits every dict track
    min_area = args.min_box_area
    if min_area is None:
        min_area = 0.0 if args.tracker == "centertrack" else 100.0
    vthresh = args.vertical_thresh
    if vthresh is None:
        vthresh = None if args.tracker == "centertrack" else 1.6
    elif vthresh <= 0:
        vthresh = None

    if args.lockstep:
        from busca_tpu_torch.serve.lockstep import LockstepTrackingServer

        server = LockstepTrackingServer(
            detector, factory, tick_timeout=args.tick_timeout,
            min_box_area=min_area, vertical_thresh=vthresh,
            snapshot_key=snapshot_key)
    else:
        server = TrackingServer(detector, factory, min_box_area=min_area,
                                vertical_thresh=vthresh,
                                snapshot_key=snapshot_key)
    print(f"serving on {args.socket}", flush=True)
    server.serve_unix(args.socket, max_connections=args.max_connections)


if __name__ == "__main__":
    main()
