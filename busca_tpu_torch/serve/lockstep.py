"""Lockstep tracking server: many client streams, one batched device step
per tick (port of ``busca_tpu.serve.lockstep``).

Online tracking is causally batch-1 per sequence, but across sequences the
detector and the BUSCA third round batch freely (the eval side's
``--lockstep``, ``eval/detector.py::track_sequences_lockstep``).  This
server accepts N concurrent connections (one tracked sequence each, the wire
protocol of :mod:`busca_tpu_torch.serve.server`), and a scheduler thread
coalesces their in-flight frames into one ``detect_batch`` call per frame
resolution plus ONE grouped third-round association per tick
(``trackers/base.py::service_deferred_updates``; per-request BN groups keep
every stream's numbers equal to a standalone call; an engine with
``reid_stats='frozen'`` scores the tick's requests in the frozen branch of
``associate_many``, where frozen features couple no streams).

Batching policy: a tick fires when every active stream has a frame queued,
or after ``tick_timeout`` (default 10 ms) for stragglers: a slow client adds
at most the timeout to its peers' latency and never stalls them.  Streams
with different frame resolutions are grouped per resolution within a tick.

One deliberate difference from busca_tpu: a group is not padded to a power
of two.  busca_tpu pads (repeating the last frame) to bound XLA's compiled
shapes; the port's float32 YOLOX gives a frame the same rows in any batch
(``models/precision.py::gemm_conv2d``), and a pad lane would cost a whole
frame of detector work.  The live detector gets the unpadded batch; an
``ArtifactBatchDetector`` pads to its exported buckets itself.
"""

from __future__ import annotations

import itertools
import socket
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from busca_tpu_torch.serve.server import recv_msg, send_msg
from busca_tpu_torch.utils import profiling


class _Session:
    def __init__(self, sid: int):
        self.sid = sid
        self.tracker = None
        self.frame_id = 0
        self.name = None
        # one in-flight frame at most (the protocol is request/response)
        self.pending_frame = None
        self.queue_wait = None  # its serve.queue_wait span
        self.reply = None
        self.done = threading.Event()


class LockstepTrackingServer:
    """See the module docstring.

    Args:
      detector: a batch-capable detector (``detect_batch(frames) -> list``):
        a live ``YoloxDetector`` or an ``ArtifactBatchDetector``.
      tracker_factory: a fresh tracker per started sequence.
      tick_timeout: seconds a tick waits for stragglers before running a
        partial batch.
      min_box_area / vertical_thresh: the eval loop's output filters.
      snapshot_key: an HMAC key: snapshots are signed with it and restore
        accepts only blobs that verify.
    """

    def __init__(
        self,
        detector,
        tracker_factory: Callable[[], object],
        tick_timeout: float = 0.010,
        min_box_area: float = 100.0,
        vertical_thresh: Optional[float] = 1.6,
        snapshot_key: Optional[bytes] = None,
    ):
        self.detector = detector
        self.tracker_factory = tracker_factory
        self.tick_timeout = tick_timeout
        self.min_box_area = min_box_area
        self.vertical_thresh = vertical_thresh
        self.snapshot_key = snapshot_key
        self._lock = threading.Condition()
        self._sessions: Dict[int, _Session] = {}
        self._sid = itertools.count(1)
        self._stop = False
        self._scheduler = None
        # the last tick taken: its number, the active streams, and whether
        # its timeout fired with streams still missing
        self._tick = (0, 0, False)

    # -------------------------------------------------------------- lifecycle --
    def start_scheduler(self):
        if self._scheduler is None:
            self._scheduler = threading.Thread(
                target=self._scheduler_loop, daemon=True)
            self._scheduler.start()

    def close(self):
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        if self._scheduler is not None:
            self._scheduler.join(timeout=10)
            if self._scheduler.is_alive():
                # stuck past the timeout (a long first launch): leave _stop
                # set so that it exits at its next wake instead of racing a
                # later scheduler
                return
            self._scheduler = None
        self._stop = False

    # -------------------------------------------------------------- scheduler --
    def _ready(self) -> List[_Session]:
        return [s for s in self._sessions.values()
                if s.pending_frame is not None]

    def _active_count(self) -> int:
        return sum(1 for s in self._sessions.values() if s.tracker is not None)

    def _next_tick(self):
        """Wait for a tick (every active stream's frame, or the timeout
        after the first) and take its frames; None once stopped."""
        with self._lock:
            while not self._stop and not self._ready():
                self._lock.wait(0.1)
            if self._stop:
                return None
            # wait (bounded) for the other active streams' frames so that
            # the batch fills; stragglers forfeit their slot this tick
            deadline = time.monotonic() + self.tick_timeout
            while not self._stop and len(self._ready()) < self._active_count():
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._lock.wait(left)
            if self._stop:
                return None
            batch = self._ready()
            active = self._active_count()
            tick = self._tick[0] + 1
            self._tick = (tick, active, len(batch) < active)
            items = [(s, s.pending_frame) for s in batch]
            for s in batch:
                s.pending_frame = None
                s.queue_wait.end(rid=(tick, s.sid, s.frame_id + 1))
            return items

    def _scheduler_loop(self):
        import torch

        # grad mode is per thread: this thread's device work runs without
        # autograd whatever the caller's thread had set
        with torch.no_grad():
            while True:
                items = self._next_tick()
                if items is None:
                    return
                # the device and tracker work runs outside the lock: new
                # frames queue meanwhile for the next tick.  _run_tick
                # handles its own failures (it knows which streams it has
                # serviced: a serviced client may already have submitted its
                # next frame)
                self._run_tick(items)

    def _run_tick(self, items):
        """Service one tick; never raises.  A failure errors only the
        streams NOT yet serviced this tick: a serviced stream's client may
        already wait on its next frame (done cleared, a new frame queued),
        and overwriting its reply would shift that stream by a frame."""
        serviced = set()
        try:
            self._run_tick_inner(items, serviced)
        except Exception as e:
            for s, _ in items:
                if s.sid in serviced:
                    continue
                s.reply = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                s.done.set()

    def _run_tick_inner(self, items, serviced):
        tick, active, partial = self._tick
        attrs = ({"frames": len(items), "active": active, "timeout": partial}
                 if profiling.tracing() else None)
        # the tick's spans carry its number; each stream's update also its
        # sid and frame id
        with profiling.span("serve.tick", rid=(tick,), attrs=attrs), \
                profiling.request((tick,)):
            self._serve_tick(items, serviced, tick)

    def _serve_tick(self, items, serviced, tick):
        from busca_tpu_torch.eval.runner import filter_output_tracks
        from busca_tpu_torch.trackers.base import service_deferred_updates

        # one batched detector call per distinct frame shape
        by_hw: Dict[tuple, list] = {}
        for s, frame in items:
            by_hw.setdefault(frame.shape, []).append((s, frame))
        onlines = {}
        pending = []
        groups = []
        tick_t0 = time.perf_counter()
        for group in by_hw.values():
            # no pad lanes (module docstring): the detector sees n frames
            dets = self.detector.detect_batch(np.stack([f for _, f in group]))
            for (s, _), d in zip(group, dets):
                s.frame_id += 1
                args = (d.boxes_tlbr / d.scale, d.scores, d.scale, d.image)
                with profiling.request((tick, s.sid, s.frame_id)):
                    if hasattr(s.tracker, "update_deferred"):
                        gen = s.tracker.update_deferred(*args)
                        try:
                            pending.append((s.sid, gen, next(gen)))
                        except StopIteration as e:
                            onlines[s.sid] = e.value
                    else:
                        onlines[s.sid] = s.tracker.update(*args)
            groups.append(group)
        if pending:
            # ONE grouped association serves every stream's third round,
            # across ALL resolution groups (the crops are fixed-size)
            onlines.update(service_deferred_updates(pending))
        tick_ms = (time.perf_counter() - tick_t0) * 1e3
        for group in groups:
            for s, _ in group:
                tlwhs, ids, confs = filter_output_tracks(
                    onlines[s.sid], self.min_box_area, self.vertical_thresh)
                s.reply = {
                    "ok": True,
                    "frame_id": s.frame_id,
                    "batch": len(group),
                    "tick_ms": round(tick_ms, 3),
                    "tracks": [{"id": int(i), "tlwh": [float(v) for v in t],
                                "score": float(c)}
                               for t, i, c in zip(tlwhs, ids, confs)],
                }
                s.done.set()
                serviced.add(s.sid)

    # ------------------------------------------------------------ connections --
    def serve_connection(self, conn: socket.socket):
        """The request loop of one client (on the connection's thread)."""
        from busca_tpu_torch.serve.snapshot import (
            restore_with_meta,
            snapshot_bytes,
        )

        with self._lock:
            sess = _Session(next(self._sid))
            self._sessions[sess.sid] = sess
        try:
            while True:
                msg = recv_msg(conn)
                if msg is None:
                    return
                header, payload = msg
                cmd = header.get("cmd") if isinstance(header, dict) else None
                blob = b""
                try:
                    if cmd == "start":
                        # built OUTSIDE the scheduler lock: a factory doing
                        # real work must not stall the peers' submissions
                        trk = self.tracker_factory()
                        with self._lock:
                            sess.tracker = trk
                            sess.frame_id = 0
                            sess.name = header.get("name")
                        reply = {"ok": True, "name": sess.name}
                    elif cmd == "frame":
                        reply = self._submit_frame(sess, header, payload)
                    elif cmd == "snapshot":
                        # the session's tracker is quiescent here: this
                        # client has no frame in flight, and other
                        # sessions' ticks touch only their own trackers
                        if sess.tracker is None:
                            reply = {"ok": False,
                                     "error": "no sequence started"}
                        else:
                            blob = snapshot_bytes(
                                sess.tracker,
                                meta={"frame_id": sess.frame_id,
                                      "name": sess.name},
                                key=self.snapshot_key)
                            reply = {"ok": True, "frame_id": sess.frame_id,
                                     "name": sess.name}
                    elif cmd == "restore":
                        # the factory and the unpickling OUTSIDE the lock
                        trk, meta = restore_with_meta(
                            payload, donor=self.tracker_factory(),
                            key=self.snapshot_key)
                        fid = header.get("frame_id")
                        if fid is None:
                            fid = meta.get("frame_id", 0)
                        with self._lock:
                            sess.tracker = trk
                            sess.frame_id = int(fid)
                            sess.name = header.get("name") or meta.get("name")
                        reply = {"ok": True, "name": sess.name,
                                 "frame_id": sess.frame_id}
                    elif cmd == "stop":
                        send_msg(conn, {"ok": True, "bye": True})
                        return
                    else:
                        reply = {"ok": False,
                                 "error": f"unknown cmd {cmd!r}"}
                except Exception as e:  # reply, keep serving
                    reply, blob = {"ok": False,
                                   "error": f"{type(e).__name__}: {e}"}, b""
                send_msg(conn, reply, blob)
        finally:
            with self._lock:
                del self._sessions[sess.sid]
                self._lock.notify_all()

    def _submit_frame(self, sess: _Session, header: dict, payload) -> dict:
        if sess.tracker is None:
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
        sess.done.clear()
        sess.reply = None
        with self._lock:
            sess.queue_wait = profiling.begin("serve.queue_wait")
            sess.pending_frame = frame
            self._lock.notify_all()
        sess.done.wait()
        return sess.reply

    def serve_unix(self, path: str, max_connections: Optional[int] = None):
        """Accept loop: a thread per connection; the shared scheduler
        thread batches across them (``TrackingServer.serve_unix`` serves one
        connection at a time)."""
        from busca_tpu_torch.serve.server import _bind_unix, _unlink_quiet

        self.start_scheduler()
        srv = _bind_unix(path)
        threads = []
        accepted = 0
        try:
            while max_connections is None or accepted < max_connections:
                conn, _ = srv.accept()
                accepted += 1
                t = threading.Thread(target=self._serve_and_close,
                                     args=(conn,), daemon=True)
                t.start()
                threads.append(t)
        finally:
            srv.close()
            _unlink_quiet(path)
            for t in threads:
                t.join(timeout=30)
            self.close()

    def _serve_and_close(self, conn: socket.socket):
        try:
            self.serve_connection(conn)
        except (OSError, ValueError) as e:
            # one misbehaving client (a disconnect mid-reply, a garbled
            # frame) ends only its own connection
            print(f"connection error: {type(e).__name__}: {e}",
                  file=sys.stderr, flush=True)
        finally:
            conn.close()
