"""The load generator of the served cells: one process, one closed-loop
client thread per stream, numpy only (it imports neither torch nor the
program).

    python benchmark/bmk/loadgen.py --mix FILE --seed N --socket PATH \
        --seconds S

It renders its streams (while the server builds its models), then follows
the run's commands on standard input, one line each, and answers on
standard output, one JSON line each:

- ``warm``: each stream runs ``warmup_frames`` frames on a warm-up
  connection of its own, all streams at once, then closes it; answers
  ``{"event": "warmed"}``.
- ``connect``: the real streams connect and start, one after the other in
  ``traffic.stream_order``'s order; answers ``{"event": "ready"}``.
- ``go T``: the window opens at ``T`` (``time.perf_counter``, the system's
  monotonic clock) and lasts ``--seconds``; each client sends its next
  frame as soon as the previous reply is in, until the window closes, then
  stops.  Answers ``{"event": "done", "streams": ...}`` with each frame's
  send and reply times, reply status and tracks.

The wire protocol is the program's (a 4-byte big-endian header length, a
JSON header, the payload), written out here so that the yardstick does not
move with the program.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import struct
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bmk import traffic  # noqa: E402

_LEN = struct.Struct(">I")
TIMEOUT_S = 120.0


def _recv_exact(conn, n):
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = conn.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("server closed the connection")
        got += k
    return buf


def request(conn, header: dict, payload=b"") -> dict:
    if payload:
        header = dict(header, payload_bytes=len(payload))
    raw = json.dumps(header).encode()
    conn.sendall(_LEN.pack(len(raw)) + raw)
    if payload:
        conn.sendall(payload)
    (hlen,) = _LEN.unpack(_recv_exact(conn, _LEN.size))
    reply = json.loads(_recv_exact(conn, hlen))
    n = int(reply.get("payload_bytes", 0))
    if n:
        _recv_exact(conn, n)
    return reply


def connect(path: str, name: str):
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    conn.settimeout(TIMEOUT_S)
    conn.connect(path)
    reply = request(conn, {"cmd": "start", "name": name})
    if not reply.get("ok"):
        raise RuntimeError(f"start {name}: {reply}")
    return conn


def stop(conn):
    try:
        request(conn, {"cmd": "stop"})
    finally:
        conn.close()


def frame_msg(frame):
    return ({"cmd": "frame", "shape": list(frame.shape)},
            memoryview(frame).cast("B"))


def warm(path, frames, name, n, k0):
    conn = connect(path, name)
    for k in range(k0, k0 + n):
        reply = request(conn, *frame_msg(frames[traffic.pingpong(k, len(
            frames))]))
        if not reply.get("ok"):
            raise RuntimeError(f"warm-up frame {k} of {name}: {reply}")
    stop(conn)


def client(conn, frames, k0, t_end, out):
    """The closed loop of one stream from step ``k0`` until ``t_end``."""
    k = k0
    while True:
        t0 = time.perf_counter()
        if t0 >= t_end:
            break
        idx = traffic.pingpong(k, len(frames))
        try:
            reply = request(conn, *frame_msg(frames[idx]))
            ok = bool(reply.get("ok"))
        except (OSError, ValueError, ConnectionError) as e:
            reply, ok = {"error": f"{type(e).__name__}: {e}"}, False
        t1 = time.perf_counter()
        out["frame"].append(idx)
        out["send"].append(t0)
        out["recv"].append(t1)
        out["ok"].append(ok)
        out["server_ms"].append(reply.get("tick_ms", reply.get("ms")))
        out["tracks"].append([[t["id"], *t["tlwh"]]
                              for t in reply.get("tracks", [])]
                             if ok else reply.get("error", "not ok"))
        k += 1
        if not ok:
            break
    stop(conn)


def say(event: dict):
    sys.stdout.write(json.dumps(event) + "\n")
    sys.stdout.flush()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mix", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--socket", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rehearse", action="store_true",
                   help="the mix's small CPU-rehearsal sizes")
    args = p.parse_args(argv)
    with open(args.mix) as f:
        mix = json.load(f)
    if args.rehearse:
        mix = traffic.rehearsal(mix)
    streams = traffic.streams(mix, args.seed)
    starts = dict(zip([s.name for s in streams],
                      traffic.phases(mix, args.seed)))
    frames = {s.name: traffic.render(s) for s in streams}
    say({"event": "rendered"})

    for line in sys.stdin:
        cmd = line.split()
        if cmd[0] == "warm":
            errors = []

            def warm_one(s):
                try:
                    warm(args.socket, frames[s.name], f"warm-{s.name}",
                         int(mix["warmup_frames"]), starts[s.name])
                except (OSError, ValueError, RuntimeError) as e:
                    errors.append(f"{s.name}: {type(e).__name__}: {e}")

            ts = [threading.Thread(target=warm_one, args=(s,))
                  for s in streams]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            if errors:
                say({"event": "error", "error": "; ".join(errors)})
                return 1
            say({"event": "warmed"})
        elif cmd[0] == "connect":
            conns = {}
            for i in traffic.stream_order(mix, args.seed):
                conns[streams[i].name] = connect(args.socket, streams[i].name)
            say({"event": "ready"})
        elif cmd[0] == "go":
            t_end = float(cmd[1]) + args.seconds
            outs = {s.name: {k: [] for k in ("frame", "send", "recv", "ok",
                                             "server_ms", "tracks")}
                    for s in streams}
            ts = [threading.Thread(target=client, args=(
                conns[s.name], frames[s.name], starts[s.name], t_end,
                outs[s.name]))
                for s in streams]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            say({"event": "done", "streams": outs})
            return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
