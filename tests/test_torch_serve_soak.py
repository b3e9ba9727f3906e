"""The serving soak through the port's server (tests/test_serve_soak.py on
busca_tpu_torch): a long stream with ``mem_cap`` on, a mid-stream snapshot
and restore, and the unbounded comparison arm, over one deterministic
synthetic stream (bouncing objects and periodic detector dropouts,
``eval/memcap_delta.py::_long_stream_sequence``):

  A. capped (mem_cap=64), interrupted at the cut by a wire snapshot and
     restored onto a fresh server;
  B. capped, unbroken: arm A must match it reply for reply;
  C. unbounded (the reference's semantics): arm B's metrics must stay
     within the mem-cap deviation bound, and C's memory must outgrow the
     cap (the contrast that shows the cap engaged).

Host RSS stays bounded on the capped arm: its growth from a fifth of the
stream to its end is held under busca_tpu's 50 MB per 4000 frames, scaled
to the frames (busca_tpu's test compares gigabytes against that bound, so
it cannot fail; here it is bytes).  Arm B runs in a spawned process of its
own, so the reading is the arm's alone: in a test worker shared with other
modules, what they left running or freeing moves the worker's RSS (52.7
MB over the 960 frames once, against the 12 MB bound).  That process
pins glibc's mmap threshold at its default (``_pin_mmap_threshold``), a
setting a deployed server does not run with: a server keeps glibc's
dynamic threshold, so its RSS can swing by tens of MB with the heap's
high-water mark and no leak, and the bound here reads what the arm keeps,
not RSS as a deployment sees it.  A kept leak still shows, pinned or not:
buffers that stay mapped stay in RSS.  The BUSCA engine
is the deterministic stub: the soak targets the serving, tracker and
memory stack.

At busca_tpu's size, 5000 frames, the soak is ``slow`` as busca_tpu's is;
Tier-1 runs the same three arms at 1200 frames (cut 600, cap 64).  Also:
the port's long stream equals busca_tpu's for one seed, detections and
frames exactly.
"""

import ctypes
import multiprocessing as mp
import socket
import threading

import numpy as np
import pytest
import torch

from busca_tpu_torch.eval.memcap_delta import _long_stream_sequence
from busca_tpu_torch.eval.metrics import evaluate_clear
from busca_tpu_torch.serve.server import TrackingClient, TrackingServer
from busca_tpu_torch.trackers.base import Track
from busca_tpu_torch.trackers.byte import ByteTracker, ByteTrackerConfig
from busca_tpu_torch.utils.memory import get_ram_usage
from test_torch_strongsort import StubEngine, one_torch_thread  # noqa: F401

MEM_CAP = 64
SEQ_SEED = 4
DROP = dict(drop_period=250, drop_len=8)
# busca_tpu's bound on the capped arm's RSS growth, per frames measured
RSS_MB_PER_FRAME = 50.0 / 4000


class _ScriptedDetector:
    """Sequential stub detector: detections precomputed for the whole
    stream, consumed in order; ``start`` positions a restored server at
    the cut."""

    def __init__(self, dets, start=0):
        self.dets = dets
        self.i = start

    def detect(self, frame_bgr):
        from busca_tpu_torch.eval.detector import DetectorOutput

        boxes, scores = self.dets[self.i]
        self.i += 1
        return DetectorOutput(boxes_tlbr=boxes, scores=scores,
                              image=np.asarray(frame_bgr), scale=1.0)


def _frames(n):
    """A fresh frame iterator: a new sequence object replayed from t=0 is
    deterministic (``frame`` draws from the sequence's own rng)."""
    seq = _long_stream_sequence(SEQ_SEED, n, **DROP)
    for t in range(n):
        yield seq.frame(t)


def _serve(detector, factory, made):
    def tracking_factory():
        made.append(factory())
        return made[-1]

    server = TrackingServer(detector, tracking_factory, min_box_area=0.0,
                            vertical_thresh=None)
    srv_sock, cli_sock = socket.socketpair()
    threading.Thread(target=server.serve_connection, args=(srv_sock,),
                     daemon=True).start()
    return TrackingClient(cli_sock)


def _factory(engine, mem_cap):
    def make():
        return ByteTracker(
            ByteTrackerConfig(track_thresh=0.5, use_busca=True,
                              busca_thresh=0.5, crop_hw=(64, 32),
                              use_camera_motion_compensation=False,
                              mem_cap=mem_cap),
            engine)
    return make


def _reply_key(reply):
    return (reply["frame_id"],
            tuple(sorted((t["id"], tuple(round(v, 6) for v in t["tlwh"]))
                         for t in reply["tracks"])))


def _pred_of(replies):
    pred = {}
    for r in replies:
        if r["tracks"]:
            pred[r["frame_id"]] = (
                np.array([t["tlwh"] for t in r["tracks"]]),
                np.array([t["id"] for t in r["tracks"]], int),
                np.array([t["score"] for t in r["tracks"]]),
            )
    return pred


def _pin_mmap_threshold():
    """Pin glibc's mmap threshold at its default, 128 KiB.  glibc raises
    the threshold to the size of each mapped buffer it frees; after that,
    frame-sized buffers (the rendered frames, the received payloads: ~0.3
    MB each) come from the heap, and the heap's high-water mark moves RSS
    by tens of MB with the order of the frees, leak or not (24 MB over the
    960 frames once, in a process of its own).  Pinned, such buffers are
    mapped and unmapped every time, so RSS growth is what the arm keeps.
    No-op without glibc."""
    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:
        return
    libc.mallopt(-3, 128 * 1024)  # M_MMAP_THRESHOLD


def _capped_arm(n_frames, rss_from):
    """Arm B (capped, unbroken), run in a spawned process: the replies, the
    RSS growth in MB from frame ``rss_from`` to the end, the surviving
    tracks' memory sizes and their most admissions."""
    torch.set_num_threads(1)
    _pin_mmap_threshold()
    seq = _long_stream_sequence(SEQ_SEED, n_frames, **DROP)
    dets = [seq.detections(t) for t in range(n_frames)]
    Track.reset_id_counter()
    made = []
    client = _serve(_ScriptedDetector(dets), _factory(StubEngine(), MEM_CAP),
                    made)
    assert client.start("soak")["ok"]
    replies = []
    rss_start = None
    for t, frame in enumerate(_frames(n_frames)):
        replies.append(client.frame(frame))
        if t == rss_from - 1:
            rss_start = get_ram_usage("MB")
    growth_mb = get_ram_usage("MB") - rss_start
    client.stop()
    pool = made[-1].tracked + made[-1].lost
    return (replies, growth_mb, [len(tr.images_mem) for tr in pool],
            max((tr._mem_clock for tr in pool), default=0))


@pytest.mark.parametrize("n_frames,cut", [
    pytest.param(5000, 2500, marks=pytest.mark.slow),
    (1200, 600),
])
def test_serving_soak_memcap_snapshot_restore(n_frames, cut,
                                              one_torch_thread):  # noqa
    seq = _long_stream_sequence(SEQ_SEED, n_frames, **DROP)
    dets = [seq.detections(t) for t in range(n_frames)]
    gt = _long_stream_sequence(SEQ_SEED, n_frames).ground_truth()
    rss_from = n_frames // 5

    # ---- arm B: capped, unbroken, in a process of its own ------------
    with mp.get_context("spawn").Pool(1) as workers:
        replies_b, growth_mb, mem_sizes, max_adm = workers.apply(
            _capped_arm, (n_frames, rss_from))
    bound = RSS_MB_PER_FRAME * (n_frames - rss_from)
    assert growth_mb < bound, (f"capped-arm RSS grew {growth_mb:.1f} MB "
                               f"over {n_frames - rss_from} frames")

    # every surviving track's memory is within the cap and spans its life
    assert mem_sizes, "the soak stream ended with no live tracks"
    assert max(mem_sizes) <= MEM_CAP
    assert max_adm > 4 * MEM_CAP, (
        f"stream too short to engage compaction: {max_adm} admissions")

    # ---- arm A: capped, snapshot at the cut, restored on a fresh server
    Track.reset_id_counter()
    engine_a = StubEngine()
    client_a = _serve(_ScriptedDetector(dets), _factory(engine_a, MEM_CAP),
                      [])
    assert client_a.start("soak")["ok"]
    frames_iter = _frames(n_frames)
    replies_a = [client_a.frame(next(frames_iter)) for _ in range(cut)]
    header, blob = client_a.snapshot()
    assert header["frame_id"] == cut
    client_a.stop()

    Track.reset_id_counter()  # a fresh process
    client_a2 = _serve(_ScriptedDetector(dets, start=cut),
                       _factory(engine_a, MEM_CAP), [])
    reply = client_a2.restore(blob)
    assert reply["ok"] and reply["frame_id"] == cut, reply
    replies_a += [client_a2.frame(f) for f in frames_iter]
    client_a2.stop()
    assert [_reply_key(r) for r in replies_a] == \
        [_reply_key(r) for r in replies_b], \
        "the restored soak stream diverged from the unbroken capped run"

    # ---- arm C: unbounded, the reference's semantics -------------------
    Track.reset_id_counter()
    made_c = []
    client_c = _serve(_ScriptedDetector(dets), _factory(StubEngine(), None),
                      made_c)
    assert client_c.start("soak")["ok"]
    replies_c = [client_c.frame(f) for f in _frames(n_frames)]
    client_c.stop()
    pool_c = made_c[-1].tracked + made_c[-1].lost
    assert max(len(tr.images_mem) for tr in pool_c) > 4 * MEM_CAP, (
        "the unbounded arm never outgrew the cap: the contrast is vacuous")

    m_cap = evaluate_clear(gt, _pred_of(replies_b))
    m_unb = evaluate_clear(gt, _pred_of(replies_c))
    # within the measured mem-cap bound (PARITY.md: zero delta at cap >=
    # ~5x seq_len; the soak allows a small long-stream slack)
    assert abs(m_cap.mota - m_unb.mota) <= 0.01, (m_cap.mota, m_unb.mota)
    assert abs(m_cap.idf1 - m_unb.idf1) <= 0.02, (m_cap.idf1, m_unb.idf1)
    assert m_cap.num_gt == n_frames * 3


def test_long_stream_matches_busca_tpu():
    """The same seed gives busca_tpu's detections and frames exactly."""
    from busca_tpu.eval.memcap_delta import _long_stream_sequence as jlong

    n = 300
    mine, theirs = (f(SEQ_SEED, n, **DROP) for f in (_long_stream_sequence,
                                                     jlong))
    for t in range(n):
        for a, b in zip(mine.detections(t), theirs.detections(t)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(mine.frame(t), theirs.frame(t))
    gt_m, gt_t = mine.ground_truth(), theirs.ground_truth()
    assert gt_m.keys() == gt_t.keys()
    for k in gt_m:
        np.testing.assert_array_equal(gt_m[k][0], gt_t[k][0])
    # the objects drop out periodically, after their warm-up
    assert any(len(mine.detections(t)[1]) < 3 for t in range(n))
