"""The port's span and counter recorder (busca_tpu_torch/utils/profiling.py)
on the CPU:

- off: nothing is recorded, ``span`` is the one shared no-op, ``begin``
  and ``spanned_steps`` hand back inert objects;
- on: parent ids nest, each thread keeps its own list, a span begun on one
  thread ends on another, counters sum over threads, a deferred update's
  resumptions are children of its first step under one request id;
- the clock: under ``torch.profiler`` a span mapped through a
  ``bench:clock``-style anchor (benchmark/bmk/tracing.py::Profiler)
  contains the aten op run inside it, on the profiling thread and on a
  second thread that waits for it;
- ``trace(logdir)`` writes the spans into its ``trace.json``;
- the instrumented layers give bit-equal results with the recorder on:
  ``AssociationEngine.associate_many``, a ``LockstepTrackingServer`` run
  (whose spans link a frame's queue wait, tick and tracker steps by
  request id), and ``export_associate_scorer``'s graph.
"""

import json
import socket
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from busca_tpu_torch.utils import profiling

CROP_HW = (32, 16)
SEQ_LEN, NUM_CAN = 3, 2


@pytest.fixture(autouse=True)
def recorder_off():
    profiling.disable_tracing()
    profiling.drain()
    yield
    profiling.disable_tracing()
    profiling.drain()


def _names(rec):
    return [s.name for s in rec.spans]


# ------------------------------------------------------------- on and off --

def test_off_records_nothing_and_hands_back_one_noop():
    assert not profiling.tracing()
    assert profiling.span("a") is profiling.request((1,)) \
        is profiling.span("b", device=torch.zeros(1))
    with profiling.span("a") as sp:
        profiling.count("n", 3)
        assert sp is None
    w = profiling.begin("q")
    w.end(rid=(1,))
    assert w.id is None

    def gen():
        yield 1

    g = gen()
    assert profiling.spanned_steps(g, "s") is g
    rec = profiling.drain()
    assert rec.spans == [] and rec.counts == {}


def test_spans_nest_per_thread_and_counters_sum():
    profiling.enable_tracing()
    ready = threading.Barrier(2)

    def work(tag):
        ready.wait(timeout=10)
        with profiling.request((tag,)):
            with profiling.span("outer"):
                with profiling.span("inner", attrs={"tag": tag}):
                    profiling.count("n", 2)
                profiling.count("n")

    threads = [threading.Thread(target=work, args=(t,)) for t in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    rec = profiling.drain()
    assert rec.counts == {"n": 6}
    assert sorted(_names(rec)) == ["inner", "inner", "outer", "outer"]
    outer = {s.rid: s for s in rec.spans if s.name == "outer"}
    for s in rec.spans:
        if s.name == "inner":
            parent = outer[s.rid]
            assert s.parent == parent.id and parent.parent is None
            assert s.thread == parent.thread
            assert s.attrs == {"tag": s.rid[0]}
            assert parent.t0 <= s.t0 <= s.t1 <= parent.t1
    assert outer[(1,)].thread != outer[(2,)].thread
    assert profiling.drain().spans == []  # drained


def test_a_span_begun_on_one_thread_ends_on_another():
    profiling.enable_tracing()
    wait = profiling.begin("serve.queue_wait")
    t = threading.Thread(target=wait.end, kwargs={"rid": (7, 1, 3)})
    t.start()
    t.join(timeout=10)
    (sp,) = profiling.drain().spans
    assert sp.name == "serve.queue_wait" and sp.rid == (7, 1, 3)
    assert sp.thread == threading.get_native_id() and sp.t1 >= sp.t0


def test_spanned_steps_links_resumptions_to_the_first_step():
    profiling.enable_tracing()

    def gen():
        got = yield "req"
        return got * 2

    with profiling.request((4, 1, 9)):
        g = profiling.spanned_steps(gen(), "tracker.update")
    assert next(g) == "req"
    with pytest.raises(StopIteration) as stop:
        g.send(21)
    assert stop.value.value == 42
    first, resumed = profiling.drain().spans
    assert first.attrs is None and resumed.attrs == {"resumed": True}
    assert resumed.parent == first.id
    assert first.rid == resumed.rid == (4, 1, 9)


def test_a_profiler_session_turns_the_recorder_on():
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        with profiling.span("during"):
            pass
    finally:
        prof.stop()
    with profiling.span("after"):
        pass
    assert _names(profiling.drain()) == ["during"]


# -------------------------------------------------------------- the clock --

def _profiled(fn):
    """``fn()`` under the benchmark's profiler recipe: a ``bench:clock``
    range ties ``perf_counter`` to the profiler's clock.  Returns the
    kineto events and the offset (profiler ns = host ns + offset)."""
    with torch.profiler.record_function("warm"):
        pass
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    with torch.profiler.record_function("bench:clock"):
        t_clock = time.perf_counter()
    fn()
    prof.stop()
    events = prof.profiler.kineto_results.events()
    clock = next(e for e in events if e.name() == "bench:clock")
    return events, clock.start_ns() - int(t_clock * 1e9)


def _contains(sp, ev, offset):
    return (sp.t0 + offset <= ev.start_ns()
            and ev.start_ns() + ev.duration_ns() <= sp.t1 + offset)


def test_spans_share_the_profiler_clock_on_every_thread():
    x = torch.randn(256, 256)
    go, done = threading.Event(), threading.Event()

    def second():
        # a span on another thread, open while this thread's op runs
        with profiling.span("second"):
            go.set()
            done.wait(timeout=10)
            time.sleep(0.005)

    def run():
        with profiling.span("first"):
            time.sleep(0.005)
            torch.mm(x, x)
            time.sleep(0.005)
        t = threading.Thread(target=second)
        t.start()
        go.wait(timeout=10)
        time.sleep(0.005)
        torch.addmm(x, x, x)
        done.set()
        t.join(timeout=10)

    events, offset = _profiled(run)
    spans = {s.name: s for s in profiling.drain().spans}
    mm = next(e for e in events if e.name() == "aten::mm")
    addmm = next(e for e in events if e.name() == "aten::addmm")
    assert spans["first"].thread != spans["second"].thread
    assert _contains(spans["first"], mm, offset)
    assert _contains(spans["second"], addmm, offset)
    assert not _contains(spans["first"], addmm, offset)


def test_trace_writes_the_spans_into_its_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("assoc.call"):
            with profiling.span("assoc.prep"):
                torch.relu(torch.randn(256, 256)).sum()
            profiling.count("assoc.tracks", 5)
    assert not profiling.tracing()
    with open(tmp_path / "trace.json") as f:
        doc = json.load(f)
    ours = {e["name"]: e for e in doc["traceEvents"]
            if e.get("cat") == "busca"}
    assert set(ours) == {"assoc.call", "assoc.prep"}
    assert ours["assoc.prep"]["args"]["parent"] == \
        ours["assoc.call"]["args"]["id"]
    relu = next(e for e in doc["traceEvents"]
                if e.get("name") == "aten::relu")
    call = ours["assoc.call"]
    assert call["ts"] <= float(relu["ts"]) <= call["ts"] + call["dur"]
    assert doc["buscaCounters"] == {"assoc.tracks": 5}


# ------------------------------------------ the layers, recorder on vs off --

def _engine():
    from busca_tpu_torch.assoc.engine import AssociationEngine
    from busca_tpu_torch.models.busca import BuscaConfig, BuscaModel

    cfg = BuscaConfig(num_layer=1, reid_num_classes=5,
                      reid_layers=(1, 1, 1, 1))
    model = BuscaModel(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    return AssociationEngine(cfg, model.eval(), seq_len=SEQ_LEN,
                             num_candidates=NUM_CAN, crop_hw=CROP_HW)


def _requests():
    from busca_tpu_torch.trackers.base import Track

    rng = np.random.RandomState(5)

    def crop():
        return rng.randint(0, 255, CROP_HW + (3,), dtype=np.uint8)

    def track(x, n_mem):
        t = Track(np.array([x, 60, 30, 60], np.float64), 0.9, image=crop())
        for i in range(n_mem - 1):
            t.images_mem.append(crop())
            t.tlwh_mem.append(np.array([x + 2 * i, 60, 30, 60], np.float64))
        t.activate(1)
        return t

    out = []
    for r in range(3):
        tracks = [track(40 + 30 * i + r, SEQ_LEN + i) for i in range(2)]
        dets = [Track(np.array([50 + 20 * j, 60, 30, 60], np.float64), 0.8,
                      image=crop()) for j in range(2)]
        kal = [Track(t.tlwh, 0.1, crop(), 1.0) for t in tracks]
        out.append((tracks, dets, None, kal))
    return out


def test_associate_many_is_bit_equal_with_the_recorder_on():
    eng = _engine()
    reqs = _requests()
    off = eng.associate_many(reqs, select_highest_candidate=False)
    profiling.enable_tracing()
    on = eng.associate_many(reqs, select_highest_candidate=False)
    rec = profiling.drain()
    for (p0, r0), (p1, r1) in zip(off, on):
        np.testing.assert_array_equal(p0, p1)
        np.testing.assert_array_equal(r0, r1)
    names = _names(rec)
    for name in ("assoc.call", "assoc.prep", "assoc.encode", "assoc.decide",
                 "assoc.readback", "assoc.post"):
        assert name in names, names
    (call,) = [s for s in rec.spans if s.name == "assoc.call"]
    kids = {s.name for s in rec.spans if s.parent == call.id}
    assert {"assoc.prep", "assoc.readback", "assoc.post"} <= kids
    # one grouped call: 6 tracks in an 8-row bucket, 3 memory crops a row,
    # and 15 unique candidate units (each request's zero crop, nearest
    # detections and Kalman candidates) padded to 16
    assert rec.counts["assoc.tracks"] == 6
    assert rec.counts["assoc.rows"] == 8
    assert rec.counts["assoc.crops"] == 8 * SEQ_LEN + 16
    assert all(s.device_ms is None for s in rec.spans)  # the CPU: no events


class _StubDetector:
    """Detections keyed by the frame's [0, 0] pixel (stream, t)."""

    def __init__(self, dets):
        self.dets = dets

    def detect_batch(self, frames):
        outs = []
        for f in np.asarray(frames):
            boxes, scores = self.dets[int(f[0, 0, 0])][int(f[0, 0, 1])]
            outs.append(types.SimpleNamespace(
                boxes_tlbr=boxes, scores=scores, scale=1.0, image=f))
        return outs


def _serve(eng, dets, frames):
    """Every stream through a lockstep server over socket pairs; each
    stream's replies."""
    from busca_tpu_torch.serve.lockstep import LockstepTrackingServer
    from busca_tpu_torch.serve.server import TrackingClient
    from busca_tpu_torch.trackers.base import Track
    from busca_tpu_torch.trackers.byte import ByteTracker, ByteTrackerConfig

    Track.reset_id_counter()

    def factory():
        return ByteTracker(ByteTrackerConfig(
            use_busca=True, crop_hw=CROP_HW,
            use_camera_motion_compensation=False), assoc_engine=eng)

    server = LockstepTrackingServer(_StubDetector(dets), factory,
                                    tick_timeout=0.5)
    server.start_scheduler()
    pairs = [socket.socketpair() for _ in frames]
    threads = [threading.Thread(target=server.serve_connection, args=(a,),
                                daemon=True) for a, _ in pairs]
    for t in threads:
        t.start()
    gate = threading.Barrier(len(frames))

    def run(si):
        client = TrackingClient(pairs[si][1])
        assert client.start(f"s{si}")["ok"]
        out = []
        for f in frames[si]:
            gate.wait(timeout=60)
            r = client.frame(f)
            assert r["ok"], r
            out.append([(t["id"], t["tlwh"], t["score"])
                        for t in r["tracks"]])
        client.stop()
        return out

    with ThreadPoolExecutor(len(frames)) as pool:
        got = list(pool.map(run, range(len(frames))))
    for t in threads:
        t.join(timeout=10)
    server.close()
    return got


def test_lockstep_server_is_bit_equal_with_the_recorder_on():
    from busca_tpu_torch.eval.synthetic import (
        SyntheticObject,
        SyntheticSequence,
    )

    n_frames = 8
    dets, frames = [], []
    for si in range(2):
        # two objects, the first missed by the detector on frames 3-5: its
        # track goes to the third round
        seq = SyntheticSequence([
            SyntheticObject(color=np.array([40, 200, 60], np.float64),
                            x0=30, y0=60, vx=3.0, vy=0.5, w=36, h=72,
                            dropout=(3, 6)),
            SyntheticObject(color=np.array([210, 60, 180], np.float64),
                            x0=280, y0=150, vx=-2.0, vy=-0.8, w=40, h=80),
        ], num_frames=n_frames, seed=si)
        dets.append([seq.detections(t) for t in range(n_frames)])
        fs = []
        for t in range(n_frames):
            f = seq.frame(t).copy()
            f[0, 0] = (si, t, 0)
            fs.append(f)
        frames.append(fs)
    eng = _engine()
    off = _serve(eng, dets, frames)
    profiling.enable_tracing()
    on = _serve(eng, dets, frames)
    rec = profiling.drain()
    assert on == off
    names = set(_names(rec))
    assert {"serve.queue_wait", "serve.tick", "tracker.update",
            "tracker.crops", "tracker.match", "assoc.call"} <= names, names
    waits = [s for s in rec.spans if s.name == "serve.queue_wait"]
    firsts = [s for s in rec.spans if s.name == "tracker.update"
              and not s.attrs]
    assert len(waits) == len(firsts) == 2 * n_frames
    # a frame's wait (connection thread) and its update (scheduler) carry
    # one request id: (tick, sid, frame_id)
    assert {s.rid for s in waits} == {s.rid for s in firsts}
    ticks = {s.rid[0]: s for s in rec.spans if s.name == "serve.tick"}
    for s in firsts:
        assert s.rid[0] in ticks and s.thread == ticks[s.rid[0]].thread
    assert all(w.thread != ticks[w.rid[0]].thread for w in waits)
    assert sum(t.attrs["frames"] for t in ticks.values()) == 2 * n_frames
    resumed = [s for s in rec.spans if s.name == "tracker.update"
               and s.attrs == {"resumed": True}]
    by_id = {s.id: s for s in firsts}
    assert resumed and all(by_id[s.parent].rid == s.rid for s in resumed)
    assert rec.counts["assoc.tracks"] <= rec.counts["assoc.rows"]


def test_extractor_and_export_with_the_recorder_on(tmp_path, monkeypatch):
    from busca_tpu_torch.eval.features import ReidFeatureExtractor
    from busca_tpu_torch.serve import export

    ext = ReidFeatureExtractor(layers=(1, 1, 1, 1), num_classes=5,
                               crop_hw=CROP_HW, device="cpu")
    crops = np.random.RandomState(1).randint(
        0, 255, (3,) + CROP_HW + (3,)).astype(np.uint8)
    want = ext(crops)
    eng = _engine()
    programs = []
    save = export._save
    monkeypatch.setattr(export, "_save", lambda program, path: (
        programs.append(program), save(program, path))[1])
    export.export_associate_scorer(eng, 4, 8, str(tmp_path / "off"))
    profiling.enable_tracing()
    np.testing.assert_array_equal(ext(crops), want)
    export.export_associate_scorer(eng, 4, 8, str(tmp_path / "on"))
    rec = profiling.drain()
    # the extractor's call is recorded; the spans inside
    # BuscaModel.forward are not, and the graph is the same
    assert _names(rec) == ["reid.extract"]
    off, on = ([str(n.target) for n in p.graph.nodes
                if n.op == "call_function"] for p in programs)
    assert on == off and "aten.softmax.int" in on
