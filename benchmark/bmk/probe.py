"""What the benchmark records around the program's callables.

Two kinds of wrappers, both installed by the benchmark on the program's
objects (the program itself carries no instrumentation); a detector's and
an extractor's are their parts' (``bmk/parts``), which record here:

- capture, in every run: what the correctness check needs (each stream's
  tracker inputs, every third-round result, and a sample drawn from the
  seed of detector calls, crop calls, third rounds and feature calls, with
  their inputs: a third round's requests as the tracks and detections
  stood at the call, and its probabilities before the post-processing);
- spans, only with ``--trace 1``: a host-clock span and a
  ``torch.profiler.record_function`` range named ``bench:<layer>`` around
  each call into a layer, plus the shapes of each model forward and each
  K1 launch, for the per-layer metrics.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np

from bmk.traffic import seed_rng


def frozen(out):
    """A copy of a result as it was returned (the caller may change its
    arrays in place afterwards)."""
    if isinstance(out, tuple):
        return tuple(frozen(o) for o in out)
    return None if out is None else np.array(out, copy=True)


def assoc_key(tracks, dets) -> bytes:
    """A third-round request's identity: its tracks' and considered
    detections' current boxes, bit for bit."""
    a = np.stack([np.asarray(t.tlbr, np.float64) for t in tracks]).tobytes()
    b = (np.stack([np.asarray(d.tlbr, np.float64) for d in dets]).tobytes()
         if len(dets) else b"")
    return a + b"|" + b


class Recorder:
    """Everything one run records (see the module docstring)."""

    def __init__(self, seed: int, sample: Dict[str, List[int]], trace: bool):
        self.trace = trace
        rng = seed_rng(seed, 9)
        # kind -> the window call indices kept with their inputs
        self.picks = {k: set(int(i) for i in rng.choice(h, n, replace=False))
                      for k, (n, h) in sorted(sample.items())}
        self.calls = defaultdict(int)
        self.active = False
        self.phase = "warm"
        self.k1_launches = 0
        self.update_times = []  # (t0, t1) of each timed in-process update
        self.lock = threading.Lock()
        self.spans = []       # (name, t0, t1, thread, frames)
        self.forwards = []    # (role or "busca" or "tracks", t, shape...)
        self.k1 = []          # (t, frame_hw, boxes tensor, out elements)
        self.tracker_inputs = defaultdict(list)   # stream -> [(boxes, ...)]
        # assoc_key -> [(probs, reliable), ...] in call order (public
        # detections repeat on a forward-and-back stream, and so can keys)
        self.assoc = defaultdict(list)
        self.det_calls = []   # the detector part's sampled calls
        self.crop_calls = []  # (frame, boxes, crop_hw, crops)
        # sampled third rounds: (requests, kwargs, results, raw probs)
        self.assoc_calls = []
        self.largest_assoc = None  # the window's largest, as assoc_calls
        self.largest_tracks = 0
        self.feat_calls = []  # the extractor part's sampled frames
        self.extractor_outputs = []

    def pick(self, kind: str) -> bool:
        """Whether this window call of ``kind`` is kept for the check."""
        if not self.active:
            return False
        with self.lock:
            i = self.calls[kind]
            self.calls[kind] += 1
        return i in self.picks.get(kind, ())

    def keep_assoc(self, n_tracks: int) -> str:
        """Whether a window's third round of ``n_tracks`` tracks is kept for
        the check: "sample" (drawn from the seed), "largest" (the largest
        so far) or ""."""
        if self.pick("assoc"):
            return "sample"
        if self.active and n_tracks > self.largest_tracks:
            return "largest"
        return ""

    def add_assoc(self, how: str, call: tuple, n_tracks: int):
        if how == "sample":
            self.assoc_calls.append(call)
        elif n_tracks > self.largest_tracks:
            self.largest_assoc, self.largest_tracks = call, n_tracks

    @contextlib.contextmanager
    def span(self, name: str, frames: int = 0):
        if not self.trace:
            yield
            return
        import torch

        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench:{name}"):
            try:
                yield
            finally:
                t1 = time.perf_counter()
                self.spans.append((name, t0, t1, threading.get_ident(),
                                   frames))

    def forward(self, kind: str, *shape):
        if self.trace:
            self.forwards.append((kind, time.perf_counter()) + shape)


class RecordingTracker:
    """A stream's tracker as the benchmark sees it: its inputs recorded, its
    update (or each resumption of its deferred update) spanned."""

    def __init__(self, inner, rec: Recorder, stream: str):
        self._inner = inner
        self._rec = rec
        self._stream = stream

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _record(self, boxes, scores, scale, frame):
        self._rec.tracker_inputs[self._stream].append(
            (np.array(boxes, np.float64), np.array(scores, np.float64),
             float(scale), tuple(frame.shape) if frame is not None else None))

    def update(self, boxes, scores, scale, frame):
        self._record(boxes, scores, scale, frame)
        t0 = time.perf_counter()
        with self._rec.span("tracker", frames=1):
            out = self._inner.update(boxes, scores, scale, frame)
        self._rec.update_times.append((t0, time.perf_counter()))
        return out

    def update_deferred(self, boxes, scores, scale, frame):
        self._record(boxes, scores, scale, frame)
        return self._timed(self._inner.update_deferred(boxes, scores, scale,
                                                       frame))

    def _timed(self, gen):
        rec = self._rec
        try:
            with rec.span("tracker", frames=1):
                req = next(gen)
            while True:
                res = yield req
                with rec.span("tracker"):
                    req = gen.send(res)
        except StopIteration as e:
            return e.value


class Held:
    """What the third round reads of a track, a detection or a Kalman
    candidate, as it stood at the call (the tracker moves them on after;
    the crops and boxes in its lists are never written again)."""

    def __init__(self, obj):
        self.images_mem = list(obj.images_mem)
        self.tlwh_mem = list(obj.tlwh_mem)
        self.scale = obj.scale
        self.tlbr = np.array(obj.tlbr, copy=True)
        self.tlwh = np.array(obj.tlwh, copy=True)


def held_request(tracks, dets, kalman) -> tuple:
    return ([Held(t) for t in tracks], [Held(d) for d in dets],
            [Held(k) for k in kalman])


def wrap_engine(engine, rec: Recorder):
    """Span the third round's calls, keep every request's result by its
    identity, and keep the sampled calls (and the largest) with their
    requests, results and probabilities before the post-processing."""
    one, many = engine.associate, engine.associate_many
    probs, post = engine._probs, engine._postprocess
    raw = threading.local()

    def associate(tracks, dets, dists_matrix=None, **kw):
        how = rec.keep_assoc(len(tracks))
        if how:
            held = [held_request(tracks, dets,
                                 kw.get("extra_kalman_candidates", ()))]
        raw.probs = []
        with rec.span("assoc"):
            out = one(tracks, dets, dists_matrix, **kw)
        if rec.active and len(tracks):
            rec.assoc[assoc_key(tracks, dets)].append(frozen(out))
        if how:
            opts = {k: v for k, v in kw.items()
                    if k != "extra_kalman_candidates"}
            rec.add_assoc(how, ("one", held, opts, [frozen(out)],
                                raw.probs), len(tracks))
        raw.probs = None
        rec.forward("tracks", len(tracks))
        return out

    def associate_many(requests, **kw):
        n = sum(len(r[0]) for r in requests)
        how = rec.keep_assoc(n)
        if how:
            held = [held_request(t, d, k) for t, d, _x, k in requests]
        raw.probs = []
        with rec.span("assoc"):
            outs = many(requests, **kw)
        for (tracks, dets, _d, _k), out in zip(requests, outs):
            if rec.active and len(tracks):
                rec.assoc[assoc_key(tracks, dets)].append(frozen(out))
            rec.forward("tracks", len(tracks))
        if how:
            rec.add_assoc(how, ("many", held, dict(kw),
                                [frozen(o) for o in outs], raw.probs), n)
        raw.probs = None
        return outs

    def postprocess(p, *a, **kw):
        if getattr(raw, "probs", None) is not None:
            raw.probs.append(np.array(p, copy=True))
        return post(p, *a, **kw)

    def model_probs(*args, **kw):
        out = probs(*args, **kw)
        mem, can = args[0], args[1]
        rec.forward("busca", int(mem.shape[0]), int(mem.shape[1]),
                    int(can.shape[0]) if can.dim() == 4 else
                    int(can.shape[0] * can.shape[1]))
        return out

    engine.associate, engine.associate_many = associate, associate_many
    engine._postprocess = postprocess
    if rec.trace:
        engine._probs = model_probs
    return engine


def wrap_crops(rec: Recorder):
    """Keep the sampled crop calls of the trackers (K1 on the card) and, in
    a traced run, every K1 launch's shapes.  Returns an undo function."""
    from busca_tpu_torch.ops import crop_cuda
    from busca_tpu_torch.trackers import base

    orig_crops, orig_k1 = base.device_crops, crop_cuda.crop_resize_cuda

    def device_crops(frame, boxes_tlbr, crop_hw, device="cuda"):
        out = orig_crops(frame, boxes_tlbr, crop_hw, device)
        if rec.pick("crops"):
            # the frame and the crops as they were: copies, in case their
            # buffers are written again after the crop
            rec.crop_calls.append((frame.clone() if hasattr(frame, "clone")
                                   else np.array(frame),
                                   np.array(boxes_tlbr, np.float32),
                                   tuple(crop_hw), out.clone()))
        return out

    def crop_resize_cuda(frame, boxes, out_hw, **kw):
        if len(boxes):  # a call without boxes launches nothing
            rec.k1.append((time.perf_counter(), tuple(frame.shape[:2]),
                           boxes, int(boxes.shape[0]) * int(out_hw[0])
                           * int(out_hw[1]) * 3))
        return orig_k1(frame, boxes, out_hw, **kw)

    crop_resize_cuda.launches = 0
    base.device_crops = device_crops
    if rec.trace:
        crop_cuda.crop_resize_cuda = crop_resize_cuda

    def undo():
        base.device_crops = orig_crops
        crop_cuda.crop_resize_cuda = orig_k1

    return undo


def k1_launch_count() -> int:
    """The program's own counter of K1 launches
    (``crop_resize_cuda.launches``; ``launch`` counts on whichever function
    the module holds under that name, so on the wrapper in a traced run)."""
    from busca_tpu_torch.ops import crop_cuda

    return int(getattr(crop_cuda.crop_resize_cuda, "launches", 0))
