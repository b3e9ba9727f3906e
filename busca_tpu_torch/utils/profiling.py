"""Tracing and profiling hooks (port of ``busca_tpu.utils.profiling``).

The reference has only wall-clock splits of forward and track time
(mot_evaluator.py:115-117, 177-189; CenterTrack's per-stage timing dict,
detector.py:160-182).  Here:

- :class:`StageTimer`: per-stage wall time, optionally synchronizing the
  card around each stage, for the per-frame breakdown (detect / crop /
  associate / assign / bookkeeping);
- the span and counter recorder: :func:`span`, :func:`begin`,
  :func:`count`, :func:`request` and :func:`spanned_steps` mark the work
  inside the program's layers (the names are listed in README.md); it
  records while a ``torch.profiler`` session records in this process (so
  a profiled run needs no call of its own), or after
  :func:`enable_tracing` without one, and :func:`drain` collects what it
  recorded.  Off, a span is one shared no-op and a count returns at once;
- :func:`trace`: ``torch.profiler`` around a block, written as a Chrome
  trace with the recorder's spans of the block on the profiler's clock
  (busca_tpu's is a JAX profiler trace for TensorBoard);
- :func:`log_compile_times`: the port compiles its two kernels with nvcc
  at first use and traces programs with ``torch.export``; this logs each
  with its seconds (busca_tpu logs XLA's compilations).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


class StageTimer:
    """Accumulates per-stage wall time.

    Example::

        timer = StageTimer(sync=True)
        with timer("reid"):
            feats = model(...)
        print(timer.report())

    ``sync=True`` waits for the current CUDA stream before and after each
    stage, so a stage is charged its device work (on the CPU every op is
    done when it returns, and nothing is waited for).
    """

    def __init__(self, sync: bool = False):
        self.sync = sync
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, stage: str):
        if self.sync:
            self._block()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                self._block()
            self.totals[stage] += time.perf_counter() - t0
            self.counts[stage] += 1

    @staticmethod
    def _block():
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.current_stream().synchronize()

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": self.totals[k],
                "calls": self.counts[k],
                "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1),
            }
            for k in sorted(self.totals)
        }

    def report(self) -> str:
        lines = []
        for k, v in self.summary().items():
            lines.append(
                f"{k:20s} {v['total_s']:8.3f}s total  "
                f"{v['mean_ms']:8.2f}ms/call  x{v['calls']}"
            )
        return "\n".join(lines)


# ------------------------------------------------------------ the recorder --
# Spans carry perf_counter_ns() times: the clock the benchmark's profiler
# anchor (and trace() below) maps onto the device trace, so a span from
# any thread lands on the device timeline unchanged.

_enabled = False
# what span() and request() give while nothing records: one shared object
# (dynamo and torch.export trace through a nullcontext)
_NOOP = contextlib.nullcontext()
_ids = itertools.count(1)
_local = threading.local()
_buffers: List["_Buffer"] = []
_buffers_lock = threading.Lock()
_RESUMED = {"resumed": True}
_CLOCK = "busca:clock"
# torch sets this module flag, for every thread, while a torch.profiler
# session records; a torch without it would leave profiled runs without
# spans, so the import fails instead
if not hasattr(_autograd_profiler, "_is_profiler_enabled"):
    raise ImportError(
        "torch.autograd.profiler._is_profiler_enabled is missing from torch "
        f"{torch.__version__}: the span recorder cannot follow a "
        "torch.profiler session")


def enable_tracing():
    """Record spans and counters from now on, without a profiler (a run
    that measures the recorder's own cost)."""
    global _enabled
    _enabled = True


def disable_tracing():
    """Undo :func:`enable_tracing` (a running ``torch.profiler`` session
    still records); what was recorded waits for :func:`drain`."""
    global _enabled
    _enabled = False


def tracing() -> bool:
    """Whether spans and counters record now: while a ``torch.profiler``
    session records in this process, or after :func:`enable_tracing`.  A
    session that never calls :func:`drain` leaves its spans in memory."""
    return _enabled or _autograd_profiler._is_profiler_enabled


def _off() -> bool:
    return not tracing() or torch.compiler.is_compiling()


class _Buffer:
    """One thread's recorded spans and counters, its open spans and its
    request id."""

    __slots__ = ("spans", "counts", "stack", "rid", "owner")

    def __init__(self):
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = {}
        self.stack: List[int] = []
        self.rid = None
        self.owner = threading.current_thread()


def _buffer() -> _Buffer:
    buf = getattr(_local, "buf", None)
    if buf is None:
        buf = _local.buf = _Buffer()
        with _buffers_lock:
            _buffers.append(buf)
    return buf


def _cuda_events(device):
    """A start and an end event on the current stream of the tensor
    ``device``'s CUDA device, or None (no tensor, or not on CUDA)."""
    if device is None or not device.is_cuda:
        return None
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True),
            torch.cuda.current_stream(device.device))


class Span:
    """One recorded interval: ``name``; ``t0``/``t1`` in perf_counter_ns;
    ``thread``, the native id of the thread it began on; ``id`` and
    ``parent``, the enclosing span on that thread (or the one given);
    ``rid``, the request it served; ``attrs``; ``device_ms``, the device
    time between its CUDA events, resolved by :func:`drain` (None without
    them)."""

    __slots__ = ("name", "t0", "t1", "thread", "id", "parent", "rid",
                 "attrs", "device_ms", "_events", "_buf")

    def __init__(self, name, buf, rid, parent, attrs, events):
        self.name = name
        self.thread = threading.get_native_id()
        self.id = next(_ids)
        self.parent = parent
        self.rid = buf.rid if rid is None else rid
        self.attrs = attrs
        self.device_ms = None
        self._events = events
        self._buf = buf
        self.t0 = self.t1 = None

    def __enter__(self):
        buf = self._buf
        if self.parent is None and buf.stack:
            self.parent = buf.stack[-1]
        buf.stack.append(self.id)
        if self._events is not None:
            self._events[0].record(self._events[2])
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record(self._events[2])
        stack = self._buf.stack
        if stack and stack[-1] == self.id:
            stack.pop()
        elif self.id in stack:
            stack.remove(self.id)
        self._buf.spans.append(self)
        return False

    def end(self, rid=None):
        """Close a span opened by :func:`begin`, on any thread (``rid``
        replaces its request id)."""
        self.t1 = time.perf_counter_ns()
        if rid is not None:
            self.rid = rid
        _buffer().spans.append(self)


class _Unrecorded:
    """What :func:`begin` gives while nothing records."""

    __slots__ = ()
    id = None

    def end(self, rid=None):
        pass


_UNRECORDED = _Unrecorded()


def span(name: str, device=None, rid=None, parent: Optional[int] = None,
         attrs: Optional[dict] = None):
    """A context manager that records the block as a :class:`Span`
    ``name``.  ``device``, a tensor, also times the work the block enqueues
    on its CUDA device's current stream; ``rid`` defaults to the thread's
    :func:`request` id, ``parent`` to the innermost open span of the
    thread.  While nothing records, and under ``torch.compile`` /
    ``torch.export`` tracing, it is one shared no-op."""
    if _off():
        return _NOOP
    return Span(name, _buffer(), rid, parent, attrs, _cuda_events(device))


def begin(name: str):
    """A span that starts now and ends at its ``end()``, which may run on
    another thread (a frame's wait in a queue).  No span opened before its
    end nests in it; one whose block raises before ``end()`` is not
    recorded."""
    if _off():
        return _UNRECORDED
    buf = _buffer()
    sp = Span(name, buf, None, buf.stack[-1] if buf.stack else None, None,
              None)
    sp.t0 = time.perf_counter_ns()
    return sp


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name``."""
    if _off():
        return
    counts = _buffer().counts
    counts[name] = counts.get(name, 0) + n


class _Request:
    __slots__ = ("rid", "_buf", "_prev")

    def __init__(self, rid, buf):
        self.rid, self._buf, self._prev = rid, buf, None

    def __enter__(self):
        self._prev, self._buf.rid = self._buf.rid, self.rid
        return self

    def __exit__(self, *exc):
        self._buf.rid = self._prev
        return False


def request(rid):
    """A context manager under which this thread's spans carry the request
    id ``rid`` (a lockstep tick, or a tick and a stream's frame)."""
    if _off():
        return _NOOP
    return _Request(rid, _buffer())


def spanned_steps(gen, name: str):
    """``gen`` with each of its steps in a span ``name``: the first (its
    ``next``) under the caller's request id, each resumption (a ``send``,
    perhaps on another thread) a child of the first with ``attrs``
    ``{"resumed": True}`` and the same request id.  ``gen`` itself while
    nothing records."""
    if _off():
        return gen
    return _steps(gen, name, _buffer().rid)


def _steps(gen, name, rid):
    try:
        with span(name, rid=rid) as first:
            req = next(gen)
        parent = getattr(first, "id", None)
        while True:
            res = yield req
            with span(name, rid=rid, parent=parent, attrs=_RESUMED):
                req = gen.send(res)
    except StopIteration as e:
        return e.value


class Recording(NamedTuple):
    """What :func:`drain` collects: the spans in start order and the
    counters summed over threads."""

    spans: List[Span]
    counts: Dict[str, int]


def drain() -> Recording:
    """Collect and clear every thread's spans and counters.  A span's CUDA
    events are waited for and resolved to ``device_ms`` here, never while
    it is recorded."""
    with _buffers_lock:
        bufs = list(_buffers)
        _buffers[:] = [b for b in bufs if b.owner.is_alive()]
    spans: List[Span] = []
    counts: Dict[str, int] = {}
    for buf in bufs:
        got, buf.spans = buf.spans, []
        cnt, buf.counts = buf.counts, {}
        spans.extend(got)
        for k, v in cnt.items():
            counts[k] = counts.get(k, 0) + v
    for sp in spans:
        if sp._events is not None:
            start, end, _stream = sp._events
            end.synchronize()
            sp.device_ms = start.elapsed_time(end)
            sp._events = None
        sp._buf = None
    spans.sort(key=lambda sp: sp.t0)
    return Recording(spans, counts)


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the block (the card's kernels too when CUDA
    is available), written as ``<logdir>/trace.json`` (Chrome trace
    format: chrome://tracing or Perfetto).  The recorder records while
    the profiler does; its spans are drained into the same file on the
    profiler's clock (category ``busca``), its counters under
    ``buscaCounters``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        # the first range of a session starts late: anchor on a second
        with record_function(_CLOCK + ":warm"):
            pass
        with record_function(_CLOCK):
            anchor_ns = time.perf_counter_ns()
        yield prof
    rec = drain()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, anchor_ns, rec)


def _add_spans(path: str, anchor_ns: int, rec: Recording):
    """Append ``rec``'s spans to the Chrome trace at ``path``, placed by the
    ``busca:clock`` range that began at ``anchor_ns``."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    clock = next(e for e in events if e.get("name") == _CLOCK)
    off_us = float(clock["ts"]) - anchor_ns / 1e3
    for sp in rec.spans:
        if sp.t1 is None:
            continue
        args = {"id": sp.id, "parent": sp.parent}
        if sp.rid is not None:
            args["rid"] = list(sp.rid) if isinstance(sp.rid, tuple) \
                else sp.rid
        if sp.device_ms is not None:
            args["device_ms"] = sp.device_ms
        if sp.attrs:
            args.update(sp.attrs)
        events.append({"ph": "X", "cat": "busca", "name": sp.name,
                       "pid": clock["pid"], "tid": sp.thread,
                       "ts": sp.t0 / 1e3 + off_us,
                       "dur": (sp.t1 - sp.t0) / 1e3, "args": args})
    doc["buscaCounters"] = rec.counts
    with open(path, "w") as f:
        json.dump(doc, f)


def log_compile_times(enable: bool = True):
    """Log every nvcc build of a kernel (K1, K2) and every ``torch.export``
    trace with its seconds (the ``busca_tpu_torch.compile`` logger at
    INFO, to stderr unless it has a handler already)."""
    from busca_tpu_torch.ops.cuda_build import COMPILE_LOG

    COMPILE_LOG.setLevel(logging.INFO if enable else logging.WARNING)
    if enable and not COMPILE_LOG.handlers:
        COMPILE_LOG.addHandler(logging.StreamHandler())
