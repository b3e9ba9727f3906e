"""The traced run's device side: ``torch.profiler`` over the traced window,
reduced to kernel intervals and the ``bench:<layer>`` ranges, and the
``TraceRun`` that the per-layer metric readers (``benchmark/metrics``) read.

The profiler's raw kineto events are read directly (no function-event
tree), so a window of a million events reduces in seconds.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import List, Tuple

import numpy as np


class DeviceTrace:
    """Kernels and harness ranges of one profiled window (times in ns on
    the profiler's clock)."""

    def __init__(self):
        self.kernels: List[Tuple[str, int, int, int]] = []  # name, t0, t1, corr
        self.ranges: List[Tuple[str, int, int, int]] = []   # name, t0, t1, tid
        self.window_ns: Tuple[int, int] = (0, 0)
        # profiler ns = host perf_counter ns + offset_ns
        self.offset_ns = None


class Profiler:
    """Start and stop the profiler around the traced window (one thread
    starts and stops it; the other threads' operations and every kernel are
    recorded)."""

    def __init__(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(
            activities=acts,
            record_shapes=False, with_stack=False, profile_memory=False)
        self.t_start = self.t_stop = None

    def start(self):
        import torch

        self.prof.start()
        self.t_start = time.perf_counter()
        # a range on this thread ties the host clock to the profiler's:
        # ranges of the other threads are not recorded, their host spans
        # are placed on the device timeline through this offset
        with torch.profiler.record_function("bench:clock"):
            self.t_clock = time.perf_counter()

    def stop(self) -> DeviceTrace:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        self.prof.stop()
        tr = reduce_events(self.prof.profiler.kineto_results.events())
        clock = [r for r in tr.ranges if r[0] == "clock"]
        if clock:
            tr.offset_ns = clock[0][1] - int(self.t_clock * 1e9)
        return tr


def reduce_events(events) -> DeviceTrace:
    from torch.autograd import DeviceType

    tr = DeviceTrace()
    lo, hi = None, None
    for e in events:
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if "Memcpy" in name or "Memset" in name or e.is_user_annotation():
                continue
            tr.kernels.append((name, t0, t1, e.correlation_id()))
        elif name.startswith("bench:"):
            tr.ranges.append((name[6:], t0, t1, e.start_thread_id()))
        lo = t0 if lo is None else min(lo, t0)
        hi = t1 if hi is None else max(hi, t1)
    tr.window_ns = (lo or 0, hi or 0)
    return tr


def union(intervals) -> List[Tuple[int, int]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class TraceRun:
    """What a traced run hands the metric readers.

    ``spans``: host-clock spans ``(layer, t0, t1, thread, frames)`` over the
    whole window; ``profiled``: the profiler's window on that clock,
    ``device`` its :class:`DeviceTrace`;
    ``forwards``: ``(kind, t, shape...)``; ``k1``: each K1 launch ``(t,
    frame_hw, boxes, out_elements)``; ``config``: the cell's configuration.
    """

    def __init__(self, spans, profiled, device: DeviceTrace, forwards, k1,
                 config, served_overheads=None):
        self.spans = spans
        self.profiled = profiled
        self.device = device
        self.forwards = forwards
        self.k1 = k1
        self.config = config
        self.served_overheads = served_overheads or []

    # ---------------------------------------------------------- host side --
    def spans_of(self, name):
        return [s for s in self.spans if s[0] == name]

    def span_seconds(self, name) -> float:
        return sum(s[2] - s[1] for s in self.spans_of(name))

    def self_seconds(self, name, children) -> float:
        """Time in ``name``'s spans not covered by ``children``'s spans on
        the same thread."""
        kids = defaultdict(list)
        for s in self.spans:
            if s[0] in children:
                kids[s[3]].append((s[1], s[2]))
        kids = {k: union(v) for k, v in kids.items()}
        total = 0.0
        for s in self.spans_of(name):
            t = s[2] - s[1]
            for a, b in kids.get(s[3], ()):
                t -= max(0.0, min(b, s[2]) - max(a, s[1]))
            total += t
        return total

    def in_profiled(self, t) -> bool:
        return self.profiled[0] <= t < self.profiled[1]

    def profiled_frames(self) -> int:
        """Frames the detector or the tracker took up in the profiled
        window."""
        det = [s for s in self.spans_of("detector")
               if self.in_profiled(s[1])]
        if det:
            return sum(s[4] for s in det)
        return sum(s[4] for s in self.spans_of("tracker")
                   if self.in_profiled(s[1]))

    # -------------------------------------------------------- device side --
    def profiled_seconds(self) -> float:
        return self.profiled[1] - self.profiled[0]

    def busy_seconds(self) -> float:
        return sum(b - a for a, b in union(
            (k[1], k[2]) for k in self.device.kernels)) / 1e9

    def kernel_seconds(self, match) -> float:
        return sum(k[2] - k[1] for k in self.device.kernels
                   if match(k[0])) / 1e9

    def host_ranges(self, layer=None):
        """The host spans (all threads) on the profiler's clock, as
        ``(layer, t0_ns, t1_ns)``."""
        off = self.device.offset_ns
        if off is None:
            return []
        return [(s[0], int(s[1] * 1e9) + off, int(s[2] * 1e9) + off)
                for s in self.spans if layer is None or s[0] == layer]

    def range_device_seconds(self, layer: str) -> float:
        """Device time of the kernels that start inside a ``layer`` span.
        The detector's calls end in a wait for their own results, and one
        thread launches the whole step, so a kernel that starts inside the
        call's span is the call's."""
        iv = np.array(sorted((a, b) for _n, a, b in self.host_ranges(layer)))
        if not len(iv):
            return 0.0
        total = 0
        for _name, k0, k1, _corr in self.device.kernels:
            i = np.searchsorted(iv[:, 0], k0, side="right") - 1
            if i >= 0 and k0 <= iv[i, 1]:
                total += k1 - k0
        return total / 1e9

    def breakdown(self) -> dict:
        """The kernels that took the most device time and the longest idle
        gaps, each labelled by the innermost harness span open when it
        began (``host`` where none was)."""
        by_name = defaultdict(int)
        for name, a, b, _ in self.device.kernels:
            by_name[name[:120]] += b - a
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        busy = union((k[1], k[2]) for k in self.device.kernels)
        gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
        gaps.sort(key=lambda g: g[0] - g[1])
        ranges = sorted(self.host_ranges(), key=lambda r: r[1])
        labelled = []
        for a, b in gaps[:10]:
            open_ = [r for r in ranges if r[1] <= a < r[2]]
            label = (min(open_, key=lambda r: r[2] - r[1])[0]
                     if open_ else "host")
            labelled.append([f"{label}@{(a - self.device.window_ns[0]) / 1e9:.3f}s",
                             (b - a) / 1e9])
        return {"device_ops": [[n, v / 1e9] for n, v in ops],
                "idle_gaps": labelled}
