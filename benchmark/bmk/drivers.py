"""The two ways a cell drives the program, chosen by the mix's ``driver``:

- ``lockstep_server`` / ``single_server``: the program's tracking server in
  this process (its accept loop on a thread, as ``serve_unix`` runs), fed
  over a unix socket by the load generator (``bmk/loadgen.py``), a
  subprocess with one closed-loop client per stream;
- ``in_process``: ``eval/runner.py::run_sequence`` over one stream's frames
  and public detections, each frame through ``FeatureShim.update``.

Each returns a :class:`Window`: per-frame latencies, counts, the outputs the
check compares, and the timing of set-up and of the window.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional


from bmk import faults, parts, probe, program, traffic, weights


@dataclasses.dataclass
class Window:
    setup_s: float
    t_go: float
    t_end: float
    latencies_ms: List[float]
    completed: int           # frames whose tracks came back in the window
    attempted: int
    failed: int
    outputs: Dict[str, list]  # stream -> per frame [[id, x, y, w, h], ...]
    server_ms: List[float]
    round_trip_ms: List[float]
    profiled: Optional[tuple] = None
    device_trace: object = None
    errors: List[str] = dataclasses.field(default_factory=list)


class Run:
    """One run's arguments, cell and recorder (``run.py`` makes it)."""

    def __init__(self, args, cell, config, mix, rec, t0, device):
        self.args, self.cell, self.config, self.mix = args, cell, config, mix
        self.rec, self.t0, self.device = rec, t0, device
        self.states: Dict[str, dict] = {}
        self.streams = traffic.streams(mix, args.seed)
        self.marks: List[tuple] = []  # (step of set-up, its end)

    def mark(self, step: str):
        self.marks.append((step, time.perf_counter()))

    def setup_split(self) -> str:
        t, parts = self.t0, []
        for step, end in self.marks:
            parts.append(f"{step} {end - t:.2f} s")
            t = end
        return ", ".join(parts)


def _profiler(run: Run):
    if not run.args.trace:
        return None
    from bmk.tracing import Profiler

    return Profiler()


# ---------------------------------------------------------------- weights --
def make_weights(run: Run):
    """The benchmark's weights of the cell's models, on the device from the
    configuration's ``weights_seed``: each part's (a detector's, an
    extractor's) and BUSCA's, kept by role in ``run.states``."""
    import torch

    # a configuration's weights are the same in every run: with random
    # weights the detector's output, and so the trackers' work, would
    # change with them
    cfg, dev = run.config, run.device
    for role in parts.WEIGHTED:
        part = parts.of(cfg, role)
        if part is not None:
            run.states[role] = part.make_weights(run)
    run.states["busca"] = weights.cpu_state(
        weights.busca_model(cfg["busca"], int(cfg["weights_seed"]), dev))
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        # the program's peak: the benchmark's own weight making and
        # calibration are not the program's
        torch.cuda.reset_peak_memory_stats()


# ----------------------------------------------------------------- served --
class _Loadgen:
    def __init__(self, run: Run, sock: str):
        here = os.path.dirname(os.path.abspath(__file__))
        cmd = [sys.executable, os.path.join(here, "loadgen.py"),
               "--mix", os.path.join(os.path.dirname(here), "mixes",
                                     run.cell["traffic"] + ".json"),
               "--seed", str(run.args.seed), "--socket", sock,
               "--seconds", str(run.args.seconds)]
        if run.args.rehearse:
            cmd.append("--rehearse")
        env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
                   MKL_NUM_THREADS="1")
        self.proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, text=True,
                                     env=env)

    def send(self, line: str):
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()

    def expect(self, event: str) -> dict:
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"the load generator ended before "
                               f"{event!r} (exit {self.proc.wait()})")
        msg = json.loads(line)
        if msg.get("event") != event:
            raise RuntimeError(f"load generator: {msg}")
        return msg

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        for f in (self.proc.stdin, self.proc.stdout):
            try:
                f.close()
            except OSError:
                pass


def run_served(run: Run) -> Window:
    import torch

    rec, mix = run.rec, run.mix
    sock = os.path.join(tempfile.gettempdir(), f"bmk{os.getpid()}.sock")
    lg = _Loadgen(run, sock)
    server_thread = None
    undo = lambda: None  # noqa: E731
    try:
        run.mark("imports")
        make_weights(run)
        run.mark("weights and calibration")
        program.set_precision()
        detector = parts.of(run.config, "detector")
        det = detector.build(run.config, run.states["detector"], run.device)
        eng = program.engine(run.config, run.states["busca"], run.device)
        if run.args.control:
            faults.control(run, eng)
        detector.wrap(det, rec)
        probe.wrap_engine(eng, rec)
        undo = probe.wrap_crops(rec)
        base_factory = program.tracker_factory(run.config, eng)
        names = iter([run.streams[i].name for i in traffic.stream_order(
            mix, run.args.seed)])

        def factory():
            trk = base_factory()
            if rec.phase == "real":
                return probe.RecordingTracker(trk, rec, next(names))
            return trk

        rec.phase = "warm"
        srv = program.server(run.config, mix, det, factory)
        n_conn = 2 * len(run.streams)
        server_thread = threading.Thread(
            target=srv.serve_unix, args=(sock, n_conn), daemon=True)
        server_thread.start()
        while not os.path.exists(sock):
            time.sleep(0.01)
        run.mark("program")
        lg.expect("rendered")
        run.mark("rendering (load generator)")
        lg.send("warm")
        lg.expect("warmed")
        run.mark("warm-up")
        rec.phase = "real"
        lg.send("connect")
        lg.expect("ready")
        if run.device.type == "cuda":
            torch.cuda.synchronize()
        prof = _profiler(run)
        rec.active = True
        k1_0 = probe.k1_launch_count()
        if prof is not None:
            prof.start()
        t_go = time.perf_counter()
        setup_s = t_go - run.t0
        lg.send(f"go {t_go!r}")
        device_trace, profiled = None, None
        if prof is not None:
            time.sleep(max(0.0, t_go + float(mix["profile_seconds"])
                           - time.perf_counter()))
            device_trace = prof.stop()
            profiled = (prof.t_start, prof.t_stop)
        done = lg.expect("done")
        rec.active = False
        rec.k1_launches = probe.k1_launch_count() - k1_0
        server_thread.join(timeout=120)
        if server_thread.is_alive():
            raise RuntimeError("the server did not close its connections")
    finally:
        undo()
        lg.close()
    t_end = t_go + run.args.seconds
    lat, rt, srv_ms, outputs = [], [], [], {}
    completed = attempted = failed = 0
    errors = []
    for name, s in done["streams"].items():
        outputs[name] = []
        for send, recv, ok, ms, tracks in zip(s["send"], s["recv"], s["ok"],
                                              s["server_ms"], s["tracks"]):
            attempted += 1
            if not ok:
                failed += 1
                errors.append(f"{name}: {tracks}")
                continue
            lat.append((recv - send) * 1e3)
            if recv <= t_end:
                completed += 1
            if ms is not None:
                srv_ms.append(float(ms))
                rt.append((recv - send) * 1e3)
            outputs[name].append(tracks)
    return Window(setup_s, t_go, t_end, lat, completed, attempted, failed,
                  outputs, srv_ms, rt, profiled, device_trace, errors)


# ------------------------------------------------------------- in process --
def run_in_process(run: Run) -> Window:
    import torch

    from busca_tpu_torch.eval.runner import run_sequence

    rec, mix = run.rec, run.mix
    (stream,) = run.streams
    (k0,) = traffic.phases(mix, run.args.seed)
    run.mark("imports")
    frames = traffic.render(stream)
    dets = traffic.public_detections(stream)
    run.mark("rendering")
    make_weights(run)
    run.mark("weights")
    program.set_precision()
    eng = program.engine(run.config, run.states["busca"], run.device)
    if run.args.control:
        faults.control(run, eng)
    extractor = parts.of(run.config, "extractor")
    feats = None if extractor is None else extractor.wrap(
        extractor.build(run.config, run.states["extractor"], run.device), rec)
    probe.wrap_engine(eng, rec)
    undo = probe.wrap_crops(rec)
    factory = program.tracker_factory(run.config, eng, feats)
    f = run.config["output_filter"]
    n = len(frames)
    try:
        warm = factory()
        with torch.no_grad():
            for k in range(k0, k0 + int(mix["warmup_frames"])):
                i = traffic.pingpong(k, n)
                warm.update(*dets[i], 1.0, frames[i])
        del warm
        run.mark("program and warm-up")
        shim = factory()
        if extractor is not None:
            extractor.watch(shim, rec)
        trk = probe.RecordingTracker(shim, rec, stream.name)
        if run.device.type == "cuda":
            torch.cuda.synchronize()
        prof = _profiler(run)
        state = {"profiled": None, "trace": None}
        rec.active = True
        k1_0 = probe.k1_launch_count()
        if prof is not None:
            prof.start()
        t_go = time.perf_counter()
        setup_s = t_go - run.t0
        t_end = t_go + run.args.seconds
        t_prof = t_go + float(mix["profile_seconds"])

        def frame_source():
            k = k0
            while True:
                now = time.perf_counter()
                if prof is not None and state["trace"] is None \
                        and now >= t_prof:
                    state["trace"] = prof.stop()
                    state["profiled"] = (prof.t_start, prof.t_stop)
                if now >= t_end:
                    return
                i = traffic.pingpong(k, n)
                k += 1
                yield frames[i]

        def det_source():
            k = k0
            while True:
                yield dets[traffic.pingpong(k, n)]
                k += 1

        with torch.no_grad():
            res = run_sequence(trk, frame_source(), det_source(),
                               name=stream.name,
                               min_box_area=float(f["min_box_area"]),
                               vertical_thresh=f["vertical_thresh"])
        if prof is not None and state["trace"] is None:
            state["trace"] = prof.stop()
            state["profiled"] = (prof.t_start, prof.t_stop)
        rec.active = False
        rec.k1_launches = probe.k1_launch_count() - k1_0
    finally:
        undo()
    lat = [(b - a) * 1e3 for a, b in rec.update_times]
    completed = sum(1 for _a, b in rec.update_times if b <= t_end)
    outputs = {stream.name: [
        [[int(i), *map(float, t)] for t, i in zip(tlwhs, ids)]
        for _fid, tlwhs, ids, _c in res.results]}
    return Window(setup_s, t_go, t_end, lat, completed, len(lat), 0, outputs,
                  [], [], state["profiled"], state["trace"])


DRIVERS = {"lockstep_server": run_served, "single_server": run_served,
           "in_process": run_in_process}
