"""The program's spans and counters as the traced run reads them
(``bmk/program_spans.py`` and the readers of the program's layers): a CPU
rehearsal with ``--trace 1`` of a served and an in-process cell records
every span and counter these readers read, and each reader returns a
number from them (the device-timed ones once the CPU run's spans carry a
device time and the run a device trace, which only a card gives); the
idle attribution's arithmetic; and a program without the recorder gives
no reading and no error."""

import importlib.util
import os
import types

import pytest

from conftest import BENCH, ROOT

SPANS = {
    "byte_mot20.served4": {
        "serve.queue_wait", "serve.tick", "detector.batch", "tracker.update",
        "tracker.crops", "tracker.match", "assoc.call", "assoc.prep",
        "assoc.encode", "assoc.decide", "assoc.readback", "assoc.post"},
    "ghost_mot20.crowd_dropout": {
        "tracker.update", "tracker.crops", "tracker.match", "reid.extract",
        "assoc.call", "assoc.prep", "assoc.encode", "assoc.decide",
        "assoc.readback", "assoc.post"},
}
HOST_READERS = {
    "byte_mot20.served4": ["serve.queue_wait_ms", "assoc.prep_ms",
                           "assoc.row_use", "assoc.crops_per_track",
                           "tracker.crops_ms", "tracker.match_ms"],
    "ghost_mot20.crowd_dropout": ["assoc.prep_ms", "assoc.row_use",
                                  "assoc.crops_per_track",
                                  "tracker.crops_ms", "tracker.match_ms"],
}
DEVICE_READERS = ["assoc.encode_ms", "assoc.decide_ms",
                  "device.idle_unattributed"]


def _run_module():
    spec = importlib.util.spec_from_file_location(
        "bench_run_main", os.path.join(BENCH, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reader(name):
    from bmk.spec import metric_reader

    return metric_reader(name)


@pytest.mark.parametrize("workload", sorted(SPANS))
def test_rehearsal_records_every_span_and_each_reader_reads_them(
        workload, monkeypatch, capsys):
    from bmk import spec
    from bmk.program_spans import program_trace
    from bmk.tracing import DeviceTrace

    seen = {}
    orig = spec.read_per_layer

    def read_per_layer(bench, name, run):
        seen["run"] = run
        return orig(bench, name, run)

    monkeypatch.setattr(spec, "read_per_layer", read_per_layer)
    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    code = _run_module().main(["--workload", workload, "--seed",
                               str(2**31 + 23), "--seconds", "8",
                               "--trace", "1", "--rehearse"])
    err = capsys.readouterr().err
    assert code == 0, err[-3000:]
    run = seen["run"]
    pt = program_trace(run)
    assert pt is not None
    names = {s.name for s in pt.spans}
    assert SPANS[workload] <= names, SPANS[workload] - names
    for counter in ("assoc.tracks", "assoc.rows", "assoc.crops"):
        assert pt.counts.get(counter, 0) > 0, pt.counts
    assert pt.frames() > 0 and pt.calls() > 0
    for name in HOST_READERS[workload]:
        value = _reader(name)(run)
        assert isinstance(value, float) and value >= 0, (name, value)
        # the run printed the same reading, marked as the CPU's
        assert f"rehearsal (CPU, not a device reading) {name} " in err
    assert 0 < _reader("assoc.row_use")(run) <= 100
    # the CPU has no CUDA events and no kernels: the device readers find
    # nothing, until the spans carry a device time and the run a trace
    for name in DEVICE_READERS:
        assert _reader(name)(run) is None, name
    for s in pt.spans:
        if s.name in ("assoc.encode", "assoc.decide"):
            s.device_ms = 2.0
    per_call = 2.0 * len(pt.named("assoc.encode", "assoc.call")) \
        / pt.calls()
    assert _reader("assoc.encode_ms")(run) == pytest.approx(per_call)
    dev = DeviceTrace()
    lo = int(run.profiled[0] * 1e9)
    dev.kernels = [("k", lo + 1000, lo + 2000, 0)]
    dev.offset_ns = 0
    run.device = dev
    share = _reader("device.idle_unattributed")(run)
    assert 0 <= share < 100


def test_idle_attribution_arithmetic():
    from bmk.program_spans import ProgramTrace
    from bmk.tracing import DeviceTrace

    def span(t0, t1):
        return types.SimpleNamespace(name="tracker.update", t0=t0, t1=t1,
                                     parent=None, id=t0, thread=1,
                                     attrs=None, device_ms=None)

    # window [0, 100] ns; kernels [10, 20] and [50, 60]; spans [0, 30] and
    # [55, 70]: idle 10 + 30 + 40 = 80 ns, 30 of it inside a span
    pt = ProgramTrace([span(0, 30), span(55, 70)], {}, (0.0, 100e-9))
    dev = DeviceTrace()
    dev.kernels = [("a", 110, 120, 0), ("b", 150, 160, 1)]
    dev.offset_ns = 100  # the device clock runs 100 ns ahead
    run = types.SimpleNamespace(_program_trace=pt, device=dev,
                                profiled=(0.0, 100e-9))
    assert _reader("device.idle_unattributed")(run) == pytest.approx(62.5)


def test_per_call_and_per_frame_readings_keep_to_the_window():
    from bmk.program_spans import ProgramTrace

    def span(sid, name, t0, t1, parent=None, device_ms=None, attrs=None):
        return types.SimpleNamespace(name=name, t0=t0, t1=t1, id=sid,
                                     parent=parent, thread=1, attrs=attrs,
                                     device_ms=device_ms)

    # window [0, 100] ns: call 1 inside it; call 2 open across its end,
    # with a prep and an encode that ended inside it; a frame's first step
    # before the window whose resumption, and its crops, fall inside
    spans = [
        span(1, "assoc.call", 10, 40),
        span(2, "assoc.prep", 11, 15, parent=1),
        span(3, "assoc.encode", 15, 30, parent=1, device_ms=4.0),
        span(4, "assoc.call", 60, 130),
        span(5, "assoc.prep", 61, 70, parent=4),
        span(6, "assoc.encode", 70, 90, parent=4, device_ms=9.0),
        span(7, "tracker.update", -20, -10),
        span(8, "tracker.update", 45, 55, parent=7,
             attrs={"resumed": True}),
        span(9, "tracker.crops", 46, 50, parent=8),
        span(10, "tracker.update", 80, 95),
        span(11, "tracker.crops", 81, 84, parent=10),
    ]
    pt = ProgramTrace(spans, {}, (0.0, 100e-9))
    run = types.SimpleNamespace(_program_trace=pt, profiled=(0.0, 100e-9))
    assert pt.calls() == 1 and pt.frames() == 1
    assert _reader("assoc.prep_ms")(run) == pytest.approx(4e-6)
    assert _reader("assoc.encode_ms")(run) == pytest.approx(4.0)
    assert _reader("tracker.crops_ms")(run) == pytest.approx(3e-6)


def test_a_program_without_the_recorder_gives_no_reading(monkeypatch):
    from busca_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "drain")
    run = types.SimpleNamespace(profiled=(0.0, 1.0), device=None)
    for name in sorted(set(sum(HOST_READERS.values(), []))
                       | set(DEVICE_READERS)):
        assert _reader(name)(run) is None, name
