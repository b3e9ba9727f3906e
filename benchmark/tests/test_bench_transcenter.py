"""The ``transcenter_mot20.served1`` cell: a CPU rehearsal of the whole
served path (the deformable TransCenter through ``TrackingServer``, the
check against ``benchref/transcenter.py``), its readers on the program's
spans and counters, MSDA's byte count against a hand count at the MOT20
pyramid, and the detector part's operations."""

import importlib.util
import json
import os
import types

import pytest

from conftest import BENCH, ROOT

CELL = "transcenter_mot20.served1"
READERS = ("transcenter.backbone_ms", "transcenter.decoder_ms",
           "transcenter.msda_ms", "kernel.msda_roofline",
           "detector.prior_ms", "detector.priors_per_frame")
DEVICE_READERS = READERS[:4]


def _reader(name):
    from bmk.spec import metric_reader

    return metric_reader(name)


def _run_module():
    spec = importlib.util.spec_from_file_location(
        "bench_run_main", os.path.join(BENCH, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rehearsal_runs_the_cell_and_records_its_spans(monkeypatch, capsys):
    from bmk import spec
    from bmk.program_spans import program_trace

    seen = {}
    orig = spec.read_per_layer

    def read_per_layer(bench, name, run):
        seen["run"] = run
        return orig(bench, name, run)

    monkeypatch.setattr(spec, "read_per_layer", read_per_layer)
    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    code = _run_module().main(["--workload", CELL, "--seed",
                               str(2**31 + 29), "--seconds", "8",
                               "--trace", "1", "--rehearse"])
    out, err = capsys.readouterr()
    assert code == 0, err[-3000:]
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"], result
    assert {"det_box_rel", "det_score", "det_unmatched"} <= set(
        result["checks"])
    run = seen["run"]
    pt = program_trace(run)
    names = {s.name for s in pt.spans}
    assert {"detector.frame", "detector.prior", "transcenter.backbone",
            "transcenter.decoder", "transcenter.msda"} <= names
    frames = len(pt.named("detector.frame"))
    assert frames > 0
    assert len(pt.named("transcenter.msda", "detector.frame")) == 12 * frames
    for name in ("detector.prior_ms", "detector.priors_per_frame"):
        value = _reader(name)(run)
        assert isinstance(value, float) and value > 0, (name, value)
        assert f"rehearsal (CPU, not a device reading) {name} " in err
    # the CPU has no CUDA events: the device readers find nothing until
    # the spans carry a device time
    for name in DEVICE_READERS:
        assert _reader(name)(run) is None, name
    for s in pt.spans:
        if s.name.startswith("transcenter."):
            s.device_ms = 3.0
    assert _reader("transcenter.msda_ms")(run) == pytest.approx(36.0)
    assert _reader("transcenter.backbone_ms")(run) == pytest.approx(3.0)
    assert 0 < _reader("kernel.msda_roofline")(run) <= 100


def test_control_rehearsal_is_not_correct(monkeypatch, capsys):
    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    code = _run_module().main(["--workload", CELL, "--seed",
                               str(2**31 + 31), "--seconds", "8",
                               "--trace", "0", "--rehearse", "--control"])
    out, err = capsys.readouterr()
    assert code == 0, err[-3000:]
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"] is False, result["checks"]


def test_msda_bytes_match_a_hand_count_at_the_mot20_pyramid():
    """640x1088: levels 160x272, 80x136, 40x68, 20x34 (57,800 values),
    43,520 queries, 8 heads of 32 channels, 4 levels, 9 points."""
    from bmk.msda import msda_bytes, msda_least_seconds, pyramid

    levels = pyramid((640, 1088))
    assert levels == [(160, 272), (80, 136), (40, 68), (20, 34)]
    value = 57800 * 256 * 4
    samples = 43520 * 8 * 4 * 9
    locations, weights = samples * 2 * 4, samples * 4
    output = 43520 * 256 * 4
    assert (value, locations, weights, output) == (
        59187200, 100270080, 50135040, 44564480)
    shape = dict(batch=1, queries=43520, values=57800, heads=8, levels=4,
                 points=9, head_dim=32)
    total = msda_bytes(*shape.values())
    assert total == value + locations + weights + output == 254156800
    assert msda_least_seconds(shape) == pytest.approx(total / 3.35e12)
    assert msda_least_seconds(shape) * 1e3 == pytest.approx(0.0759, abs=1e-4)


def test_msda_roofline_reads_each_call_by_its_own_shape():
    from bmk.program_spans import ProgramTrace
    from bmk.msda import msda_least_seconds

    shape = dict(batch=1, queries=100, values=50, heads=2, levels=2,
                 points=3, head_dim=4)
    big = dict(shape, queries=1000)

    def span(sid, name, t0, t1, parent=None, device_ms=None, attrs=None):
        return types.SimpleNamespace(name=name, t0=t0, t1=t1, id=sid,
                                     parent=parent, thread=1, attrs=attrs,
                                     device_ms=device_ms)

    # window [0, 100] ns: frame 1 inside it with two calls; frame 2 open
    # across the window's end, its call not read
    spans = [span(1, "detector.frame", 0, 50),
             span(2, "transcenter.decoder", 5, 45, 1, 9.0),
             span(3, "transcenter.msda", 6, 10, 2, 1.0, shape),
             span(4, "transcenter.msda", 12, 20, 2, 3.0, big),
             span(5, "detector.frame", 60, 130),
             span(6, "transcenter.msda", 61, 70, 5, 5.0, shape)]
    run = types.SimpleNamespace(
        _program_trace=ProgramTrace(spans, {}, (0.0, 100e-9)))
    want = (msda_least_seconds(shape) + msda_least_seconds(big)) / 4e-3
    assert _reader("kernel.msda_roofline")(run) == pytest.approx(100 * want)
    assert _reader("transcenter.msda_ms")(run) == pytest.approx(4.0)
    assert _reader("transcenter.decoder_ms")(run) == pytest.approx(9.0)
    spans[3].attrs = None  # a program whose spans carry no shapes
    assert _reader("kernel.msda_roofline")(run) is None


def test_a_program_without_the_spans_gives_no_reading(monkeypatch):
    from busca_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "drain")
    run = types.SimpleNamespace(profiled=(0.0, 1.0), device=None)
    for name in READERS:
        assert _reader(name)(run) is None, name


def test_the_part_counts_the_model_and_msda():
    """One forward's operations at 640x1088: the reference's GEMMs and
    convolutions (PVTv2-b2 twice, the projections, the decoder's linears,
    the heads) plus twelve MSDA calls of 10 operations a sample and
    channel."""
    from bmk.msda import msda_operations
    from bmk.parts import part

    with open(os.path.join(BENCH, "configs",
                           "transcenter_mot20.json")) as f:
        config = json.load(f)
    det = part("detector", "transcenter")
    ops, dtype = det.flops(config, 1)
    assert dtype == "float32"
    msda = msda_operations(1, 43520, 57800, 8, 4, 9, 32)
    assert msda == 10 * 43520 * 8 * 4 * 9 * 32
    assert 1.2e12 < ops - 12 * msda < 1.35e12
    assert det.flops(config, 2)[0] == 2 * ops
