"""``assoc.mem_fold`` on a synthetic program trace: the memory slots the
ReID did not encode over the rows' slots, with the memory length read from
the run's configuration; a program without the counter (or with no model
call in the window) gives no reading."""

import types

import pytest


def _run(counts, seq_len=11):
    from bmk.program_spans import ProgramTrace

    pt = ProgramTrace([], counts, (0.0, 1.0))
    config = {"tracker": {"kwargs": {"seq_len": seq_len}}}
    return types.SimpleNamespace(_program_trace=pt, config=config,
                                 profiled=(0.0, 1.0))


def _read(run):
    from bmk.spec import metric_reader

    return metric_reader("assoc.mem_fold")(run)


@pytest.mark.parametrize("seq_len", [11, 5])
def test_reads_the_folded_share_of_the_rows_slots(seq_len):
    # two calls: 93 tracks in a 128-row bucket, 20 of them with an
    # incomplete memory (one zero unit), and 2 tracks in a 2-row bucket
    rows = 128 + 2
    units = 73 * seq_len + 1 + 2 * seq_len
    run = _run({"assoc.rows": rows, "assoc.tracks": 95,
                "assoc.crops": units + 96,
                "assoc.mem_folded": rows * seq_len - units}, seq_len)
    want = 100.0 * (rows * seq_len - units) / (rows * seq_len)
    assert _read(run) == pytest.approx(want)
    assert 0 < _read(run) < 100


def test_nothing_folded_reads_zero():
    run = _run({"assoc.rows": 4, "assoc.tracks": 4, "assoc.crops": 52,
                "assoc.mem_folded": 0})
    assert _read(run) == 0.0


def test_no_counter_or_no_call_gives_no_reading():
    # a program that predates the counter: its other counters are there
    assert _read(_run({"assoc.rows": 128, "assoc.tracks": 93,
                       "assoc.crops": 1544})) is None
    assert _read(_run({"assoc.mem_folded": 0})) is None
    run = types.SimpleNamespace(_program_trace=None, profiled=None,
                                config={})
    assert _read(run) is None
