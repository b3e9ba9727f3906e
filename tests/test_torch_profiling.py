"""The port's profiling hooks (busca_tpu_torch.utils.profiling) and file
sampler (busca_tpu_torch.utils.sample_files) against busca_tpu's: the
sampler's lists and errors equal; StageTimer's counts and report shape
equal to busca_tpu's StageTimer on the same stages; the Chrome trace and
the compile log written.
"""

import json
import logging
import os
import subprocess
import sys

import pytest
import torch

from busca_tpu.utils.profiling import StageTimer as JStageTimer
from busca_tpu.utils.sample_files import sample_files as j_sample_files
from busca_tpu_torch.utils import sample_files as tsf
from busca_tpu_torch.utils.profiling import (
    StageTimer,
    log_compile_times,
    trace,
)


@pytest.fixture
def folder(tmp_path):
    for i in range(10):
        (tmp_path / f"{i:06d}.jpg").write_bytes(b"x")
    (tmp_path / "sub").mkdir()  # directories are not listed
    return str(tmp_path)


@pytest.mark.parametrize("num", [None, 1, 3, 10])
def test_sample_files_matches_busca_tpu(folder, num):
    assert tsf.sample_files(folder, num) == j_sample_files(folder, num)


def test_sample_files_errors_and_cli(folder, capsys):
    for bad in (0, 11):
        with pytest.raises(ValueError, match="number of files"):
            tsf.sample_files(folder, bad)
    with pytest.raises(ValueError, match="Invalid path"):
        tsf.sample_files(os.path.join(folder, "missing"))
    tsf.main([folder, "--num-files", "4"])
    assert capsys.readouterr().out.strip() == ",".join(
        j_sample_files(folder, 4))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m",
                          "busca_tpu_torch.utils.sample_files", folder,
                          "--num-files", "2"], cwd=root, capture_output=True,
                         text=True, check=True, timeout=60)
    assert out.stdout.strip() == ",".join(j_sample_files(folder, 2))


def test_stage_timer_counts_like_busca_tpu():
    timers = (StageTimer(sync=True), JStageTimer())
    for timer in timers:
        for stage in ("detect", "associate", "detect"):
            with timer(stage):
                torch.ones(64, 64) @ torch.ones(64, 64)
    got, want = (t.summary() for t in timers)
    assert list(got) == list(want) == ["associate", "detect"]
    assert [v["calls"] for v in got.values()] == [1, 2]
    assert all(v["total_s"] >= 0 for v in got.values())
    assert timers[0].report().splitlines()[1].startswith("detect ")
    with pytest.raises(RuntimeError):
        with timers[0]("failing"):
            raise RuntimeError("the stage still counts")
    assert timers[0].counts["failing"] == 1


def test_trace_writes_chrome_trace(tmp_path):
    with trace(str(tmp_path)):
        torch.relu(torch.randn(256, 256)).sum()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("relu" in e.get("name", "") for e in events)


def test_log_compile_times_logs_exports(caplog):
    from busca_tpu_torch.serve.export import _trace

    log_compile_times(True)
    try:
        with caplog.at_level(logging.INFO, logger="busca_tpu_torch.compile"):
            _trace(torch.nn.Linear(4, 2), (torch.randn(3, 4),))
        assert any(r.getMessage().startswith("torch.export Linear: ")
                   for r in caplog.records)
    finally:
        log_compile_times(False)
    assert logging.getLogger("busca_tpu_torch.compile").level == \
        logging.WARNING
