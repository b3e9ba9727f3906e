"""Whole runs on the CPU at the cells' rehearsal sizes (``--rehearse``,
which a card run never passes): each driver end to end, the check true,
and no metric printed without a card."""

import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

RUN = os.path.join(BENCH, "run.py")


def bench(*args, timeout=600):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, RUN, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if lines and lines[-1].startswith(
        "{") else None
    return proc, result


@pytest.mark.parametrize("workload,trace", [
    ("byte_mot20.served4", "1"),
    ("ghost_mot20.crowd_dropout", "0"),
    ("ghost_mot20.crowd_clear", "1"),
])
def test_rehearsal_runs_a_cell_end_to_end(workload, trace):
    proc, result = bench("--workload", workload, "--seed", str(2**31 + 11),
                         "--seconds", "8", "--trace", trace, "--rehearse")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert result["correct"], result
    assert result["metrics"] == {} and result["rehearsal"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("workload", ["byte_mot20.served4",
                                      "ghost_mot20.crowd_dropout"])
def test_control_rehearsal_is_not_correct(workload):
    """The precision control in the program's place runs the whole path
    (the engine's folded memory unfolded for the reference) and fails."""
    proc, result = bench("--workload", workload, "--seed", str(2**31 + 17),
                         "--seconds", "8", "--trace", "0", "--rehearse",
                         "--control")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["prob_gap"]["value"] > 0.01


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    proc, result = bench("--workload", "byte_mot20.served4", "--seed", "1",
                         "--seconds", "1", "--trace", "0", timeout=120)
    assert proc.returncode != 0 and result is None


def test_bare_directory_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files has
    no program: no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "ghost_mot20.crowd_clear", "--seed", "1", "--seconds", "1",
         "--trace", "0", "--rehearse"], cwd=tmp_path, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert not proc.stdout.strip()
