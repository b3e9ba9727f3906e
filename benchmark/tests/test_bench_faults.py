"""The check catches the timed path broken underneath the harness: a
tracker whose state stays unchanged, half of the association batch left
out of its statistics, a replied track altered where it is produced, a
grouped third round that answers one stream's request with another's
rows, a third round scored on the wrong memory.  (No cell runs across
chips, so there is no exchange between them to leave out.)  Runs skip the
look for a card (``--rehearse``) and drive the rest."""

import pytest

from test_bench_rehearsal import bench

CASES = [("state_unchanged", "byte_mot20.served4"),
         ("half_batch", "byte_mot20.served4"),
         ("altered_answer", "ghost_mot20.crowd_dropout"),
         ("state_unchanged", "ghost_mot20.crowd_clear"),
         ("crossed_requests", "byte_mot20.served4"),
         ("wrong_memory", "ghost_mot20.crowd_dropout")]


@pytest.mark.parametrize("fault,workload", CASES)
def test_fault_makes_correct_false(fault, workload):
    proc, result = bench("--workload", workload, "--seed", str(2**31 + 3),
                         "--seconds", "10", "--trace", "0", "--rehearse",
                         "--fault", fault)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert result["correct"] is False, result["checks"]
