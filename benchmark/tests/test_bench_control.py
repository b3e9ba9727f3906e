"""The precision control on the card (``cuda`` marker): the reference in
the program's place, TF32 for the float32 models and float8 operands for
BUSCA's bf16 products, must come out not correct.  On the chip:
``python -m pytest benchmark/tests/test_bench_control.py``."""

import pytest

from test_bench_rehearsal import bench


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["byte_mot20.served4",
                                      "ghost_mot20.crowd_dropout"])
def test_control_is_not_correct(card, workload):
    proc, result = bench("--workload", workload, "--seed", str(2**31 + 17),
                         "--seconds", "5", "--trace", "0", "--control",
                         timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert result["correct"] is False, result["checks"]
