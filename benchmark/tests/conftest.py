"""The benchmark's own tests (``python -m pytest benchmark/tests``): the
harness's arithmetic, its data-driven lookup, its imports, a CPU rehearsal
of whole runs, the faults the check must catch, and, on the card
(``cuda`` marker), the precision control."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)


@pytest.fixture
def card():
    """Skip unless a CUDA card is visible (decided here, never at
    import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs on the card")
    return torch.device("cuda", 0)
