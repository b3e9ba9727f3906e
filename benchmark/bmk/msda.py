"""Multi-scale deformable attention's (MSDA) least time, from a call's
shapes: the arithmetic of ``kernel.msda_roofline``, and the operations
``step_mfu`` counts for it.

A call samples, for each of ``queries`` queries, ``heads`` heads,
``levels`` levels and ``points`` points, a bilinear value of ``head_dim``
channels and adds it, weighted, to the query's output.  Its least bytes
are the value memory (``values`` rows of ``heads * head_dim``), the
sampling locations (two coordinates a sample), the attention weights (one
a sample) and the output (``queries`` rows), each moved once in float32;
its operations are five multiply-adds a sample and channel (the four
corners' products and the weighting), two operations each.  Both follow
from the shapes alone, so the reading counts the same work whatever
implements the op.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from bmk.flops import PEAKS

SHAPE_KEYS = ("batch", "queries", "values", "heads", "levels", "points",
              "head_dim")
F32_BYTES = 4


def msda_bytes(batch: int, queries: int, values: int, heads: int,
               levels: int, points: int, head_dim: int) -> int:
    samples = batch * queries * heads * levels * points
    return F32_BYTES * (batch * values * heads * head_dim + 2 * samples
                        + samples + batch * queries * heads * head_dim)


def msda_operations(batch: int, queries: int, values: int, heads: int,
                    levels: int, points: int, head_dim: int) -> int:
    return 2 * 5 * batch * queries * heads * levels * points * head_dim


def msda_least_seconds(shape: Dict[str, int]) -> float:
    """The larger of the call's bytes over the memory rate and its float32
    operations over the float32 rate (``shape``: the ``SHAPE_KEYS``)."""
    args = [int(shape[k]) for k in SHAPE_KEYS]
    return max(msda_bytes(*args) / PEAKS["hbm_bytes_per_s"],
               msda_operations(*args) / PEAKS["float32"])


def pyramid(test_hw: Sequence[int]) -> List[Tuple[int, int]]:
    """PVTv2's four levels at the input ``test_hw``: a stride-4 patch
    embedding (kernel 7, padding 3), then three stride-2 ones (kernel 3,
    padding 1)."""
    h, w = (int(test_hw[0]) - 1) // 4 + 1, (int(test_hw[1]) - 1) // 4 + 1
    out = [(h, w)]
    for _ in range(3):
        h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        out.append((h, w))
    return out
