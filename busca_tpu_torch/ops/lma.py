"""The local multi-scale weighted-tap sum of TransCenter's decoder.

Port of ``busca_tpu.ops.lma_pallas`` (the same layout and signatures).  For
every query pixel ``p`` and channel ``c`` of head ``h = c // head_dim``::

    out[p, c] = sum_{l < L, t < 9} w[p, h, l*9 + t] * V_l[p + dil_l * delta_t, c]

over a 3x3 neighbourhood per level (taps ordered dy-outer / dx-inner over
(-1, 0, 1)), with zeros outside the map and a float32 accumulator.

On a CUDA tensor :func:`local_tap_sum` launches the hand-written kernel K2
(``ops/lma_cuda.py``, ``csrc/local_tap_sum.cu``); on a CPU tensor it runs the
plain version below, the direct formulation with the same 36 terms in the
same order.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

TAP_OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def local_tap_sum_plain(values: torch.Tensor, weights: torch.Tensor,
                        dils: Sequence[int]) -> torch.Tensor:
    """The direct formulation (``lma_pallas.local_tap_sum_reference``):
    what the CPU path runs and what K2 is held against on the card."""
    levels, h4, w4, c = values.shape
    heads = weights.shape[2]
    head_dim = c // heads
    acc = torch.zeros((h4, w4, c), dtype=torch.float32, device=values.device)
    for lvl in range(levels):
        dil = int(dils[lvl])
        vpad = F.pad(values[lvl], (0, 0, dil, dil, dil, dil))
        for t, (dy, dx) in enumerate(TAP_OFFSETS):
            sh = vpad[dil + dy * dil: dil + dy * dil + h4,
                      dil + dx * dil: dil + dx * dil + w4]
            wt = weights[:, :, :, lvl * 9 + t].to(torch.float32)
            wt = wt.repeat_interleave(head_dim, dim=2)
            acc = acc + sh.to(torch.float32) * wt
    return acc.to(values.dtype)


def local_tap_sum(values: torch.Tensor, weights: torch.Tensor,
                  dils: Sequence[int], heads: int) -> torch.Tensor:
    """values ``[L, H4, W4, C]`` (value-projected and upsampled to the query
    grid); weights ``[H4, W4, heads, L * 9]``.  Returns ``[H4, W4, C]`` in
    the value dtype.  A CUDA tensor goes through kernel K2, a CPU tensor
    through the plain version."""
    if weights.shape[2] != heads:
        raise ValueError(f"weights carry {weights.shape[2]} heads, not "
                         f"{heads}")
    if values.is_cuda:
        from busca_tpu_torch.ops.lma_cuda import local_tap_sum_cuda

        return local_tap_sum_cuda(values, weights, dils, heads)
    return local_tap_sum_plain(values, weights, dils)
