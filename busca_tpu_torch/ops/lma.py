"""The local multi-scale weighted-tap sum of TransCenter's decoder.

Port of ``busca_tpu.ops.lma_pallas`` (the same layout and signatures).  For
every query pixel ``p`` and channel ``c`` of head ``h = c // head_dim``::

    out[p, c] = sum_{l < L, t < 9} w[p, h, l*9 + t] * V_l[p + dil_l * delta_t, c]

over a 3x3 neighbourhood per level (taps ordered dy-outer / dx-inner over
(-1, 0, 1)), with zeros outside the map and a float32 accumulator.

:func:`local_tap_sum_levels` computes the same sum from the level maps at
their own resolutions: a level smaller than the query grid is first
upsampled to it bilinearly (half-pixel centres, as ``F.interpolate(...,
mode="bilinear", align_corners=False)`` and ``jax.image.resize(...,
"bilinear")``).  :func:`local_tap_sum` takes the levels already at the query
size, stacked (the counterpart of ``lma_pallas.local_tap_sum``).

On a CUDA tensor both launch the hand-written kernel K2 (``ops/lma_cuda.py``,
``csrc/local_tap_sum.cu``), which reads each level at its own size and
interpolates inside the kernel; on a CPU tensor they run the plain versions
below, which upsample explicitly and then add the same 36 terms in the same
order.

Values and weights are both float32 or both bfloat16 (busca_tpu's kernel
takes either, ``lma_pallas.py:131-134``).  The sum accumulates in float32
and returns the values' dtype.  A bf16 level is upsampled as
``jax.image.resize`` computes it on XLA's CPU backend: its weight matrix
cast to bf16 (``compute_weight_mat(...).astype(x.dtype)``), then along x in
float32 and rounded to bf16, then along y and rounded again.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

TAP_OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
DTYPES = (torch.float32, torch.bfloat16)


def check_dtypes(levels: Sequence[torch.Tensor], weights: torch.Tensor):
    """Levels and weights must be all float32 or all bfloat16."""
    got = {v.dtype for v in levels} | {weights.dtype}
    if len(got) != 1 or weights.dtype not in DTYPES:
        raise ValueError(f"the tap sum takes all-float32 or all-bfloat16 "
                         f"values and weights, got values "
                         f"{sorted(str(v.dtype) for v in levels)} and "
                         f"weights {weights.dtype}")


def local_tap_sum_plain(values: torch.Tensor, weights: torch.Tensor,
                        dils: Sequence[int]) -> torch.Tensor:
    """The direct formulation (``lma_pallas.local_tap_sum_reference``):
    what the CPU path runs and what K2 is held against on the card.  Each
    term is ``float32(value) * float32(weight)``, added to a float32
    accumulator in level-major, tap order; the sum is returned in the
    values' dtype (lma_pallas.py:187-192)."""
    check_dtypes([values], weights)
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
    grid); weights ``[H4, W4, heads, L * 9]``; both float32 or both
    bfloat16.  Returns ``[H4, W4, C]`` in the value dtype.  A CUDA tensor
    goes through kernel K2, a CPU tensor through the plain version."""
    if weights.shape[2] != heads:
        raise ValueError(f"weights carry {weights.shape[2]} heads, not "
                         f"{heads}")
    if values.is_cuda:
        from busca_tpu_torch.ops.lma_cuda import local_tap_sum_cuda

        return local_tap_sum_cuda(values, weights, dils, heads)
    return local_tap_sum_plain(values, weights, dils)


def _lerp_axis(v: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    """Bilinear resampling of ``v`` along ``dim`` to ``size`` samples, by
    PyTorch's rule for ``align_corners=False`` (ATen ``UpSample.h``):
    ``src = max(scale * (dst + 0.5) - 0.5, 0)`` with ``scale =
    float32(n) / size``, ``i0 = floor(src)``, ``i1 = min(i0 + 1, n - 1)``,
    ``l1 = src - i0``, ``l0 = 1 - l1``; the result is ``l0 * v[i0] + l1 *
    v[i1]``, each product rounded before the add (as K2 computes it).

    A bf16 ``v`` takes ``jax.image.resize``'s weights in bf16: ``l0`` and
    ``l1`` rounded to bf16, and ``(1, 0)`` where ``i1`` is clamped to
    ``i0`` (its normalized weight matrix has one entry, 1, in that column);
    the lerp runs in float32 and is rounded to bf16."""
    n = v.shape[dim]
    scale = float(np.float32(n) / np.float32(size))
    src = (torch.arange(size, dtype=torch.float32, device=v.device) + 0.5) \
        * scale - 0.5
    src = src.clamp_min(0.0)
    i0 = src.to(torch.int64)
    i1 = i0 + (i0 < n - 1).to(torch.int64)
    l1 = src - i0.to(torch.float32)
    if v.dtype == torch.bfloat16:
        l1 = torch.where(i1 > i0, l1, torch.zeros_like(l1))
    l0 = 1.0 - l1
    shape = [1] * v.dim()
    shape[dim] = size
    if v.dtype != torch.bfloat16:
        return (v.index_select(dim, i0) * l0.reshape(shape)
                + v.index_select(dim, i1) * l1.reshape(shape))
    # jax.image.resize on bf16: weights cast to bf16, the product in
    # float32, rounded to bf16 after each axis
    vf = v.to(torch.float32)
    l0 = l0.to(torch.bfloat16).to(torch.float32).reshape(shape)
    l1 = l1.to(torch.bfloat16).to(torch.float32).reshape(shape)
    return (vf.index_select(dim, i0) * l0
            + vf.index_select(dim, i1) * l1).to(torch.bfloat16)


def upsample_bilinear_plain(v: torch.Tensor, hw: Sequence[int]
                            ) -> torch.Tensor:
    """``[h, w, C]`` -> ``[H, W, C]`` bilinearly (half-pixel centres): along
    x first, then along y, as separable lerps (a bf16 map is rounded to bf16
    after each, as ``jax.image.resize`` on XLA's CPU backend).  A map
    already of size ``hw`` is returned as it is."""
    h4, w4 = int(hw[0]), int(hw[1])
    if tuple(v.shape[:2]) == (h4, w4):
        return v
    return _lerp_axis(_lerp_axis(v, w4, 1), h4, 0)


def local_tap_sum_levels_plain(levels: Sequence[torch.Tensor],
                               weights: torch.Tensor,
                               dils: Sequence[int]) -> torch.Tensor:
    """Upsample every level to the query grid, stack, and take
    :func:`local_tap_sum_plain`: what the CPU path runs and what K2 is held
    against on the card."""
    check_dtypes(levels, weights)
    h4, w4 = weights.shape[:2]
    values = torch.stack([upsample_bilinear_plain(v, (h4, w4))
                          for v in levels])
    return local_tap_sum_plain(values, weights, dils)


def local_tap_sum_levels(levels: Sequence[torch.Tensor],
                         weights: torch.Tensor, dils: Sequence[int],
                         heads: int) -> torch.Tensor:
    """levels: L maps ``[h_l, w_l, C]`` (value-projected, each at its own
    resolution; level 0 is the query grid); weights ``[H4, W4, heads,
    L * 9]``; all float32 or all bfloat16.  Returns ``[H4, W4, C]`` in that
    dtype: :func:`local_tap_sum` of the levels upsampled bilinearly to
    ``(H4, W4)``.  CUDA tensors go through
    kernel K2, which reads each level at its own size; CPU tensors through
    the plain version."""
    if weights.shape[2] != heads:
        raise ValueError(f"weights carry {weights.shape[2]} heads, not "
                         f"{heads}")
    if weights.is_cuda:
        from busca_tpu_torch.ops.lma_cuda import local_tap_sum_levels_cuda

        return local_tap_sum_levels_cuda(levels, weights, dils, heads)
    return local_tap_sum_levels_plain(levels, weights, dils)
