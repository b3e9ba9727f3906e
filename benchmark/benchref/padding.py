"""Frozen copy of ``busca_tpu_torch/utils/padding.py`` at commit c2c24f5, part of the
benchmark's plain reference (it imports nothing of the program; edits
to the program do not reach it).

Shared power-of-two bucket padding (the track-batch buckets of the
association engine and the crop batches)."""

from __future__ import annotations


def next_pow2(n: int, min_bucket: int = 1) -> int:
    """Smallest power of two >= max(n, min_bucket)."""
    b = min_bucket
    while b < n:
        b *= 2
    return b
