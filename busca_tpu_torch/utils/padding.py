"""Shared bucket padding (the track-batch buckets of the association engine
and the crop batches)."""

from __future__ import annotations


def next_pow2(n: int, min_bucket: int = 1) -> int:
    """Smallest power of two >= max(n, min_bucket)."""
    b = min_bucket
    while b < n:
        b *= 2
    return b


def round_up(n: int, multiple: int) -> int:
    """Smallest positive multiple of ``multiple`` >= n."""
    return max(1, -(-n // multiple)) * multiple
