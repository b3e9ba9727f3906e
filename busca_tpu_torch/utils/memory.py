"""Process and device memory introspection (port of
``busca_tpu.utils.memory``; reference busca/utils.py:10-27): the host's
resident set and the card's allocator statistics."""

from __future__ import annotations

from typing import Optional


def get_ram_usage(format: str = "GB") -> float:
    """Resident memory of this process, via psutil or resource."""
    scale = {"B": 1, "KB": 1e3, "MB": 1e6, "GB": 1e9}[format]
    try:
        import psutil

        rss = psutil.Process().memory_info().rss
    except ImportError:
        import resource
        import sys

        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # ru_maxrss is KiB on Linux, bytes on macOS
        rss *= 1024 if sys.platform != "darwin" else 1
    return rss / scale


def get_device_memory_stats(device=None) -> Optional[dict]:
    """The card's caching-allocator statistics
    (``torch.cuda.memory_stats``: ``allocated_bytes.all.current``,
    ``reserved_bytes.all.peak``, ...) for ``device`` (default: the current
    CUDA device); None on the CPU or without CUDA."""
    import torch

    if device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            return None
    if not torch.cuda.is_available():
        return None
    return torch.cuda.memory_stats(device)
