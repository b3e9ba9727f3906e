"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    absent (callers that want the CPU say so with ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def set_card_precision():
    """The entry points' numerics on the card: float32 products in full
    float32 (TF32 off, for matrix products and cuDNN convolutions alike),
    and bf16 products reduced in float32, as XLA accumulates them
    (``allow_bf16_reduced_precision_reduction`` off).  Process-wide flags:
    ``chip_smoke.py`` and the CLI set them, no module does."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
