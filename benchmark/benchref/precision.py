"""Frozen copy of ``busca_tpu_torch/models/precision.py`` at commit c2c24f5, part of the
benchmark's plain reference (it imports nothing of the program; edits
to the program do not reach it).  One addition: ``round_operands``, the benchmark's precision control.

Compute dtypes of the port's models: busca_tpu's ``dtype`` fields
(``BuscaConfig``, ``YoloxConfig``, ``TransCenterConfig``) read with flax's
rules on float32 parameters.

busca_tpu's bfloat16 mode is not "everything in bf16".  The parameters stay
float32 in storage (a checkpoint loads as float32, ``merge_params``), and
each flax layer casts as its own ``dtype`` says:

- ``nn.Conv(dtype=bf16)`` / ``nn.Dense(dtype=bf16)``: the input, the kernel
  and the bias are cast to bf16; the product is rounded to bf16, then the
  bias is added in bf16 (:class:`Conv2d`, :class:`Linear`, :func:`conv1x1`);
- ``nn.LayerNorm(dtype=bf16)``: statistics and affine in float32, the output
  rounded to bf16 (:class:`LayerNorm`);
- a layer without ``dtype`` on a bf16 input promotes it to its float32
  parameters (``busca_tpu/models/transformer.py:24-29``'s ``x @ w.T``).

In float32 every layer here is the stock torch layer, unchanged.  A bf16
product (convolution or matrix product) takes bf16 operands, accumulates in
float32 and rounds once to bf16, as XLA computes it.  On the card that is
cuDNN's and cuBLAS's bf16 kernels, with
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction =
False``, which the entry points set (never a module).  On the CPU, torch's
bf16 convolution returns wrong values at some shapes (torch 2.13: a 3x3/2
convolution of a seeded [6, 512, 4, 2] input lands up to 4.3 off results
of magnitude up to 2.9), so there the product runs in float32 on the bf16
operands' values and is rounded once: the same function.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` string ("float32" or
    "bfloat16"); anything else raises ``ValueError``."""
    if name not in DTYPES:
        raise ValueError(f"dtype must be 'float32' or 'bfloat16', not "
                         f"{name!r}")
    return DTYPES[name]


# The benchmark's control (``round_operands``): bf16 product operands
# rounded through a narrower type first, per tensor scaled to its range.
_ROUND_TO = None
FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


@contextlib.contextmanager
def round_operands(dtype):
    """Within the block, round every bf16 product's operands through
    ``dtype`` (``torch.float8_e4m3fn``), each tensor scaled so that its
    largest magnitude lands on the type's largest value."""
    global _ROUND_TO
    old, _ROUND_TO = _ROUND_TO, dtype
    try:
        yield
    finally:
        _ROUND_TO = old


def _rounded(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().max().to(torch.float32)
    s = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return ((t.to(torch.float32) / s).to(_ROUND_TO).to(torch.float32)
            * s).to(t.dtype)


def product(fn, x: torch.Tensor, w: torch.Tensor, *args) -> torch.Tensor:
    """``fn(x, w, *args)`` (``F.linear``, ``torch.matmul`` or a convolution)
    on operands of one dtype.  For bf16 operands: a float32 accumulator and
    one rounding to bf16; on the CPU computed on the operands' float32
    values (see the module docstring)."""
    if _ROUND_TO is not None and x.dtype != torch.float32:
        x, w = _rounded(x), _rounded(w)
    if x.dtype == torch.float32 or x.is_cuda:
        return fn(x, w, *args)
    return fn(x.to(torch.float32), w.to(torch.float32), *args).to(x.dtype)


class Linear(nn.Linear):
    """``nn.Dense(dtype=...)`` on float32 parameters."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt == torch.float32:
            return F.linear(x.to(dt), self.weight, self.bias)
        # flax promote_dtype: input, kernel, bias to bf16; y += bias in bf16
        y = product(F.linear, x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class Conv2d(nn.Conv2d):
    """``nn.Conv(dtype=...)`` on float32 parameters (NCHW).

    With ``cudnn`` set False a float32 convolution on the card runs through
    PyTorch's own path instead of cuDNN (:func:`gemm_conv2d`)."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype
        self.cudnn = True

    def forward(self, x):
        dt = self.compute_dtype
        if dt == torch.float32:
            if not self.cudnn and x.is_cuda:
                return gemm_conv2d(self, x.to(dt))
            return super().forward(x.to(dt))
        # flax promote_dtype: input, kernel, bias to bf16; y += bias in bf16
        y = product(lambda a, k: self._conv_forward(a, k, None), x.to(dt),
                    self.weight.to(dt))
        if self.bias is None:
            return y
        return y + self.bias.to(dt).reshape(1, -1, 1, 1)


def gemm_conv2d(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` through PyTorch's own convolution (im2col and a cuBLAS
    GEMM for each image of the batch), not cuDNN: ``torch._convolution``
    with ``cudnn_enabled=False``, so no global flag changes and other
    threads' convolutions keep cuDNN.  An image's output does not depend
    on the batch it is in, which cuDNN's algorithm choice does not promise
    (it picks by batch size)."""
    if conv.padding_mode != "zeros" or isinstance(conv.padding, str):
        raise ValueError("gemm_conv2d takes zero padding given as sizes")
    return torch._convolution(
        x, conv.weight, conv.bias, conv.stride, conv.padding, conv.dilation,
        False, (0, 0), conv.groups, False, False, False,
        torch.backends.cudnn.allow_tf32)


def conv1x1(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 :class:`Conv2d` on an NHWC tensor, as the matrix product it is,
    in the convolution's compute dtype."""
    dt = getattr(conv, "compute_dtype", torch.float32)
    w = conv.weight.flatten(1)
    if dt == torch.float32:
        return F.linear(x.to(dt), w, conv.bias)
    # nn.Conv(dtype=bf16): bf16 product, then the bias added in bf16
    y = product(F.linear, x.to(dt), w.to(dt))
    return y if conv.bias is None else y + conv.bias.to(dt)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm(dtype=...)``: statistics and affine in float32 on the
    input upcast, the output in ``dtype``."""

    def __init__(self, dim: int, eps: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x):
        y = F.layer_norm(x.to(torch.float32), self.normalized_shape,
                         self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)
