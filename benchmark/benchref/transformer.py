"""Frozen copy of ``busca_tpu_torch/models/transformer.py`` at commit c2c24f5, part of the
benchmark's plain reference (it imports nothing of the program; edits
to the program do not reach it).  One change: the tensor-parallel paths raise (the reference runs on one
device).

Attention-exposing post-LN Transformer encoder (port of
``busca_tpu.models.transformer``).

The reference re-implements ``nn.TransformerEncoder{,Layer}`` so that
per-layer attention weights can be returned (busca/custom_layers.py:9-70).
Attention is written out as matmul + softmax, as the JAX module does, and
the parameters keep the reference torch names and layouts
(``self_attn.in_proj_weight [3d, d]``, ``self_attn.out_proj``,
``linear1``/``linear2``, ``norm1``/``norm2``), so reference state dicts load
with ``load_state_dict``.

Dropout sits at flax's four sites (the attention weights after the softmax,
the attention residual, the FF inner activation, the FF residual), at rate
``dropout``, and is active only in ``training`` mode.  Its keep masks are
drawn from the ``generator`` a forward is given, the counterpart of flax's
``rngs={"dropout": key}`` (:func:`dropout`).

``dtype`` (busca_tpu's ``TransformerEncoder(dtype=...)``) sets the
LayerNorms' output dtype only: the float32 linears promote a bf16 input to
float32, so in bfloat16 the products stay float32 and the LayerNorms round
their outputs to bf16 (``models/precision.py``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from benchref.precision import LayerNorm


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's ``nn.Dropout``: in training, keep each element with
    probability ``1 - rate`` (a uniform draw below it) and divide the kept
    ones by ``1 - rate``; otherwise the identity.  ``generator`` lies on
    ``x``'s device (``F.dropout`` takes none)."""
    if not training or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator,
                      device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def _promoted(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # busca_tpu/models/transformer.py:24-29: x @ w.T with float32 params
    # promotes a bf16 x to float32 (torch's matmul takes one dtype)
    return x.to(torch.promote_types(x.dtype, w.dtype))


class TorchLinear(nn.Linear):
    """busca_tpu's ``TorchLinear``: torch's ``[out, in]`` weight layout, and
    ``x @ w.T + b`` with jnp's type promotion of the input."""

    def forward(self, x):
        return super().forward(_promoted(x, self.weight))


def _row_parallel(linear: nn.Linear, x: torch.Tensor, group):
    """A row-parallel linear: this rank's input block times its block of
    the weight's input columns, summed over ``group``, then the whole
    bias."""
    raise NotImplementedError("the reference runs on one device")

    y = nn.functional.linear(_promoted(x, linear.weight), linear.weight)
    return reduce_from_group(y, group) + linear.bias


class MultiHeadSelfAttention(nn.Module):
    """torch ``nn.MultiheadAttention`` (self-attention, batch_first)
    numerics: packed qkv projection, ``1/sqrt(head_dim)`` scaling, per-head
    attention weights returned.

    ``tp``: None, or the tp ``ProcessGroup`` of a sharded model
    (``parallel/mesh.py::shard_model``): ``in_proj`` then holds this rank's
    heads' q, k and v rows, ``out_proj.weight`` their input columns, and
    the returned weights are this rank's heads'."""

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.0):
        super().__init__()
        self.d_model, self.nhead = d_model, nhead
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = TorchLinear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.tp = None

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        b, l, d = x.shape
        head_dim = d // self.nhead
        if self.tp is not None:
            raise NotImplementedError("the reference runs on one device")

            x = copy_to_group(x, self.tp)
        h = self.in_proj_weight.shape[0] // (3 * head_dim)  # local heads
        qkv = nn.functional.linear(_promoted(x, self.in_proj_weight),
                                   self.in_proj_weight, self.in_proj_bias)
        q, k, v = qkv.chunk(3, dim=-1)

        def split_heads(t):  # [B, L, d] -> [B, h, L, head_dim]
            return t.reshape(b, l, h, head_dim).transpose(1, 2)

        q, k, v = split_heads(q), split_heads(k), split_heads(v)
        scale = 1.0 / torch.sqrt(
            torch.tensor(head_dim, dtype=torch.float32, device=x.device)
        )
        logits = torch.matmul(q * scale, k.transpose(-1, -2))
        weights = torch.softmax(logits, dim=-1)  # [B, h, L, L]
        # the weights returned are the ones before dropout, as in flax
        ctx = torch.matmul(
            dropout(weights, self.dropout, self.training, generator), v)
        ctx = ctx.transpose(1, 2).reshape(b, l, h * head_dim)
        if self.tp is not None:
            return _row_parallel(self.out_proj, ctx, self.tp), weights
        return self.out_proj(ctx), weights


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder block (busca/custom_layers.py:30-41).  ``tp``: as
    :class:`MultiHeadSelfAttention`'s; ``linear1`` then holds this rank's
    rows (column parallel) and ``linear2.weight`` its columns (row
    parallel)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 activation: Optional[Callable] = None,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadSelfAttention(d_model, nhead, dropout)
        self.linear1 = TorchLinear(d_model, dim_feedforward)
        self.linear2 = TorchLinear(dim_feedforward, d_model)
        # nn.LayerNorm(dtype=bf16): float32 statistics, bf16 output
        self.norm1 = LayerNorm(d_model, 1e-5, dtype)
        self.norm2 = LayerNorm(d_model, 1e-5, dtype)
        self.activation = activation if activation is not None else gelu_exact
        self.tp = None

    def forward(self, src: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        def drop(t):
            return dropout(t, self.dropout, self.training, generator)

        attn_out, weights = self.self_attn(src, generator)
        # a bf16 src plus the float32 attention output is float32, as in jnp
        src = self.norm1(src + drop(attn_out))
        if self.tp is not None:
            raise NotImplementedError("the reference runs on one device")

            inner = self.linear1(copy_to_group(src, self.tp))
            ff = _row_parallel(self.linear2,
                               drop(self.activation(inner)), self.tp)
        else:
            ff = self.linear2(drop(self.activation(self.linear1(src))))
        src = self.norm2(src + drop(ff))
        return src, weights


class TransformerEncoder(nn.Module):
    """Stack of encoder layers, returning per-layer attention maps."""

    def __init__(self, num_layers: int, d_model: int, nhead: int,
                 dim_feedforward: int, activation: Optional[Callable] = None,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward,
                                    activation, dtype, dropout)
            for _ in range(num_layers)
        )

    def forward(self, src: torch.Tensor, return_att: bool = False,
                generator: Optional[torch.Generator] = None):
        weights = []
        out = src
        for layer in self.layers:
            out, w = layer(out, generator)
            weights.append(w)
        if return_att:
            return out, weights
        return out


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU (torch ``nn.GELU()`` default)."""
    return nn.functional.gelu(x)


ACTIVATIONS = {
    "relu": torch.relu,
    "gelu": gelu_exact,
    "tanh": torch.tanh,
    "silu": nn.functional.silu,
}


def get_activation(name: str) -> Callable:
    if name not in ACTIVATIONS:
        raise ValueError(
            f"activation should be one of {sorted(ACTIVATIONS)}, not {name!r}"
        )
    return ACTIVATIONS[name]
