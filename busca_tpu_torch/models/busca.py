"""The BUSCA decision model: multi-choice QA over track memory vs candidates
(port of ``busca_tpu.models.busca``, reference busca/network.py:11-507).

Given a batch of unmatched tracks, each with a memory of appearance crops +
boxes and candidate crops + boxes (nearest detections plus the track's
Kalman prediction), it returns logits over the candidates plus NON ("none of
the above") and BAD ("corrupt memory").

Numerics kept from the reference: one grouped ReID pass whose BatchNorm
normalizes memory and candidate crops with separate batch statistics
(network.py:192-193) and excludes padded lanes; the shared ``encoder``
linear scaled by ``sqrt(d_model)``; special tokens appended after the
encoder; closed-form 3-D positional encodings; the post-LN Transformer; the
LayerNorm + Linear decoder over the CAN positions.  Module names are the
reference's (``reid_encoder.model``, ``encoder``, ``transformer_encoder``,
``decoder.0/1``), so ``model_busca.pth`` loads with ``load_state_dict``.

Dropout (``dropout_p``) sits where flax puts it: on the Transformer's input
and at the Transformer's four sites.  It is active only in ``training``
mode; a new model starts in eval mode, as flax's forward defaults to
``deterministic=True``.  The keep masks come from the ``generator`` given to
``forward`` (busca_tpu's ``rngs={"dropout": key}``).  The forward is
autograd-clean, so the train step (``train/trainer.py``) differentiates it.

``BuscaConfig.dtype`` ("float32" or "bfloat16"; both CLIs default to
bfloat16, busca_tpu's production mode) is the ReID's and the Transformer's
compute dtype, with flax's
rules on float32 parameters (``models/precision.py``); the encoder linear,
the positional encodings and the decoder have none, so the logits are
float32 in both modes (busca_tpu/models/busca.py:271, 325-348).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from busca_tpu_torch.models import encodings
from busca_tpu_torch.models.precision import compute_dtype
from busca_tpu_torch.models.reid import ReIDResNet
from busca_tpu_torch.models.transformer import (
    TorchLinear,
    TransformerEncoder,
    dropout,
    get_activation,
)
from busca_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class BuscaConfig:
    """Transformer-section config (mirrors config/*/*/*.yml keys)."""

    num_layer: int = 4
    nhead: int = 4
    dim_embedding: int = 512
    trans_dim: int = 512
    ff_size: int = 1024
    activation: str = "gelu"
    dropout_p: float = 0.1
    input_flavour: str = "MEM-SEP-CAN-BAD"
    output_flavour: str = "CAN"
    encode_separator_as_reference: bool = True
    encode_special_tokens: bool = False
    reid_num_classes: int = 299
    # ResNet stage depths: (3, 4, 6, 3) = ResNet-50 (the shipped weights)
    reid_layers: Tuple[int, int, int, int] = (3, 4, 6, 3)
    # True = GHOST batch-stat BN (the reference semantics); False = stored
    # running statistics
    reid_use_batch_stats: bool = True
    quantize_pe_fp16: bool = True
    dtype: str = "float32"

    @classmethod
    def from_dict(cls, d: dict) -> "BuscaConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        if "reid_layers" in kw:
            kw["reid_layers"] = tuple(kw["reid_layers"])
        return cls(**kw)

    @property
    def has_bad(self) -> bool:
        return "BAD" in self.input_flavour

    @property
    def has_cls(self) -> bool:
        return self.input_flavour.startswith("CLS-")

    @property
    def num_extra_candidates(self) -> int:
        """NON (+ BAD) choices appended after the real candidate slots."""
        return 2 if self.has_bad else 1


def can_token_positions(mem_len: int, num_candidate_groups: int,
                        flavour: str) -> Tuple[int, ...]:
    """Sequence positions of the CAN tokens (busca/network.py:138-160)."""
    start = mem_len + (1 if flavour.startswith("CLS-") else 0)
    if "MEM-SEP-CAN" in flavour:
        return tuple(start + i
                     for i in range(1, num_candidate_groups * 2 + 1, 2))
    if "MEM-CAN-SEP" in flavour:
        return tuple(start + i for i in range(0, num_candidate_groups * 2, 2))
    raise NotImplementedError(f"input flavour {flavour!r} not supported")


class _ReIDEncoder(nn.Module):
    """Holder that gives the ReID net the reference's key prefix
    ``reid_encoder.model.``."""

    def __init__(self, model: ReIDResNet):
        super().__init__()
        self.model = model


def seeded_init(module: nn.Module, generator: torch.Generator):
    """Seeded random weights: lecun-normal matrices and convolutions,
    xavier-uniform qkv projections, N(0, 1) special tokens, zero biases,
    unit norm scales.  ``generator`` is a CPU ``torch.Generator``."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name.endswith("_token"):
                val = torch.randn(p.shape, generator=generator)
            elif leaf == "in_proj_weight":
                bound = float(np.sqrt(6.0 / (p.shape[0] + p.shape[1])))
                val = (torch.rand(p.shape, generator=generator) * 2 - 1) \
                    * bound
            elif p.dim() >= 2:
                fan_in = int(np.prod(p.shape[1:]))
                val = torch.randn(p.shape, generator=generator) \
                    / float(np.sqrt(fan_in))
            elif leaf == "weight":
                val = torch.ones(p.shape)
            else:
                val = torch.zeros(p.shape)
            p.copy_(val.to(p.device))
    return module


class BuscaModel(nn.Module):
    """The decision Transformer + ReID encoder."""

    def __init__(self, config: BuscaConfig = BuscaConfig()):
        super().__init__()
        self.config = cfg = config
        dtype = compute_dtype(cfg.dtype)
        d_model = cfg.trans_dim
        self.reid_encoder = _ReIDEncoder(ReIDResNet(
            layers=cfg.reid_layers, num_classes=cfg.reid_num_classes,
            use_batch_stats=cfg.reid_use_batch_stats, dtype=dtype,
        ))
        self.encoder = TorchLinear(cfg.dim_embedding, d_model)
        tok = cfg.dim_embedding if cfg.encode_special_tokens else d_model
        self.non_token = nn.Parameter(torch.zeros(tok))
        self.sep_token = nn.Parameter(torch.zeros(tok))
        self.bad_token = nn.Parameter(torch.zeros(tok)) if cfg.has_bad \
            else None
        self.cls_token = nn.Parameter(torch.zeros(tok)) if cfg.has_cls \
            else None
        self.transformer_encoder = TransformerEncoder(
            cfg.num_layer, d_model, cfg.nhead, cfg.ff_size,
            get_activation(cfg.activation), dtype, cfg.dropout_p,
        )
        self.decoder = nn.Sequential(nn.LayerNorm(d_model, eps=1e-5),
                                     TorchLinear(d_model, 1))
        self.eval()

    def init_weights(self, generator: torch.Generator):
        """Seeded random weights (:func:`seeded_init`)."""
        return seeded_init(self, generator)

    def forward(
        self,
        mem_crops: torch.Tensor,
        can_crops: torch.Tensor,
        mem_bboxes: torch.Tensor,
        can_bboxes: torch.Tensor,
        sample_mask: Optional[torch.Tensor] = None,
        return_att: bool = False,
        can_weights: Optional[torch.Tensor] = None,
        can_gather: Optional[torch.Tensor] = None,
        mem_group: Optional[torch.Tensor] = None,
        can_group: Optional[torch.Tensor] = None,
        num_groups: int = 1,
        generator: Optional[torch.Generator] = None,
        mem_feats: Optional[torch.Tensor] = None,
        can_feats: Optional[torch.Tensor] = None,
    ):
        """Score candidates for a batch of tracks.

        Args:
          mem_crops: ``[B, L_mem, H, W, 3]`` normalized RGB memory crops
            (None with ``mem_feats``).
          can_crops: ``[B, C, H, W, 3]`` normalized RGB candidate crops, or
            in deduplicated mode ``[U, H, W, 3]`` unique candidate crops
            (None with ``can_feats``).
          mem_bboxes: ``[B, L_mem, 4]`` ltrb boxes.
          can_bboxes: ``[B, C, 4]`` ltrb candidate boxes.
          sample_mask: ``[B]`` 1 for real tracks, 0 for padded lanes.
          return_att: also return per-layer attention maps.
          can_weights / can_gather: deduplicated-candidate mode: the unique
            crops' occurrence counts ``[U]`` (the BN weights, so statistics
            equal the duplicated batch's) and the per-slot index map
            ``[B, C]``.
          mem_group / can_group / num_groups: several independent
            association calls (one per lockstep sequence) in one forward:
            ``mem_group [B]`` and ``can_group [U or B]`` give each track and
            candidate crop its request r < ``num_groups``; BN statistics are
            per (request, memory|candidate) group, so each request's numbers
            equal its own call's.  ``can_group`` defaults to ``mem_group``
            without a gather.
          generator: the dropout masks' generator, on the model's device
            (used only in training mode).
          mem_feats / can_feats: precomputed ReID features instead of crops
            (``[B, L_mem, F]``, and ``[U, F]`` with ``can_gather`` or
            ``[B, C, F]`` without): the ReID stage is skipped.  Meaningful
            with frozen BN statistics, where a crop's feature does not
            depend on its batch (the engine's ``reid_stats='frozen'``).
            Both or neither.

        Returns:
          logits ``[B, C + extras]`` (and the attention list).
        """
        b, l_mem = mem_bboxes.shape[0], mem_bboxes.shape[1]
        c = can_bboxes.shape[1]
        if (mem_feats is None) != (can_feats is None):
            raise ValueError("mem_feats and can_feats must be given together")
        if mem_feats is not None:
            # busca_tpu/models/busca.py:188-194: the unique candidate
            # features expanded per slot
            if can_gather is not None:
                can_feats = can_feats[can_gather.long()]
        else:
            with profiling.span("assoc.encode", device=mem_bboxes):
                mem_feats, can_feats = self._reid_feats(
                    mem_crops, can_crops, b, l_mem, c, sample_mask,
                    can_weights, can_gather, mem_group, can_group,
                    num_groups)
        with profiling.span("assoc.decide", device=mem_bboxes):
            return self._decide(mem_feats, can_feats, mem_bboxes,
                                can_bboxes, return_att, generator)

    def _reid_feats(self, mem_crops, can_crops, b, l_mem, c, sample_mask,
                    can_weights, can_gather, mem_group, can_group,
                    num_groups):
        """The features ``([B, L_mem, F], [B, C, F])`` of ONE ReID pass over
        memory + candidate crops; the [N, 2 * groups] weights (column r =
        request r's memory, column groups + r its candidates, zero rows =
        padded lanes) keep the reference's per-group BN statistics
        (busca_tpu/models/busca.py:240-264)."""
        dev = mem_crops.device
        n_mem = b * l_mem
        if can_gather is not None:
            can_flat = can_crops
            w_can = can_weights.to(torch.float32)
        else:
            can_flat = can_crops.reshape((b * c,) + can_crops.shape[2:])
            w_can = (sample_mask.to(torch.float32).repeat_interleave(c)
                     if sample_mask is not None
                     else torch.ones(b * c, device=dev))
        w_mem = (sample_mask.to(torch.float32).repeat_interleave(l_mem)
                 if sample_mask is not None
                 else torch.ones(n_mem, device=dev))
        flat = torch.cat(
            [mem_crops.reshape((n_mem,) + mem_crops.shape[2:]), can_flat],
            dim=0,
        )
        r = int(num_groups)
        mem_cols = (torch.zeros(n_mem, dtype=torch.long, device=dev)
                    if mem_group is None
                    else mem_group.long().repeat_interleave(l_mem))
        if can_group is not None:
            can_src = can_group.long()
        elif mem_group is not None and can_gather is None:
            can_src = mem_group.long()
        else:
            can_src = torch.zeros(can_flat.shape[0], dtype=torch.long,
                                  device=dev)
        can_cols = (can_src.repeat_interleave(c)
                    if can_gather is None and can_src.shape[0] == b
                    else can_src)
        group_mask = torch.zeros(flat.shape[0], 2 * r, device=dev)
        group_mask[torch.arange(n_mem, device=dev), mem_cols] = w_mem
        group_mask[torch.arange(n_mem, flat.shape[0], device=dev),
                   can_cols + r] = w_can
        _, feats = self.reid_encoder.model(flat, group_mask)
        mem_feats = feats[:n_mem].reshape(b, l_mem, -1)
        if can_gather is not None:
            can_feats = feats[n_mem:][can_gather.long()]  # [B, C, F]
        else:
            can_feats = feats[n_mem:].reshape(b, c, -1)
        return mem_feats, can_feats

    def _decide(self, mem_feats, can_feats, mem_bboxes, can_bboxes,
                return_att, generator):
        """The decision Transformer from the ReID features: logits ``[B, C
        + extras]`` (and the attention list)."""
        cfg = self.config
        b, l_mem = mem_bboxes.shape[0], mem_bboxes.shape[1]
        c = can_bboxes.shape[1]
        d_model = cfg.trans_dim
        dev = mem_bboxes.device
        scale = torch.sqrt(torch.tensor(float(d_model), device=dev))
        mem_emb = self.encoder(mem_feats) * scale
        can_emb = self.encoder(can_feats) * scale

        def tile(tok):
            return tok.expand(b, 1, d_model)

        if cfg.has_cls:
            mem_emb = torch.cat([tile(self.cls_token), mem_emb], dim=1)

        cand_groups = [can_emb[:, i:i + 1, :] for i in range(c)]
        cand_groups.append(tile(self.non_token))
        if cfg.has_bad:
            cand_groups.append(tile(self.bad_token))
        sep = tile(self.sep_token)
        interleaved = []
        for g in cand_groups:
            if "MEM-SEP-CAN" in cfg.input_flavour:
                interleaved.extend([sep, g])
            else:  # MEM-CAN-SEP
                interleaved.extend([g, sep])
        can_seq = torch.cat(interleaved, dim=1)

        mem_pe, can_pe = encodings.positional_encodings(
            mem_bboxes, can_bboxes, d_model, cfg.input_flavour,
            cfg.encode_separator_as_reference, cfg.quantize_pe_fp16,
        )
        x = torch.cat([mem_emb + mem_pe, can_seq + can_pe], dim=1)
        x = dropout(x, cfg.dropout_p, self.training, generator)
        out = self.transformer_encoder(x, return_att=return_att,
                                       generator=generator)
        if return_att:
            out, attentions = out

        positions = can_token_positions(
            l_mem, c + cfg.num_extra_candidates, cfg.input_flavour
        )
        # busca.py:344-345: decoder_norm and decoder_linear carry no dtype,
        # so a bf16 Transformer output is promoted to their float32 params
        can_out = out[:, list(positions), :].to(torch.float32)
        logits = self.decoder(can_out)[..., 0]
        if return_att:
            return logits, attentions
        return logits


# Crop normalization constants (GHOST pipeline, BGR order).  Note the 0.299
# blue std (not ImageNet's 0.229), which the weights were trained with
# (busca/tracking.py:64-65, network.py:470-478).
INPUT_PIXEL_MEAN_BGR = np.array([0.406, 0.456, 0.485], dtype=np.float32)
INPUT_PIXEL_STD_BGR = np.array([0.225, 0.224, 0.299], dtype=np.float32)
INPUT_PIXEL_MEAN_RGB = INPUT_PIXEL_MEAN_BGR[::-1].copy()
INPUT_PIXEL_STD_RGB = INPUT_PIXEL_STD_BGR[::-1].copy()
