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
Inference only: no dropout.

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
    get_activation,
)


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
            get_activation(cfg.activation), dtype,
        )
        self.decoder = nn.Sequential(nn.LayerNorm(d_model, eps=1e-5),
                                     TorchLinear(d_model, 1))

    def init_weights(self, generator: torch.Generator):
        """Seeded random weights: lecun-normal matrices and convolutions,
        xavier-uniform qkv projections, N(0, 1) special tokens, zero biases,
        unit norm scales.  ``generator`` is a CPU ``torch.Generator``."""
        with torch.no_grad():
            for name, p in self.named_parameters():
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
        return self

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
    ):
        """Score candidates for a batch of tracks.

        Args:
          mem_crops: ``[B, L_mem, H, W, 3]`` normalized RGB memory crops.
          can_crops: ``[B, C, H, W, 3]`` normalized RGB candidate crops, or
            in deduplicated mode ``[U, H, W, 3]`` unique candidate crops.
          mem_bboxes: ``[B, L_mem, 4]`` ltrb boxes.
          can_bboxes: ``[B, C, 4]`` ltrb candidate boxes.
          sample_mask: ``[B]`` 1 for real tracks, 0 for padded lanes.
          return_att: also return per-layer attention maps.
          can_weights / can_gather: deduplicated-candidate mode: the unique
            crops' occurrence counts ``[U]`` (the BN weights, so statistics
            equal the duplicated batch's) and the per-slot index map
            ``[B, C]``.

        Returns:
          logits ``[B, C + extras]`` (and the attention list).
        """
        cfg = self.config
        b, l_mem = mem_bboxes.shape[0], mem_bboxes.shape[1]
        c = can_bboxes.shape[1]
        d_model = cfg.trans_dim
        dev = mem_bboxes.device

        # ONE ReID pass over memory + candidate crops; the [N, 2] group
        # weights (group 0 = memory, group 1 = candidates, zero rows =
        # padded lanes) keep the reference's per-group BN statistics
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
        group_mask = torch.zeros(flat.shape[0], 2, device=dev)
        group_mask[:n_mem, 0] = w_mem
        group_mask[n_mem:, 1] = w_can
        _, feats = self.reid_encoder.model(flat, group_mask)
        mem_feats = feats[:n_mem].reshape(b, l_mem, -1)
        if can_gather is not None:
            can_feats = feats[n_mem:][can_gather.long()]  # [B, C, F]
        else:
            can_feats = feats[n_mem:].reshape(b, c, -1)

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
        out = self.transformer_encoder(x, return_att=return_att)
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
