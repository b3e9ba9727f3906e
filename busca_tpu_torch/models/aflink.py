"""AFLink: appearance-free tracklet linking, StrongSORT's post-processing
link model (port of ``busca_tpu.models.aflink``, inference only).

The reference applies AFLink after StrongSORT (adapters/StrongSORT/
strong_sort.py:29-38: ``PostLinker`` model + ``AFLink`` linker with
thrT=(0, 30), thrS=75, thrP=0.05).  The published design (Du et al.,
StrongSORT, AFLink module):

- each tracklet contributes a 30-frame window of (frame, cx, cy) features;
- a temporal module of four (7x1) convolutions reduces the time axis, each
  followed by a LayerNorm over the channels and a ReLU; a (1x3) fusion
  convolution mixes the three feature channels;
- the two branches share weights; their pooled embeddings are concatenated
  into a 2-way same/different classifier.

Module names are the canonical torch layout that busca_tpu's
``convert_aflink_state_dict`` reads (``temporal.{i}.conv``,
``temporal.{i}.norm``, ``fusion``, ``fc1``, ``fc2``), so such a state dict
loads directly; :func:`~busca_tpu_torch.models.convert.
aflink_state_dict_from_flax` carries busca_tpu's flax parameters.  The
synthetic trainer of busca_tpu is not ported here (ROADMAP.md item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

SEG_LEN = 30  # the published AFLink temporal window
FEATURES = 3  # (frame, cx, cy)
LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon (torch's default is 1e-5)


class TemporalBlock(nn.Module):
    """(7x1) convolution over time (VALID, no bias), LayerNorm over the
    channels, ReLU.  Works on NHWC ``[B, T, 3, C]`` like the flax block."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, (7, 1), bias=False)
        self.norm = nn.LayerNorm(out_ch, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return torch.relu(self.norm(x))


class AFLinkModel(nn.Module):
    """Two shared-weight tracklet branches -> same/different logits."""

    def __init__(self, widths: Tuple[int, ...] = (32, 64, 128, 256)):
        super().__init__()
        chans = (1,) + tuple(widths)
        self.temporal = nn.ModuleList(
            [TemporalBlock(a, b) for a, b in zip(chans[:-1], chans[1:])])
        self.fusion = nn.Conv2d(widths[-1], widths[-1], (1, FEATURES))
        self.fc1 = nn.Linear(2 * widths[-1], widths[-1])
        self.fc2 = nn.Linear(widths[-1], 2)

    def _branch(self, seg: torch.Tensor) -> torch.Tensor:
        x = seg[..., None]  # [B, T, 3, 1]
        for blk in self.temporal:
            x = blk(x)
        x = torch.relu(self.fusion(x.permute(0, 3, 1, 2)))  # [B, C, T', 1]
        return x.mean(dim=(2, 3))  # [B, C]

    def forward(self, seg1: torch.Tensor, seg2: torch.Tensor) -> torch.Tensor:
        """``seg1``/``seg2``: ``[B, SEG_LEN, 3]`` normalized (frame, cx, cy)
        windows.  Returns ``[B, 2]`` logits (index 1 = same identity)."""
        h = torch.cat([self._branch(seg1), self._branch(seg2)], dim=-1)
        return self.fc2(torch.relu(self.fc1(h)))


@dataclasses.dataclass
class AFLinkConfig:
    widths: Tuple[int, ...] = (32, 64, 128, 256)
    # normalization scales: frames and pixels to O(1) inputs
    frame_scale: float = 30.0
    pos_scale: float = 1000.0


def normalize_segment(
    rows: np.ndarray, ref_frame: float, config: AFLinkConfig, tail: bool,
) -> np.ndarray:
    """MOT rows ``[N, >=6]`` (frame, id, x, y, w, h) -> ``[SEG_LEN, 3]``.

    Takes the last (``tail=True``) or first 30 rows, zero-pads at the far
    end, normalizes frame offsets by ``frame_scale`` and box centers by
    ``pos_scale`` relative to the link point.
    """
    rows = rows[-SEG_LEN:] if tail else rows[:SEG_LEN]
    seg = np.zeros((SEG_LEN, FEATURES), np.float32)
    f = (rows[:, 0] - ref_frame) / config.frame_scale
    cx = rows[:, 2] + rows[:, 4] / 2.0
    cy = rows[:, 3] + rows[:, 5] / 2.0
    ref_x = cx[-1] if tail else cx[0]
    ref_y = cy[-1] if tail else cy[0]
    feats = np.stack(
        [f, (cx - ref_x) / config.pos_scale, (cy - ref_y) / config.pos_scale],
        axis=1,
    ).astype(np.float32)
    if tail:
        seg[-len(rows):] = feats
    else:
        seg[: len(rows)] = feats
    return seg


def make_score_fn(model: AFLinkModel
                  ) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """``(seg1 [B,30,3], seg2 [B,30,3]) -> P(same) [B]`` as numpy, computed
    on the model's device."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def score(seg1, seg2):
        s1 = torch.as_tensor(np.asarray(seg1, np.float32)).to(device)
        s2 = torch.as_tensor(np.asarray(seg2, np.float32)).to(device)
        logits = model(s1, s2)
        return F.softmax(logits, dim=-1)[:, 1].cpu().numpy()

    return score
