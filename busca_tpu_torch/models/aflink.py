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
aflink_state_dict_from_flax` carries busca_tpu's flax parameters.

The upstream weights are a release download the reference does not vendor,
so, as busca_tpu does, the module trains the link model on synthetic
continuity data (:func:`train_aflink_synthetic`): same-identity pairs cut
from continuous noisy trajectories, negatives from different ones, with
optax's ``adam`` (:class:`~busca_tpu_torch.train.trainer.AdamW` without
weight decay).  The episodes equal busca_tpu's for the same
``RandomState``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

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


# ---------------------------------------------------------------------------
# synthetic training (the upstream weights are not distributable)
# ---------------------------------------------------------------------------

def _synthetic_pair(rng, config: AFLinkConfig, positive: bool):
    """One (tail segment, head segment, label) from synthetic trajectories."""
    n1 = rng.randint(8, SEG_LEN + 1)
    n2 = rng.randint(8, SEG_LEN + 1)
    gap = rng.randint(1, 25)

    def traj(x0, y0, vx, vy, f0, n):
        f = f0 + np.arange(n)
        x = x0 + vx * np.arange(n) + rng.randn(n) * 2.0
        y = y0 + vy * np.arange(n) + rng.randn(n) * 2.0
        w = np.full(n, 40.0)
        h = np.full(n, 90.0)
        return np.stack([f, np.zeros(n), x - w / 2, y - h / 2, w, h], axis=1)

    x0, y0 = rng.uniform(100, 900, 2)
    vx, vy = rng.uniform(-4, 4, 2)
    t1 = traj(x0, y0, vx, vy, 0, n1)
    if positive:
        # continuation of the same motion after the gap
        t2 = traj(x0 + vx * (n1 + gap), y0 + vy * (n1 + gap), vx, vy,
                  n1 + gap, n2)
    else:
        kind = rng.randint(3)
        if kind == 0:  # different place
            bx, by = rng.uniform(100, 900, 2)
            while abs(bx - (x0 + vx * (n1 + gap))) < 120:
                bx = rng.uniform(100, 900)
            t2 = traj(bx, by, *rng.uniform(-4, 4, 2), n1 + gap, n2)
        elif kind == 1:  # same place, inconsistent motion
            t2 = traj(x0 + vx * (n1 + gap) + rng.choice([-1, 1]) * 60,
                      y0 + vy * (n1 + gap) + rng.choice([-1, 1]) * 60,
                      -vx, -vy, n1 + gap, n2)
        else:  # overlapping in time (cannot be the same identity)
            t2 = traj(x0 + 80, y0 + 80, vx, vy, max(n1 - 4, 0), n2)
    ref = t1[-1, 0] + 1
    seg1 = normalize_segment(t1, ref, config, tail=True)
    seg2 = normalize_segment(t2, ref, config, tail=False)
    return seg1, seg2, int(positive)


def synthetic_batch(rng, batch: int, config: AFLinkConfig):
    """``batch`` pairs, alternating positive and negative: ``(seg1 [B, 30,
    3], seg2 [B, 30, 3], labels [B] int32)``."""
    s1, s2, y = [], [], []
    for i in range(batch):
        a, b, label = _synthetic_pair(rng, config, positive=i % 2 == 0)
        s1.append(a)
        s2.append(b)
        y.append(label)
    return np.stack(s1), np.stack(s2), np.asarray(y, np.int32)


def train_aflink_synthetic(steps: int = 300, batch: int = 64, seed: int = 0,
                           config: Optional[AFLinkConfig] = None,
                           learning_rate: float = 1e-3, device="cuda"):
    """Train AFLink on synthetic continuity data on ``device``; returns
    ``(model, final accuracy)``.  Seeded weights (lecun-normal kernels, zero
    biases, unit norm scales, as flax initializes them) from a
    ``torch.Generator`` of ``seed``; the batches from
    ``np.random.RandomState(seed)``."""
    from busca_tpu_torch.models.busca import seeded_init
    from busca_tpu_torch.train.trainer import AdamW
    from busca_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    config = config or AFLinkConfig()
    rng = np.random.RandomState(seed)
    synthetic_batch(rng, batch, config)  # busca_tpu initializes on this
    model = AFLinkModel(config.widths)
    seeded_init(model, torch.Generator().manual_seed(seed))
    model.to(device)
    optimizer = AdamW(model.parameters(), learning_rate, weight_decay=0.0)
    acc = 0.0
    for _ in range(steps):
        s1, s2, y = (torch.as_tensor(a).to(device)
                     for a in synthetic_batch(rng, batch, config))
        logits = model(s1, s2)
        labels = y.long()
        loss = F.cross_entropy(logits, labels)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
    model.eval()
    return model, float(acc)
