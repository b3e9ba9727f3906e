"""Training: multi-choice cross-entropy over candidates (port of
``busca_tpu.train.trainer``).

The reference ships no training code (its weights were trained offline on
MOTSynth); the objective is the paper's multi-choice QA: softmax
cross-entropy of the decision logits against the correct candidate slot
(or NON/BAD).  The step differentiates the port's model with autograd (the
ResNet's convolutions on cuDNN on the card, the masked batch-stat BN as
torch ops) and updates it with :class:`AdamW`, which computes optax's
``adamw`` (optionally behind ``clip_by_global_norm`` and with a warmup +
cosine schedule) step for step.  Dropout's masks come from a generator per
step, the counterpart of JAX's per-step ``rng``; :func:`step_generator`
derives it from ``(seed, step)``, so a resumed run draws the same masks.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from busca_tpu_torch.models.busca import BuscaConfig, BuscaModel

# optax's ``scale_by_adam`` defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def warmup_cosine(count: int, peak: float, warmup_steps: int,
                  decay_steps: int) -> float:
    """optax's ``warmup_cosine_decay_schedule(0, peak, warmup_steps,
    decay_steps)`` at update ``count`` (0 at the first update)."""
    if count < warmup_steps:  # linear_schedule(0, peak, warmup_steps)
        return (0.0 - peak) * (1.0 - count / warmup_steps) + peak
    span = decay_steps - warmup_steps
    t = min(count - warmup_steps, span)
    return peak * (0.5 * (1.0 + math.cos(math.pi * t / span)))


class AdamW(torch.optim.Optimizer):
    """optax's ``adamw`` (``scale_by_adam``, ``add_decayed_weights``,
    ``scale_by_learning_rate``), optionally after
    ``clip_by_global_norm(grad_clip)`` and with the learning rate of
    :func:`warmup_cosine` when ``total_steps`` is set.  Where it differs
    from ``torch.optim.AdamW``: the weight decay is added to the Adam
    direction and then scaled by the learning rate (decoupled, not
    multiplied into the parameter first), the clip is
    ``where(norm < max, g, g / norm * max)`` over the raw gradients before
    the moments, and a parameter without a gradient takes a zero one (its
    moments decay and its weight decays, as under ``jax.grad``).

    The state is ``mu`` and ``nu`` per parameter and the update count
    ``count`` in the parameter group, so ``state_dict`` holds tensors and
    plain numbers only.
    """

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 learning_rate: float = 1e-4, weight_decay: float = 1e-4,
                 grad_clip: Optional[float] = None,
                 warmup_steps: int = 0, total_steps: Optional[int] = None):
        defaults = dict(lr=learning_rate, weight_decay=weight_decay,
                        grad_clip=grad_clip,
                        warmup_steps=max(warmup_steps, 1),
                        total_steps=(None if total_steps is None else
                                     max(total_steps, warmup_steps + 1)),
                        count=0)
        super().__init__(params, defaults)

    def learning_rate(self, group: dict) -> float:
        """The learning rate of the group's next update."""
        if group["total_steps"] is None:
            return group["lr"]
        return warmup_cosine(group["count"], group["lr"],
                             group["warmup_steps"], group["total_steps"])

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        for group in self.param_groups:
            params = group["params"]
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            clip = group["grad_clip"]
            if clip:
                norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                keep = norm < clip
                grads = [torch.where(keep, g, g / norm * clip) for g in grads]
            b1, b2, eps = ADAM_B1, ADAM_B2, ADAM_EPS
            count = group["count"] + 1
            # the bias corrections in float64 on the host; optax takes them
            # in float32 unless JAX runs in 64 bits: one rounding apart
            c1 = 1.0 - b1 ** count
            c2 = 1.0 - b2 ** count
            step_size = -self.learning_rate(group)
            wd = group["weight_decay"]
            for p, g in zip(params, grads):
                state = self.state[p]
                if not state:
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                mu = state["mu"].mul_(b1).add_((1.0 - b1) * g)
                nu = state["nu"].mul_(b2).add_((1.0 - b2) * (g * g))
                u = (mu / c1) / (torch.sqrt(nu / c2) + eps)
                if wd:
                    u = u + wd * p
                p.add_(step_size * u)
            group["count"] = count


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   learning_rate: float = 1e-4, weight_decay: float = 1e-4,
                   warmup_steps: int = 0, total_steps: Optional[int] = None,
                   grad_clip: Optional[float] = 1.0) -> AdamW:
    """AdamW, optionally with linear warmup + cosine decay and global-norm
    gradient clipping: busca_tpu's ``make_optimizer`` on ``params``."""
    return AdamW(params, learning_rate, weight_decay, grad_clip=grad_clip,
                 warmup_steps=warmup_steps, total_steps=total_steps)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout generator of training step ``step`` of a run seeded
    with ``seed``, on ``device``: the same masks on every run and resume."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(np.random.SeedSequence([seed, step])
                      .generate_state(1, np.uint64)[0] >> 1))
    return g


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]):
    if mask is None:
        return x.mean()
    # padded lanes are out of the ReID BN statistics through the same mask;
    # they are out of the loss and the accuracy too
    m = mask.to(torch.float32)
    return (x * m).sum() / torch.clamp(m.sum(), min=1.0)


def _forward(model: BuscaModel, batch: dict, generator):
    """``batch`` on the model's device, its logits and labels, and the
    masked-mean cross-entropy loss."""
    device = next(model.parameters()).device
    b = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    logits = model(b["mem_crops"], b["can_crops"], b["mem_boxes"],
                   b["can_boxes"], b.get("mask"), generator=generator)
    labels = b["labels"].long()
    loss = _masked_mean(F.cross_entropy(logits, labels, reduction="none"),
                        b.get("mask"))
    return b, logits, labels, loss


def loss_fn(model: BuscaModel, batch: dict,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Softmax cross-entropy of the logits against the integer labels, the
    masked mean over the batch (denominator ``max(mask.sum(), 1)``).  Runs
    the model as it stands: dropout only in training mode."""
    return _forward(model, batch, generator)[3]


def make_train_step(model: BuscaModel, optimizer: torch.optim.Optimizer):
    """``step(batch, generator=None) -> {"loss", "accuracy"}``: one update
    of ``model``'s parameters on ``batch`` (numpy arrays or tensors;
    ``mask`` optional), dropout on, masks drawn from ``generator`` (on the
    model's device).  The metrics are device tensors of the batch before
    the update; reading them is the caller's sync."""

    def step(batch: dict, generator: Optional[torch.Generator] = None):
        model.train()
        b, logits, labels, loss = _forward(model, batch, generator)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            acc = _masked_mean((logits.argmax(-1) == labels).to(
                torch.float32), b.get("mask"))
        return {"loss": loss.detach(), "accuracy": acc}

    return step


def train_smoke(steps: int = 3, batch: int = 8,
                config: Optional[BuscaConfig] = None, spec=None,
                seed: int = 0, device="cuda"):
    """A short training run on synthetic episodes.  Returns the model and
    the last step's metrics as floats."""
    from busca_tpu_torch.train.data import EpisodeSpec, synthetic_batch
    from busca_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    config = config or BuscaConfig(num_layer=2, reid_num_classes=7,
                                   reid_layers=(1, 1, 1, 1))
    spec = spec or EpisodeSpec(batch=batch, seq_len=3, num_candidates=2,
                               crop_hw=(64, 32))
    rng = np.random.RandomState(seed)
    synthetic_batch(rng, spec)  # busca_tpu initializes on this batch
    model = BuscaModel(config).to(device)
    model.init_weights(torch.Generator().manual_seed(seed))
    step = make_train_step(model, make_optimizer(model.parameters()))
    metrics = None
    for i in range(steps):
        metrics = step(synthetic_batch(rng, spec),
                       step_generator(seed, i, device))
    return model, {k: float(v) for k, v in metrics.items()}
