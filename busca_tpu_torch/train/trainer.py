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

:func:`make_sharded_train_step` runs the step over a (dp, tp) mesh of
``torch.distributed`` ranks (``parallel/mesh.py``): the batch split over
dp, the Transformer and the ReID split over tp, the BN statistics, the
masked-mean loss and the gradients summed over dp, the clip's norm over
tp.  Each rank draws dropout masks for its own part, so a sharded step
equals the unsharded one at dropout 0.
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
                norm = self._global_norm(params, grads)
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

    def _global_norm(self, params, grads) -> torch.Tensor:
        """The global norm of ``grads`` for the clip."""
        return torch.sqrt(sum(torch.sum(g * g) for g in grads))


class ShardedAdamW(AdamW):
    """:class:`AdamW` over the local parameters of a model sharded over tp
    (``parallel/mesh.py::shard_model``): the clip's global norm sums the
    squares of the ``split`` parameters' gradients over ``tp_group`` and
    counts every whole (replicated) one once, in the parameters' order, so
    a tp of 1 rounds as :class:`AdamW` does.  The update is elementwise and
    needs no collective."""

    def __init__(self, params, split=(), tp_group=None, **kw):
        super().__init__(params, **kw)
        self._split = {id(p) for p in split}
        self._tp_group = tp_group

    def _global_norm(self, params, grads) -> torch.Tensor:
        import torch.distributed as dist

        sq = [torch.sum(g * g) for g in grads]
        idx = [i for i, p in enumerate(params) if id(p) in self._split]
        if self._tp_group is not None and idx:
            parts = torch.stack([sq[i] for i in idx])
            dist.all_reduce(parts, group=self._tp_group)
            for j, i in enumerate(idx):
                sq[i] = parts[j]
        return torch.sqrt(sum(sq))


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


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor], group=None):
    """The masked mean of ``x`` (denominator ``max(mask.sum(), 1)``); with
    a dp ``group``, this rank's share of the mean over the global batch
    (its numerator over the summed denominator): the shares sum to it."""
    if mask is None:
        if group is None:
            return x.mean()
        m = None
        den = torch.full((), float(x.numel()), device=x.device)
    else:
        # padded lanes are out of the ReID BN statistics through the same
        # mask; they are out of the loss and the accuracy too
        m = mask.to(torch.float32)
        den = m.sum()
    if group is not None:
        import torch.distributed as dist

        den = den.detach().clone()
        dist.all_reduce(den, group=group)
    num = x.sum() if m is None else (x * m).sum()
    return num / torch.clamp(den, min=1.0)


def _forward(model: BuscaModel, batch: dict, generator, group=None):
    """``batch`` on the model's device, its logits and labels, and the
    masked-mean cross-entropy loss (this rank's share with a dp
    ``group``)."""
    device = next(model.parameters()).device
    b = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    logits = model(b["mem_crops"], b["can_crops"], b["mem_boxes"],
                   b["can_boxes"], b.get("mask"), generator=generator)
    labels = b["labels"].long()
    loss = _masked_mean(F.cross_entropy(logits, labels, reduction="none"),
                        b.get("mask"), group)
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


def make_sharded_train_step(model: BuscaModel, mesh):
    """The train step over a (dp, tp) mesh (busca_tpu's
    ``make_sharded_train_step``; ``parallel/mesh.py``).  ``model`` is
    sharded in place (:func:`~busca_tpu_torch.parallel.mesh.shard_model`:
    this rank's tp shards, BN statistics summed over dp) and a
    :class:`ShardedAdamW` with :func:`make_optimizer`'s defaults (lr 1e-4,
    weight decay 1e-4, clip 1.0) is built on its local parameters.
    Returns ``(step, optimizer)``; ``step(batch, generator=None)`` takes
    the global batch, as every rank's copy of it, runs this rank's dp slice
    (the batch must split evenly), sums the gradients over dp and updates;
    its metrics are the global batch's, the same on every rank."""
    import torch.distributed as dist

    from busca_tpu_torch.parallel import mesh as meshlib

    specs = meshlib.shard_model(model, mesh)
    tp = meshlib.axis_size(mesh, "tp")
    split = [p for name, p in model.named_parameters()
             if tp > 1 and "tp" in specs[name]]
    optimizer = ShardedAdamW(model.parameters(), split,
                             mesh.get_group("tp") if tp > 1 else None,
                             learning_rate=1e-4, weight_decay=1e-4,
                             grad_clip=1.0)
    dp_group = mesh.get_group("dp")

    def step(batch: dict, generator: Optional[torch.Generator] = None):
        model.train()
        local = {k: meshlib.batch_sharding(mesh, torch.as_tensor(v))
                 for k, v in batch.items()}
        b, logits, labels, loss = _forward(model, local, generator,
                                           dp_group)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        flat = torch._utils._flatten_dense_tensors(grads)
        dist.all_reduce(flat, group=dp_group)
        for g, summed in zip(grads, torch._utils._unflatten_dense_tensors(
                flat, grads)):
            g.copy_(summed)
        optimizer.step()
        with torch.no_grad():
            acc = _masked_mean((logits.argmax(-1) == labels).to(
                torch.float32), b.get("mask"), dp_group)
            metrics = torch.stack([loss.detach(), acc])
            dist.all_reduce(metrics, group=dp_group)
        return {"loss": metrics[0], "accuracy": metrics[1]}

    return step, optimizer


def train_smoke(steps: int = 3, batch: int = 8,
                config: Optional[BuscaConfig] = None, spec=None,
                seed: int = 0, device="cuda", mesh=None,
                init_state: Optional[dict] = None):
    """A short training run on synthetic episodes, sharded over ``mesh``
    (:func:`make_sharded_train_step`) when one is given.  ``init_state``:
    the initial parameters as a state dict (every parameter; buffers may
    be absent), else seeded random weights.  Returns the model (this
    rank's shards under a mesh) and the last step's metrics as floats."""
    from busca_tpu_torch.train.data import EpisodeSpec, synthetic_batch
    from busca_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    config = config or BuscaConfig(num_layer=2, reid_num_classes=7,
                                   reid_layers=(1, 1, 1, 1))
    spec = spec or EpisodeSpec(batch=batch, seq_len=3, num_candidates=2,
                               crop_hw=(64, 32))
    rng = np.random.RandomState(seed)
    synthetic_batch(rng, spec)  # busca_tpu initializes on this batch
    model = BuscaModel(config)
    if init_state is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        missing, unexpected = model.load_state_dict(init_state,
                                                    strict=False)
        params = {name for name, _ in model.named_parameters()}
        if unexpected or any(k in params for k in missing):
            raise KeyError(f"init_state mismatch: missing {missing}, "
                           f"unexpected {unexpected}")
    model.to(device)
    if mesh is not None:
        step, _ = make_sharded_train_step(model, mesh)
    else:
        step = make_train_step(model, make_optimizer(model.parameters()))
    metrics = None
    for i in range(steps):
        metrics = step(synthetic_batch(rng, spec),
                       step_generator(seed, i, device))
    return model, {k: float(v) for k, v in metrics.items()}
