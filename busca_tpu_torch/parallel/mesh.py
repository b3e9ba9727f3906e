"""Device mesh and sharding rules for the BUSCA model family (port of
``busca_tpu.parallel.mesh``).

The reference's only distribution is NCCL DDP over eval processes
(tools/track.py:305-316): sequences are embarrassingly parallel, with a
final gather.  busca_tpu adds a (dp, tp) mesh for training and the
associate forward:

- **dp** (data parallel): training batches and track batches split over
  ranks; the BN statistics, the loss and the gradients are reduced over dp;
- **tp** (tensor parallel): the decision Transformer's attention and FF
  projections split column/row-wise (Megatron layout), the ReID's
  convolutions over their output channels.

busca_tpu's mesh is one process over many devices, partitioned by GSPMD.
torch has no such partitioner, so the port's mesh is one rank per device
over ``torch.distributed`` (gloo on the CPU, NCCL on the card):
:func:`make_mesh` returns a ``DeviceMesh`` over the initialized group, each
rank holds its shards of the parameters (:func:`shard_model`), and the
collectives are written out in the modules (``parallel/collectives.py``).
The lockstep detector's dp split (``YoloxDetector.shard_lockstep``) stays
inside one process, as in busca_tpu, over :func:`local_devices`.

Sequence-level data parallelism across processes (one MOT sequence group
per rank) is :mod:`busca_tpu_torch.eval.runner`'s: it needs no collective
until the final metric sum.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

Spec = Tuple[Optional[str], ...]


def make_mesh(n_devices: Optional[int] = None,
              axes: Tuple[str, str] = ("dp", "tp"),
              tp_size: Optional[int] = None):
    """A (dp, tp) ``DeviceMesh`` over the initialized process group, one
    rank per device.  ``n_devices`` must be the group's size when given
    (busca_tpu takes the first n devices of one process; here the group is
    the set of devices).  tp defaults to 2 when the count is even, else 1,
    as busca_tpu's.  The mesh's device type follows the group's backend:
    ``cuda`` for NCCL, ``cpu`` for gloo."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"the process group has {n} ranks, not "
                         f"{n_devices}: one rank per device")
    if tp_size is None:
        tp_size = 2 if n % 2 == 0 and n >= 2 else 1
    if n % tp_size != 0:
        raise ValueError(f"{n} devices not divisible by tp={tp_size}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // tp_size, tp_size),
                            mesh_dim_names=tuple(axes))


def axis_size(mesh, axis: str) -> int:
    """The mesh's extent along ``axis`` (1 without a mesh)."""
    return 1 if mesh is None else mesh[axis].size()


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def batch_sharding(mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's part of a batch: its leading axis split evenly over dp
    (busca_tpu's ``batch_sharding`` places it so; GSPMD too requires an
    even split), the rest whole."""
    dp = axis_size(mesh, "dp")
    if x.shape[0] % dp:
        raise ValueError(f"a batch of {x.shape[0]} does not split over "
                         f"dp={dp}")
    n = x.shape[0] // dp
    return x.narrow(0, axis_rank(mesh, "dp") * n, n)


def _spec_for_param(name: str, value: torch.Tensor, tp_size: int = 2
                    ) -> Spec:
    """Megatron-style partition spec of one parameter of a ``BuscaModel``
    state dict, by its name (busca_tpu's rules in torch layouts):

    - attention ``in_proj`` and FF ``linear1``: the output dim over tp
      (column parallel); each rank's ``in_proj`` rows are its heads' q, k
      and v rows (:func:`shard_tensor`), not a contiguous third;
    - attention ``out_proj.weight`` and FF ``linear2.weight``: the input
      dim over tp (row parallel); their biases are added once, after the
      reduction, so they stay whole;
    - ReID convolution weights ``[cout, cin, kh, kw]``: the output
      channels over tp (flax's ``[kh, kw, cin, cout]`` dim 3), whole when
      ``cout % tp != 0``; the matching BN weight and bias the same way, so
      batch-statistics BN stays local to a rank's channels;
    - everything else (norms, special tokens, the encoder linear, the
      decoder, the ReID's ``red`` and ``fc``): whole (tiny).
    """
    whole = (None,) * value.dim()
    if "in_proj_weight" in name or "linear1.weight" in name:
        return ("tp", None)
    if "in_proj_bias" in name or "linear1.bias" in name:
        return ("tp",)
    if "out_proj.weight" in name or "linear2.weight" in name:
        return (None, "tp")
    if name.startswith("reid_encoder") and value.dim() == 4:
        if value.shape[0] % tp_size == 0:
            return ("tp", None, None, None)
        return whole
    leaf = name.rsplit(".", 1)[-1]
    if (name.startswith("reid_encoder")
            and (".bn" in name or "downsample.1" in name)
            and leaf in ("weight", "bias")
            and value.dim() == 1 and value.shape[0] % tp_size == 0):
        return ("tp",)
    return whole


def param_shardings(model: torch.nn.Module, mesh) -> Dict[str, Spec]:
    """``{name: spec}`` for every parameter of a ``BuscaModel``."""
    tp = axis_size(mesh, "tp")
    return {name: _spec_for_param(name, p, tp)
            for name, p in model.named_parameters()}


def shard_tensor(name: str, value: torch.Tensor, spec: Spec, tp_size: int,
                 tp_rank: int) -> torch.Tensor:
    """Rank ``tp_rank``'s shard of a whole parameter under ``spec``: the
    ``tp_rank``-th of ``tp_size`` equal blocks of the split dim, except for
    the attention's packed ``in_proj`` ``[3d(, d)]``, whose shard is its
    heads' q, k and v rows, ``[3d / tp(, d)]``."""
    if "tp" not in spec:
        return value
    dim = spec.index("tp")
    if "in_proj" in name:
        q, k, v = value.chunk(3, dim=0)
        return torch.cat([t.chunk(tp_size, dim=0)[tp_rank]
                          for t in (q, k, v)], dim=0)
    return value.chunk(tp_size, dim=dim)[tp_rank]


def unshard_tensor(name: str, shards: Sequence[torch.Tensor], spec: Spec
                   ) -> torch.Tensor:
    """The whole parameter from every tp rank's shard (the inverse of
    :func:`shard_tensor`)."""
    if "tp" not in spec:
        return shards[0]
    if "in_proj" in name:
        parts = [s.chunk(3, dim=0) for s in shards]
        return torch.cat([torch.cat([p[i] for p in parts], dim=0)
                          for i in range(3)], dim=0)
    return torch.cat(list(shards), dim=spec.index("tp"))


def local_devices(n: int, device="cuda") -> list:
    """The first ``n`` devices of this process for the lockstep detector's
    dp split: ``cuda:0 .. cuda:n-1`` (refused by name when fewer cards are
    visible), or ``n`` replicas on the CPU for ``device="cpu"``, where the
    split runs the same code on one device."""
    dev = torch.device(device)
    if n < 1:
        raise ValueError(f"need at least one device, got {n}")
    if dev.type == "cpu":
        return [dev] * n
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > visible:
        raise ValueError(f"--lockstep-dp {n} asks for {n} devices, but "
                         f"{visible} CUDA device(s) are visible")
    return [torch.device("cuda", i) for i in range(n)]


def shard_model(model: torch.nn.Module, mesh) -> Dict[str, Spec]:
    """Place a ``BuscaModel`` on the mesh, in place: each parameter split
    over tp by :func:`param_shardings` is replaced by this rank's shard
    (:func:`shard_tensor`; a split BN's running statistics too), the
    ReID's BatchNorms sum their statistics over dp, and, when tp > 1, the
    Transformer's layers and the ReID run their tp forwards (written out
    with ``parallel/collectives.py``; a tp of 1 is the whole model).
    Returns the specs, also kept as ``model.param_specs``."""
    from busca_tpu_torch.models.reid import (
        BatchNorm,
        ChannelParallel,
        ReIDResNet,
    )
    from busca_tpu_torch.models.transformer import (
        MultiHeadSelfAttention,
        TransformerEncoderLayer,
    )

    specs = param_shardings(model, mesh)
    tp = axis_size(mesh, "tp")
    if tp > 1:
        rank = axis_rank(mesh, "tp")
        params = dict(model.named_parameters())
        with torch.no_grad():
            for name, spec in specs.items():
                if "tp" in spec:
                    p = params[name]
                    p.data = shard_tensor(name, p.data, spec, tp,
                                          rank).clone()
        group = mesh.get_group("tp")
        for m in model.modules():
            if isinstance(m, BatchNorm) and m.weight.shape[0] != m.features:
                for buf in ("running_mean", "running_var"):
                    setattr(m, buf, getattr(m, buf).chunk(tp)[rank].clone())
            if isinstance(m, (MultiHeadSelfAttention,
                              TransformerEncoderLayer)):
                m.tp = group
            if isinstance(m, ReIDResNet):
                m.tp = ChannelParallel(group)
    dp_group = mesh.get_group("dp")
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.dp_group = dp_group
    model.param_specs = specs
    return specs


def gather_state_dict(model: torch.nn.Module, mesh) -> Dict[str, torch.Tensor]:
    """The whole state dict of a model sharded by :func:`shard_model`, on
    every rank (its split parameters gathered over tp)."""
    import torch.distributed as dist

    specs = model.param_specs
    tp = axis_size(mesh, "tp")
    out = {}
    for name, value in model.state_dict().items():
        spec = specs.get(name)
        if name.endswith(("running_mean", "running_var")):
            spec = specs.get(name.rsplit(".", 1)[0] + ".weight")
        if tp > 1 and spec is not None and "tp" in spec:
            shards = [torch.empty_like(value) for _ in range(tp)]
            dist.all_gather(shards, value.contiguous(),
                            group=mesh.get_group("tp"))
            value = unshard_tensor(name, shards, spec)
        out[name] = value.detach().clone()
    return out
