"""Multi-rank runs of the sharded paths: a launcher that starts one process
per rank, the rank programs, and ``dryrun_multichip`` (the port's analogue
of busca_tpu's ``__graft_entry__.dryrun_multichip``).

    python -m busca_tpu_torch.parallel.dryrun --n 4

runs :func:`dryrun_multichip` on 4 ranks: NCCL over ``cuda:0..3`` when 4
cards are visible, else gloo on the CPU.  Its checks: two sharded train
steps against the unsharded ones from the same weights, dropout 0 (loss
rel 1e-4, parameters 6e-4); the sharded associate-style forward (batch
over dp, Megatron/channel tp in the model) against the unsharded one on
rank 0 (atol 2e-4, busca_tpu's bar); the dp lockstep detector
(``YoloxDetector.shard_lockstep`` over ``local_devices(n)``) against the
unsharded one, bit for bit.

:func:`launch` starts ``n`` ranks of one rank program (``python -m
busca_tpu_torch.parallel.dryrun --worker NAME ...``, each with its rank,
the world size and a ``tcp://127.0.0.1`` rendezvous), waits at most
``timeout`` seconds, and kills every rank when one fails or time runs out.
The rank programs import torch and the port only.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(n: int, worker: str, args: dict, timeout: float = 300.0,
           backend: Optional[str] = None) -> List[str]:
    """Run rank program ``worker`` on ``n`` ranks, one process each, and
    return their outputs.  ``backend``: ``gloo`` or ``nccl`` (default:
    NCCL when ``n`` cards are visible, else gloo).  Raises when a rank
    fails or ``timeout`` passes; every rank is stopped first."""
    if backend is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        backend = "nccl" if cards >= n else "gloo"
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")
    init = f"tcp://127.0.0.1:{free_port()}"
    # each rank writes to a file, so no pipe fills while the ranks run
    logs = [tempfile.TemporaryFile() for _ in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "busca_tpu_torch.parallel.dryrun",
         "--worker", worker, "--rank", str(r), "--world", str(n),
         "--init", init, "--backend", backend, "--args", json.dumps(args)],
        env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(n)]
    deadline = time.monotonic() + timeout
    outs = [None] * n
    try:
        while any(o is None for o in outs):
            for r, p in enumerate(procs):
                if outs[r] is None and p.poll() is not None:
                    logs[r].seek(0)
                    outs[r] = logs[r].read().decode(errors="replace")
                    if p.returncode != 0:
                        raise RuntimeError(
                            f"rank {r} of {worker} failed (exit "
                            f"{p.returncode}):\n{outs[r]}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"{worker} on {n} ranks passed its "
                                   f"{timeout} s limit")
            time.sleep(0.05)
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    return outs


def _init(rank: int, world: int, init: str, backend: str) -> torch.device:
    import torch.distributed as dist

    if backend == "nccl":
        from busca_tpu_torch.utils.device import set_card_precision

        set_card_precision()
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world)
    return device


def _model(config: dict, state_path: Optional[str], seed: int = 0):
    from busca_tpu_torch.models.busca import BuscaConfig, BuscaModel

    model = BuscaModel(BuscaConfig.from_dict(config))
    if state_path:
        model.load_state_dict(torch.load(state_path, weights_only=True),
                              strict=False)
    else:
        model.init_weights(torch.Generator().manual_seed(seed))
    return model


def _local_shapes(model) -> dict:
    return {name: list(p.shape) for name, p in model.named_parameters()}


def _gather_object(obj) -> list:
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def train_worker(device, args: dict):
    """The sharded ``train_smoke`` from shared weights, then one sharded
    step from the same weights on ``train_smoke``'s first batch with the
    sample mask ``args["mask"]``.  Rank 0 saves the whole parameters after
    the run, its metrics, every rank's local shapes, and the one step's
    loss, gradients (summed over dp, gathered over tp, before the clip)
    and :class:`ShardedAdamW`'s global norm of them."""
    import torch.distributed as dist

    from busca_tpu_torch.models.busca import BuscaConfig
    from busca_tpu_torch.parallel.mesh import gather_state_dict, make_mesh
    from busca_tpu_torch.train.data import EpisodeSpec
    from busca_tpu_torch.train.trainer import train_smoke

    mesh = make_mesh(tp_size=args["tp"])
    init = torch.load(args["state"], weights_only=True)
    config = BuscaConfig.from_dict(args["config"])
    spec = EpisodeSpec(**args["spec"])
    model, metrics = train_smoke(
        steps=args["steps"], config=config, spec=spec, seed=args["seed"],
        device=device, mesh=mesh, init_state=init)
    state = gather_state_dict(model, mesh)
    shapes = _gather_object(_local_shapes(model))
    first = _first_step(config, spec, args, init, mesh, device)
    if dist.get_rank() == 0:
        torch.save({"state": {k: v.cpu() for k, v in state.items()},
                    "metrics": metrics, "local_shapes": shapes,
                    "first_step": first}, args["out"])


def _first_step(config, spec, args: dict, init: dict, mesh, device) -> dict:
    """One sharded step from ``init`` on ``train_smoke``'s first batch
    masked by ``args["mask"]``: its loss, the whole gradients the update
    saw before the clip, and the optimizer's global norm of them."""
    from busca_tpu_torch.models.busca import BuscaModel
    from busca_tpu_torch.parallel.mesh import gather_state_dict
    from busca_tpu_torch.train.data import synthetic_batch
    from busca_tpu_torch.train.trainer import (
        make_sharded_train_step,
        step_generator,
    )

    model = BuscaModel(config)
    model.load_state_dict(init, strict=False)
    model.to(device)
    step, optimizer = make_sharded_train_step(model, mesh)
    rng = np.random.RandomState(args["seed"])
    synthetic_batch(rng, spec)  # train_smoke initializes on this batch
    batch = synthetic_batch(rng, spec)
    batch["mask"] = np.asarray(args["mask"], np.float32)
    metrics = step(batch, step_generator(args["seed"], 0, device))
    params = list(model.parameters())
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    norm = optimizer._global_norm(params, grads)
    with torch.no_grad():  # the gradients in the parameters' places
        for p, g in zip(params, grads):
            p.copy_(g)
    names = {name for name, _ in model.named_parameters()}
    whole = gather_state_dict(model, mesh)
    return {"loss": float(metrics["loss"]), "norm": float(norm),
            "grads": {k: v.cpu() for k, v in whole.items() if k in names}}


def sharded_probs(model, mesh, arrays, device) -> torch.Tensor:
    """The associate-style forward (softmax of the logits) of a sharded
    model over the global batch ``arrays`` (mem_crops, can_crops,
    mem_boxes, can_boxes, mask): this rank's dp slice in, every slice
    gathered out."""
    import torch.distributed as dist

    from busca_tpu_torch.parallel.mesh import batch_sharding

    local = [batch_sharding(mesh, torch.as_tensor(a)).to(device)
             for a in arrays]
    model.eval()
    with torch.no_grad():
        probs = torch.softmax(model(*local), dim=-1).contiguous()
        parts = [torch.empty_like(probs)
                 for _ in range(mesh["dp"].size())]
        dist.all_gather(parts, probs, group=mesh.get_group("dp"))
    return torch.cat(parts).cpu()


def forward_worker(device, args: dict):
    """The sharded forward on the inputs of ``args["inputs"]`` (an
    ``.npz``); rank 0 saves the probabilities and every rank's local
    shapes."""
    import torch.distributed as dist

    from busca_tpu_torch.parallel.mesh import make_mesh, shard_model

    mesh = make_mesh(tp_size=args["tp"])
    model = _model(args["config"], args["state"]).to(device)
    shard_model(model, mesh)
    data = np.load(args["inputs"])
    arrays = [data[k] for k in ("mem_crops", "can_crops", "mem_boxes",
                                "can_boxes", "mask")]
    probs = sharded_probs(model, mesh, arrays, device)
    shapes = _gather_object(_local_shapes(model))
    if dist.get_rank() == 0:
        torch.save({"probs": probs, "local_shapes": shapes}, args["out"])


def metrics_worker(device, args: dict):
    """Each rank tracks its share (``shard_sequences``) of the synthetic
    dropout sequences with BYTE; ``global_metrics`` sums the tallies over
    the ranks; rank 0 writes the merged metrics as JSON."""
    import dataclasses

    import torch.distributed as dist

    from busca_tpu_torch.eval.runner import (
        evaluate_sequence,
        global_metrics,
        run_sequence,
        shard_sequences,
    )
    from busca_tpu_torch.eval.synthetic import default_dropout_sequence
    from busca_tpu_torch.trackers.byte import ByteTracker, ByteTrackerConfig

    names = [f"seq{i}" for i in range(args["sequences"])]
    local = shard_sequences(names, dist.get_rank(), dist.get_world_size())
    per_seq = {}
    for name in local:
        seq = default_dropout_sequence(num_frames=args["frames"],
                                       seed=int(name[3:]))
        dets = [seq.detections(t) for t in range(seq.num_frames)]
        res = run_sequence(ByteTracker(ByteTrackerConfig(use_busca=False)),
                           [None] * seq.num_frames, dets, name=name)
        per_seq[name] = evaluate_sequence(res, seq.ground_truth())
    merged = global_metrics(per_seq)
    if dist.get_rank() == 0:
        with open(args["out"], "w") as f:
            json.dump({"local_sequences": local,
                       "world_size": dist.get_world_size(),
                       "metrics": dataclasses.asdict(merged)}, f)


def dryrun_worker(device, args: dict):
    """The three checks of :func:`dryrun_multichip` on this rank."""
    import copy

    import torch.distributed as dist

    from busca_tpu_torch.models.busca import BuscaConfig
    from busca_tpu_torch.parallel.mesh import (
        local_devices,
        make_mesh,
        shard_model,
    )
    from busca_tpu_torch.train.data import EpisodeSpec
    from busca_tpu_torch.train.trainer import train_smoke

    from busca_tpu_torch.parallel.mesh import gather_state_dict

    n = dist.get_world_size()
    rank = dist.get_rank()
    mesh = make_mesh(n)
    dp = mesh["dp"].size()
    # dropout 0: each rank draws the masks of its own part
    config = dict(num_layer=2, reid_num_classes=7, reid_layers=(1, 1, 1, 1),
                  dropout_p=0.0)
    spec = EpisodeSpec(batch=2 * dp, seq_len=3, num_candidates=2,
                       crop_hw=(64, 32))
    init = _model(config, None, seed=0).state_dict()
    kw = dict(steps=2, config=BuscaConfig(**config), spec=spec,
              device=device, init_state=init)
    sharded_model, metrics = train_smoke(mesh=mesh, **kw)
    trained = gather_state_dict(sharded_model, mesh)
    if not np.isfinite(metrics["loss"]):
        raise RuntimeError(f"non-finite loss: {metrics}")
    if rank == 0:
        # against the unsharded run from the same weights and batches, at
        # tests/test_sharded_numerics.py's bars
        plain_model, plain = train_smoke(**kw)
        param_gap = max(float((p - trained[name]).abs().max()) for name, p
                        in plain_model.state_dict().items()
                        if p.is_floating_point())
        if not (abs(metrics["loss"] - plain["loss"]) <= 1e-4 * abs(
                plain["loss"]) and param_gap <= 6e-4):
            raise RuntimeError(f"sharded train step {metrics}, parameters "
                               f"off by {param_gap}; unsharded {plain}")

    rng = np.random.RandomState(1)
    t, l_mem, c = 2 * n, 3, 2

    def boxes(k):
        xy = rng.uniform(0, 400, (t, k, 2))
        wh = rng.uniform(10, 80, (t, k, 2))
        return np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)

    arrays = [rng.randn(t, l_mem, 64, 32, 3).astype(np.float32),
              rng.randn(t, c, 64, 32, 3).astype(np.float32),
              boxes(l_mem), boxes(c), np.ones((t,), np.float32)]
    model = _model(config, None, seed=1).to(device)
    single = copy.deepcopy(model).eval()
    shard_model(model, mesh)
    sharded = sharded_probs(model, mesh, arrays, device)
    gap = None
    if rank == 0:
        with torch.no_grad():
            want = torch.softmax(single(*[torch.as_tensor(a).to(device)
                                          for a in arrays]), -1).cpu()
        gap = float((sharded - want).abs().max())
        if not (gap <= 2e-4 and torch.isfinite(sharded).all()):
            raise RuntimeError(f"sharded forward off by {gap}")
        _lockstep_check(device, local_devices(n, device.type))
    if rank == 0:
        print(f"dryrun_multichip ok: {dist.get_backend()} mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} "
              f"loss={metrics['loss']:.6f} (unsharded {plain['loss']:.6f}) "
              f"acc={metrics['accuracy']:.3f} train_param_max_abs_diff="
              f"{param_gap:.2e} infer_max_abs_diff={gap:.2e} (T={t} "
              f"sharded associate forward == single-device; dp={n} sharded "
              f"lockstep detector == unsharded, bit for bit)")


def _lockstep_check(device, devices):
    """The dp lockstep detector over ``devices`` against the unsharded
    one, bit for bit."""
    from busca_tpu_torch.eval.detector import YoloxDetector
    from busca_tpu_torch.models.yolox import YoloxConfig

    rng = np.random.RandomState(3)
    cfg = YoloxConfig(depth=0.33, width=0.125, num_classes=1)
    kw = dict(test_size=(64, 96), conf_thresh=0.05, nms_thresh=0.7,
              max_outputs=16, device=device)
    frames = rng.randint(0, 256, (len(devices) + 1, 48, 64, 3)
                         ).astype(np.uint8)
    ref = YoloxDetector(cfg, **kw).detect_batch(frames)
    out = YoloxDetector(cfg, **kw).shard_lockstep(devices).detect_batch(
        frames)
    for a, b in zip(out, ref):
        if not (np.array_equal(a.boxes_tlbr, b.boxes_tlbr)
                and np.array_equal(a.scores, b.scores)
                and torch.equal(a.image.cpu(), b.image.cpu())):
            raise RuntimeError("the dp lockstep detector differs from the "
                               "unsharded one")


WORKERS = {"train": train_worker, "forward": forward_worker,
           "metrics": metrics_worker, "dryrun": dryrun_worker}


def dryrun_multichip(n_devices: int, timeout: float = 600.0) -> str:
    """Run the three sharded checks on ``n_devices`` ranks (module
    docstring); returns rank 0's summary line."""
    outs = launch(n_devices, "dryrun", {}, timeout=timeout)
    line = [ln for ln in outs[0].splitlines()
            if ln.startswith("dryrun_multichip ok")]
    if not line:
        raise RuntimeError(f"no summary from rank 0:\n{outs[0]}")
    return line[0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=2,
                   help="ranks for dryrun_multichip")
    p.add_argument("--worker", choices=sorted(WORKERS), default=None,
                   help="run one rank of a rank program (set by launch)")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--world", type=int, default=1)
    p.add_argument("--init", default=None)
    p.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    p.add_argument("--args", default="{}")
    a = p.parse_args(argv)
    if a.worker is None:
        print(dryrun_multichip(a.n))
        return
    import torch.distributed as dist

    device = _init(a.rank, a.world, a.init, a.backend)
    try:
        WORKERS[a.worker](device, json.loads(a.args))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
