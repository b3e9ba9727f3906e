"""The port's sharded train step (``train/trainer.py::
make_sharded_train_step``) against busca_tpu's unsharded ``train_smoke``
and ``jax.value_and_grad`` of its loss.

busca_tpu_torch's ``train_smoke(mesh=...)`` runs over gloo ranks on the
CPU, spawned, from busca_tpu's initial weights (``init_state``), dropout 0
(masks drawn per rank cannot equal the unsharded step's), on dp=2 x tp=1
(2 ranks) and dp=2 x tp=2 (4 ranks).  Bars:

- after the run, tests/test_sharded_numerics.py's: the loss within 1e-4
  relative, the accuracy within 1e-6, every parameter within 6e-4.  The
  parameter bar catches gross faults only: Adam moves an element by about
  lr = 1e-4 a step whatever the gradient's scale, so two runs of two steps
  differ by at most ~4e-4;
- the gradients, which carry the scale Adam and the clip hide: one sharded
  step from the same weights on ``train_smoke``'s first batch, with a
  sample mask that leaves the two dp halves 4 and 2 samples (so a mean of
  per-rank means, or per-rank BN statistics, is off).  Its loss within
  1e-5 relative of busca_tpu's; its gradients, summed over dp and gathered
  over tp, before the clip, each within 2e-4 of that parameter's largest
  |gradient| plus 1e-6 of ``jax.value_and_grad``'s (test_torch_trainer's
  bar); :class:`ShardedAdamW`'s global norm of them (the tp-split squares
  summed over tp, the replicated counted once) within 2e-4 relative of the
  norm of busca_tpu's gradients;
- each rank holds 1/tp of every split weight.

On a one-rank gloo group (mesh 1 x 1: the dp collectives on a single
rank, what chip_smoke.py phase 16 runs over NCCL), the sharded step equals
``make_train_step`` bit for bit, with dropout and a mask.
:class:`ShardedAdamW` at tp 1 equals :class:`AdamW` bit for bit.
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from busca_tpu.models.busca import BuscaConfig as JCfg
from busca_tpu.models.busca import BuscaModel as JModel
from busca_tpu.train.data import EpisodeSpec as JSpec
from busca_tpu.train.data import synthetic_batch as j_synthetic_batch
from busca_tpu.train.trainer import loss_fn as j_loss_fn
from busca_tpu.train.trainer import train_smoke as j_train_smoke
from busca_tpu_torch.models.busca import BuscaConfig, BuscaModel
from busca_tpu_torch.models.convert import state_dict_from_flax
from busca_tpu_torch.parallel.dryrun import free_port, launch
from busca_tpu_torch.parallel.mesh import (
    _spec_for_param,
    gather_state_dict,
    make_mesh,
)
from busca_tpu_torch.train.data import EpisodeSpec, synthetic_batch
from busca_tpu_torch.train.trainer import (
    AdamW,
    ShardedAdamW,
    make_optimizer,
    make_sharded_train_step,
    make_train_step,
    step_generator,
)
from test_torch_strongsort import one_torch_thread  # noqa: F401

SMOKE = dict(num_layer=2, reid_num_classes=7, reid_layers=(1, 1, 1, 1),
             dropout_p=0.0)
SPEC = dict(batch=8, seq_len=3, num_candidates=2, crop_hw=(64, 32))
SEED, STEPS = 3, 2
LOSS_RTOL, ACC_ATOL, PARAM_ATOL = 1e-4, 1e-6, 6e-4
STEP_LOSS_RTOL, GRAD_RTOL, GRAD_ATOL, NORM_RTOL = 1e-5, 2e-4, 1e-6, 2e-4
# the dp halves of the batch keep 4 and 2 samples
MASK = [1, 1, 1, 1, 0, 1, 0, 1]
LAUNCH_TIMEOUT_S = 300


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """busca_tpu's unsharded train_smoke, and its initial weights (drawn
    as train_smoke draws them) saved for the ranks."""
    cfg, spec = JCfg(**SMOKE), JSpec(**SPEC)
    b0 = j_synthetic_batch(np.random.RandomState(SEED), spec)
    init = jax.tree_util.tree_map(np.asarray, jax.jit(JModel(cfg).init)(
        jax.random.PRNGKey(SEED), b0["mem_crops"], b0["can_crops"],
        b0["mem_boxes"], b0["can_boxes"])["params"])
    root = tmp_path_factory.mktemp("sharded_train")
    torch.save(state_dict_from_flax({"params": init}), root / "init.pt")
    params, metrics = j_train_smoke(steps=STEPS, config=cfg, spec=spec,
                                    seed=SEED)
    want = state_dict_from_flax(
        {"params": jax.tree_util.tree_map(np.asarray, params)})
    rng = np.random.RandomState(SEED)
    j_synthetic_batch(rng, spec)
    b1 = dict(j_synthetic_batch(rng, spec), mask=np.float32(MASK))
    loss, grads = jax.jit(jax.value_and_grad(lambda p: j_loss_fn(
        JModel(cfg), p, b1, jax.random.PRNGKey(0))))(init)
    grads = jax.tree_util.tree_map(np.asarray, grads)
    norm = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                       for g in jax.tree_util.tree_leaves(grads)))
    first = {"loss": float(loss), "norm": float(norm),
             "grads": state_dict_from_flax({"params": grads})}
    return root, want, metrics, first


@pytest.mark.parametrize("ranks,tp", [(2, 1), (4, 2)],
                         ids=["dp2-tp1", "dp2-tp2"])
def test_sharded_train_smoke_matches_busca_tpu(jax_run, ranks, tp):
    root, want, jmetrics, jfirst = jax_run
    out = root / f"out{ranks}.pt"
    launch(ranks, "train", dict(config=SMOKE, spec=SPEC, steps=STEPS,
                                seed=SEED, state=str(root / "init.pt"),
                                out=str(out), tp=tp, mask=MASK),
           timeout=LAUNCH_TIMEOUT_S, backend="gloo")
    res = torch.load(out, weights_only=False)
    first = res["first_step"]
    assert first["loss"] == pytest.approx(jfirst["loss"],
                                          rel=STEP_LOSS_RTOL)
    assert set(first["grads"]) == set(jfirst["grads"])
    for name, g in jfirst["grads"].items():
        tol = GRAD_RTOL * g.abs().max().item() + GRAD_ATOL
        gap = (first["grads"][name] - g).abs().max().item()
        assert gap <= tol, (name, gap, tol)
    assert first["norm"] == pytest.approx(jfirst["norm"], rel=NORM_RTOL)
    assert res["metrics"]["loss"] == pytest.approx(jmetrics["loss"],
                                                   rel=LOSS_RTOL)
    assert res["metrics"]["accuracy"] == pytest.approx(
        jmetrics["accuracy"], abs=ACC_ATOL)
    checked = 0
    for name, value in want.items():
        np.testing.assert_allclose(res["state"][name].numpy(),
                                   value.numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=name)
        checked += 1
    assert checked > 60
    split = 0
    for shapes in res["local_shapes"]:
        for name, shape in shapes.items():
            spec = _spec_for_param(name, want[name], tp)
            whole = list(want[name].shape)
            if tp > 1 and "tp" in spec:
                whole[spec.index("tp")] //= tp
                split += 1
            assert shape == whole, name
    assert (split > 0) == (tp > 1)


@pytest.fixture
def one_rank_group():
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        yield make_mesh(1)
    finally:
        dist.destroy_process_group()


def test_one_rank_sharded_step_equals_unsharded(
        one_rank_group, one_torch_thread):  # noqa: F811
    """The sharded step on a 1 x 1 mesh: losses, accuracies and every
    parameter equal to ``make_train_step``'s, bit for bit, over three
    steps with dropout 0.1 and a mask."""
    cfg = BuscaConfig(**dict(SMOKE, dropout_p=0.1))
    spec = EpisodeSpec(**dict(SPEC, batch=4))
    rng = np.random.RandomState(0)
    batches = [synthetic_batch(rng, spec) for _ in range(3)]
    for b in batches:
        b["mask"] = np.array([1, 1, 0, 1], np.float32)
    models = []
    for _ in range(2):
        m = BuscaModel(cfg)
        m.init_weights(torch.Generator().manual_seed(1))
        models.append(m)
    # one intra-op thread: oneDNN's threaded weight gradients vary
    plain = make_train_step(models[0], make_optimizer(models[0].parameters()))
    sharded, opt = make_sharded_train_step(models[1], one_rank_group)
    assert isinstance(opt, ShardedAdamW)
    for i, b in enumerate(batches):
        a = plain(b, step_generator(0, i, "cpu"))
        s = sharded(b, step_generator(0, i, "cpu"))
        assert torch.equal(a["loss"], s["loss"])
        assert torch.equal(a["accuracy"], s["accuracy"])
    whole = gather_state_dict(models[1], one_rank_group)
    for name, p in models[0].state_dict().items():
        assert torch.equal(p, whole[name]), name


def test_sharded_adamw_at_tp1_equals_adamw():
    rng = torch.Generator().manual_seed(0)
    params = [torch.nn.Parameter(torch.randn(5, 3, generator=rng))
              for _ in range(2)]
    twins = [torch.nn.Parameter(p.detach().clone()) for p in params]
    opts = [AdamW(params, grad_clip=1.0), ShardedAdamW(twins, grad_clip=1.0)]
    for _ in range(3):
        grads = [torch.randn(5, 3, generator=rng) * 10 for _ in params]
        for ps, opt in zip((params, twins), opts):
            for p, g in zip(ps, grads):
                p.grad = g.clone()
            opt.step()
    for p, q in zip(params, twins):
        assert torch.equal(p, q)
