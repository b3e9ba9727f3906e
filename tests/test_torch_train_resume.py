"""Train-state checkpoints (busca_tpu_torch.models.checkpoint): a run saved
after step k and restored on a fresh model and optimizer continues bit for
bit as the unbroken run (dropout on: the masks come from the step's
generator), the file loads with ``weights_only=True``, and a busca_tpu run
handed over mid-training (its parameters and optax AdamW state through
``convert.adamw_state_dict_from_optax``) continues as the JAX run does.

The handover's tolerance is the trainer tests' (tests/test_torch_trainer.py):
at most 1e-3 of the parameters' elements beyond 0.01 lr and none beyond
2 lr after the two steps in the port, at dropout 0.
"""

import os

import jax
import numpy as np
import optax
import pytest
import torch

from busca_tpu.models.busca import BuscaConfig as JCfg
from busca_tpu.models.busca import BuscaModel as JModel
from busca_tpu.train.trainer import make_optimizer as j_make_optimizer
from busca_tpu.train.trainer import make_train_step as j_make_train_step
from busca_tpu_torch.models.busca import BuscaConfig, BuscaModel
from busca_tpu_torch.models.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
    train_state,
)
from busca_tpu_torch.models.convert import (
    adamw_state_dict_from_optax,
    state_dict_from_flax,
)
from busca_tpu_torch.train.data import EpisodeSpec, synthetic_batch
from busca_tpu_torch.train.trainer import (
    make_optimizer,
    make_train_step,
    step_generator,
)
from test_torch_trainer import LR, SMOKE, _np_tree, load_all

SPEC = EpisodeSpec(batch=4, seq_len=3, num_candidates=2, crop_hw=(64, 32))
SEED = 5


def _run(model, optimizer, batches, first_step):
    step = make_train_step(model, optimizer)
    return [{k: float(v) for k, v in step(b, step_generator(
        SEED, first_step + i, "cpu")).items()} for i, b in enumerate(batches)]


def _fresh(init_seed, dropout_p=0.1):
    model = BuscaModel(BuscaConfig(**dict(SMOKE, dropout_p=dropout_p)))
    model.init_weights(torch.Generator().manual_seed(init_seed))
    return model, make_optimizer(model.parameters(), 1e-3, warmup_steps=1,
                                 total_steps=8)


@pytest.fixture
def one_intra_op_thread():
    """Bit-equality needs a CPU backward that sums in one order: with
    several intra-op threads, oneDNN's weight gradients of the same inputs
    differ run to run in their last bits (measured ~1e-6 at 8 threads, 0 at
    one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_resume_is_bit_equal_with_dropout(tmp_path, one_intra_op_thread):
    rng = np.random.RandomState(SEED)
    batches = [synthetic_batch(rng, SPEC) for _ in range(4)]

    model, opt = _fresh(0)
    m_first = _run(model, opt, batches[:2], 0)
    save_checkpoint(str(tmp_path), train_state(model, opt, 2), step=2)
    m_unbroken = _run(model, opt, batches[2:], 2)
    assert any(m["loss"] != m_first[0]["loss"] for m in m_first[1:])

    # a fresh process's model and optimizer, other initial weights
    model2, opt2 = _fresh(1)
    state = restore_checkpoint(str(tmp_path))
    assert state["step"] == 2
    model2.load_state_dict(state["params"])
    opt2.load_state_dict(state["opt_state"])
    assert opt2.param_groups[0]["count"] == 2
    m_resumed = _run(model2, opt2, batches[2:], state["step"])
    assert m_resumed == m_unbroken
    for (n, a), (_, b) in zip(model.state_dict().items(),
                              model2.state_dict().items()):
        assert torch.equal(a, b), n
    for pa, pb in zip(model.parameters(), model2.parameters()):
        sa, sb = opt.state[pa], opt2.state[pb]
        assert torch.equal(sa["mu"], sb["mu"])
        assert torch.equal(sa["nu"], sb["nu"])


def test_checkpoint_files_and_latest_step(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path))
    model, opt = _fresh(0)
    _run(model, opt, [synthetic_batch(np.random.RandomState(0), SPEC)], 0)
    for step in (3, 12, 7):
        path = save_checkpoint(str(tmp_path), train_state(model, opt, step),
                               step=step)
        assert os.path.basename(path) == f"step_{step:08d}"
    assert sorted(os.listdir(tmp_path)) == [
        "step_00000003", "step_00000007", "step_00000012"]
    assert restore_checkpoint(str(tmp_path))["step"] == 12
    assert restore_checkpoint(str(tmp_path), step=7)["step"] == 7
    # the file holds tensors, numbers and containers only
    raw = torch.load(str(tmp_path / "step_00000003"), weights_only=True)
    assert set(raw) == {"params", "opt_state", "step"}
    assert raw["opt_state"]["param_groups"][0]["count"] == 1
    assert set(raw["opt_state"]["state"][0]) == {"mu", "nu"}


def _adam_state(opt_state):
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]


def test_jax_run_handed_over_continues():
    rng = np.random.RandomState(SEED)
    batches = [synthetic_batch(rng, SPEC) for _ in range(4)]
    jmodel = JModel(JCfg(**SMOKE))
    b0 = batches[0]
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), b0["mem_crops"], b0["can_crops"],
        b0["mem_boxes"], b0["can_boxes"])["params"]
    opt = j_make_optimizer()
    jstep = jax.jit(j_make_train_step(jmodel, opt))
    state = opt.init(params)
    for i, b in enumerate(batches[:2]):
        params, state, _ = jstep(params, state, b, jax.random.PRNGKey(i))

    adam = _adam_state(state)
    assert int(adam.count) == 2
    model = load_all(BuscaModel(BuscaConfig(**SMOKE)), _np_tree(params))
    optimizer = make_optimizer(model.parameters())
    optimizer.load_state_dict(adamw_state_dict_from_optax(
        int(adam.count), _np_tree(adam.mu), _np_tree(adam.nu), model,
        optimizer))
    assert optimizer.param_groups[0]["count"] == 2
    name_of = {id(p): n for n, p in model.named_parameters()}
    mu = state_dict_from_flax({"params": _np_tree(adam.mu)})
    for p in model.parameters():
        assert torch.equal(optimizer.state[p]["mu"], mu[name_of[id(p)]])

    step = make_train_step(model, optimizer)
    for i, b in enumerate(batches[2:], start=2):
        params, state, jm = jstep(params, state, b, jax.random.PRNGKey(i))
        m = step(b)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
    want = state_dict_from_flax({"params": _np_tree(params)})
    gaps = torch.cat([((p.detach() - want[n]).abs() / LR).flatten()
                      for n, p in model.named_parameters()])
    assert gaps.max().item() <= 2.0
    assert (gaps > 0.01).float().mean().item() <= 1e-3
