"""The port's train step (busca_tpu_torch.train.trainer) against busca_tpu's
on the CPU: the same weights (through the weight bridge) and the same
batches give the same loss, accuracy and gradients; the optimizer is
optax's AdamW update for update; dropout behaves as flax's.

The model is busca_tpu's ``train_smoke`` config (2 layers at d=512, ReID
stages (1, 1, 1, 1), 64x32 crops), at ``dropout_p=0``: the two frameworks
draw different dropout masks from their seeds, so dropout is pinned on its
own (below).

Tolerances:
- loss 1e-5 relative; accuracy exactly (the argmax agrees: no two logits
  of the batch lie within the float noise);
- gradients: each parameter's within 2e-4 of its largest |gradient| plus
  1e-6 (measured ~3e-5; float32 convolutions and reductions in two
  libraries; the decoder bias's true gradient is 0, a sum of softmax
  minus one-hot, so only noise of ~5e-8 is left there).  The two CPU
  backends round alike here: at this size a few ReLU and max decisions
  tie to float32's last bits, and an evaluation that rounds otherwise
  (oneDNN off, float64-accurate convolutions, the crops changed by 1e-7
  relative) flips one and moves a layer-3/4 gradient by two orders of
  magnitude more than this bound; chip_smoke.py phase 14b prints that
  spread and bounds the card by it;
- the optimizer alone, fed the same gradient stream: parameters within
  1e-6 relative (optax computes the same float32 operations);
- parameters after training steps, in units of the learning rate: Adam
  divides each gradient by its own running magnitude, and the global-norm
  clip (norm ~1500 here, clipped to 1) brings a raw gradient of ~1e-4 to
  ~1e-8, Adam's eps, so float noise in such a gradient moves its element
  by a sizeable share of lr (measured: at most 0.48 lr; 8.4e-5 of the
  13.5M elements beyond 0.01 lr after one step, 2.3e-4 after three).
  After one step, every element whose gradient is above the gradient
  tolerance agrees within 0.01 lr and every element within 1 lr; after
  three, at most 1e-3 of the elements lie beyond 0.01 lr and none beyond
  2 lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from busca_tpu.models.busca import BuscaConfig as JCfg
from busca_tpu.models.busca import BuscaModel as JModel
from busca_tpu.models.reid import BatchNorm as JBatchNorm
from busca_tpu.train.trainer import loss_fn as j_loss_fn
from busca_tpu.train.trainer import make_optimizer as j_make_optimizer
from busca_tpu.train.trainer import make_train_step as j_make_train_step
from busca_tpu_torch.models import encodings as tenc
from busca_tpu_torch.models.busca import BuscaConfig, BuscaModel
from busca_tpu_torch.models.convert import state_dict_from_flax
from busca_tpu_torch.models.reid import BatchNorm
from busca_tpu_torch.models.transformer import dropout
from busca_tpu_torch.train.data import EpisodeSpec, synthetic_batch
from busca_tpu_torch.train.trainer import (
    AdamW,
    loss_fn,
    make_optimizer,
    make_train_step,
    step_generator,
    train_smoke,
)

SMOKE = dict(num_layer=2, reid_num_classes=7, reid_layers=(1, 1, 1, 1),
             dropout_p=0.0)
SPEC = dict(batch=4, seq_len=3, num_candidates=2, crop_hw=(64, 32))
LR = 1e-4  # make_optimizer's default
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [synthetic_batch(rng, EpisodeSpec(**SPEC)) for _ in range(n)]


@pytest.fixture(scope="module")
def shared():
    """busca_tpu's model and initial parameters, its jitted train step,
    and four batches."""
    model = JModel(JCfg(**SMOKE))
    batches = _batches(4)
    b0 = batches[0]
    params = _np_tree(jax.jit(model.init)(
        jax.random.PRNGKey(0), b0["mem_crops"], b0["can_crops"],
        b0["mem_boxes"], b0["can_boxes"])["params"])
    opt = j_make_optimizer()
    step = jax.jit(j_make_train_step(model, opt))
    return model, params, opt, step, batches


def load_all(model, params):
    """Every parameter of busca_tpu's tree into ``model``, the ReID
    classifier too (``load_into`` keeps a model's own head, as inference
    does): a training run carries all of them.  The BN buffers stay."""
    missing, unexpected = model.load_state_dict(
        state_dict_from_flax({"params": params}), strict=False)
    assert not unexpected
    assert all(k.endswith(("running_mean", "running_var",
                           "num_batches_tracked")) for k in missing)
    return model


def _port_model(params):
    return load_all(BuscaModel(BuscaConfig(**SMOKE)), params)


def _gaps_in_lr(model, params):
    """|port - busca_tpu| of every parameter, in units of lr."""
    want = state_dict_from_flax({"params": _np_tree(params)})
    return {n: (p.detach() - want[n]).abs() / LR
            for n, p in model.named_parameters()}


@pytest.mark.parametrize("masked", [False, True])
def test_step_matches_jax(shared, masked):
    """One step: loss, accuracy, every gradient and the updated
    parameters, against ``jax.value_and_grad`` of busca_tpu's loss and its
    train step with ``make_optimizer()`` (clip 1.0, AdamW)."""
    jmodel, params, opt, jstep, batches = shared
    batch = dict(batches[1])
    if masked:
        batch["mask"] = np.array([1, 1, 0, 1], np.float32)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: j_loss_fn(jmodel, p, batch, jax.random.PRNGKey(1))))(
            params)
    jparams, _, jmetrics = jstep(params, opt.init(params), batch,
                                 jax.random.PRNGKey(1))

    model = _port_model(params)
    with torch.no_grad():
        np.testing.assert_allclose(float(loss_fn(model, batch)), float(jloss),
                                   rtol=1e-5)
    step = make_train_step(model, make_optimizer(model.parameters()))
    metrics = step(batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=1e-5)
    assert float(metrics["accuracy"]) == float(jmetrics["accuracy"])
    want = state_dict_from_flax({"params": _np_tree(jgrads)})
    names = {n for n, _ in model.named_parameters()}
    assert names == set(want)
    gaps = _gaps_in_lr(model, jparams)
    for n, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        tol = GRAD_RTOL * want[n].abs().max().item() + GRAD_ATOL
        gap = (g - want[n]).abs().max().item()
        assert gap <= tol, (n, gap, tol)
        above_noise = want[n].abs() > tol
        assert gaps[n].max().item() <= 1.0, n
        if above_noise.any():
            assert gaps[n][above_noise].max().item() <= 0.01, n


def test_three_step_trajectory_matches_jax(shared):
    jmodel, params, opt, jstep, batches = shared
    model = _port_model(params)
    step = make_train_step(model, make_optimizer(model.parameters()))
    jp, js = params, opt.init(params)
    for i in range(3):
        jp, js, jm = jstep(jp, js, batches[i], jax.random.PRNGKey(i))
        m = step(batches[i])
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        assert float(m["accuracy"]) == float(jm["accuracy"])
    gaps = torch.cat([g.flatten() for g in _gaps_in_lr(model, jp).values()])
    assert gaps.max().item() <= 2.0
    assert (gaps > 0.01).float().mean().item() <= 1e-3


def test_eval_mode_and_no_grad_into_encodings(shared):
    """A new model scores in eval mode (flax's deterministic default); the
    positional encodings carry no gradient (the fp16 quantization is a
    cast of box arithmetic, not of parameters)."""
    model = BuscaModel(BuscaConfig(**dict(SMOKE, dropout_p=0.5)))
    assert not model.training
    b = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    mem_pe, can_pe = tenc.positional_encodings(
        b["mem_boxes"], b["can_boxes"], 512, "MEM-SEP-CAN-BAD", True, True)
    assert not mem_pe.requires_grad and not can_pe.requires_grad
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = model(b["mem_crops"], b["can_crops"], b["mem_boxes"],
                  b["can_boxes"])
        c = model(b["mem_crops"], b["can_crops"], b["mem_boxes"],
                  b["can_boxes"], generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, c)


# ---- the optimizer alone, against optax --------------------------------

OPT_CASES = {
    # name: (make_optimizer kwargs, gradient scale)
    "constant_no_clip": (dict(learning_rate=1e-3, grad_clip=None), 1.0),
    "clip_triggered": (dict(learning_rate=1e-3, grad_clip=0.5), 100.0),
    "clip_not_triggered": (dict(learning_rate=1e-3, grad_clip=50.0), 1.0),
    "warmup_cosine_clip": (dict(learning_rate=1e-3, warmup_steps=2,
                                total_steps=6, grad_clip=0.5), 100.0),
    "warmup_cosine_no_clip": (dict(learning_rate=1e-3, warmup_steps=3,
                                   total_steps=5, grad_clip=None,
                                   weight_decay=0.01), 1.0),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_optax(case):
    kw, scale = OPT_CASES[case]
    rng = np.random.RandomState(11)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * scale * rng.uniform(0.01, 1)).astype(
        np.float32) for k, s in shapes.items()} for _ in range(8)]

    tx = j_make_optimizer(**kw)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in init.items()}
    opt = make_optimizer(list(tp.values()), **kw)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-9, err_msg=k)


def test_optimizer_schedule_and_clipping():
    """tests/test_train.py::test_optimizer_schedule_and_clipping on the
    port: clipped to 0.5, the first update of the warmup has lr 0."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = make_optimizer([p], 1e-3, warmup_steps=2, total_steps=10,
                         grad_clip=0.5)
    p.grad = torch.full((3,), 100.0)
    opt.step()
    assert torch.all((p.detach() - 1.0).abs() < 1e-6)
    opt.step()
    assert torch.isfinite(p.detach()).all()
    assert torch.all(p.detach() < 1.0)


def test_parameter_without_gradient_decays_as_under_jax_grad():
    """An unused parameter (the ReID classifier in BUSCA) has no gradient
    in torch and a zero one under ``jax.grad``: optax still decays it."""
    init = np.array([1.0, -2.0], np.float32)
    tx = j_make_optimizer(1e-2, grad_clip=None)
    jp = {"w": jnp.asarray(init)}
    state = tx.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(init.copy()))
    opt = AdamW([p], 1e-2)
    for _ in range(3):
        updates, state = tx.update({"w": jnp.zeros(2)}, state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp["w"]),
                               rtol=1e-6)
    assert not np.array_equal(np.asarray(jp["w"]), init)


# ---- dropout --------------------------------------------------------------

def test_dropout_is_flax_dropout():
    x = torch.ones(200_000)
    assert dropout(x, 0.3, training=False) is x
    g = torch.Generator().manual_seed(4)
    y = dropout(x, 0.3, True, g)
    y2 = dropout(x, 0.3, True, torch.Generator().manual_seed(4))
    assert torch.equal(y, y2)
    assert not torch.equal(y, dropout(x, 0.3, True,
                                      torch.Generator().manual_seed(5)))
    kept = y != 0
    # the kept ones are scaled by 1/(1-p), flax's x / keep_prob
    assert torch.equal(y[kept], torch.full_like(y[kept], 1.0 / 0.7))
    # keep rate within 5 binomial standard deviations of 0.7
    n = x.numel()
    sd = np.sqrt(n * 0.7 * 0.3)
    assert abs(kept.sum().item() - 0.7 * n) < 5 * sd
    assert torch.equal(dropout(x, 1.0, True, g), torch.zeros_like(x))
    assert dropout(x, 0.0, True, g) is x


def test_model_dropout_uses_the_generator():
    """In training mode the model's masks come from the generator: the same
    generator seed gives the same logits, another seed others, and eval
    mode (or rate 0) none."""
    cfg = BuscaConfig(**dict(SMOKE, dropout_p=0.3))
    model = BuscaModel(cfg).init_weights(torch.Generator().manual_seed(1))
    b = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}

    def run(seed):
        return model(b["mem_crops"], b["can_crops"], b["mem_boxes"],
                     b["can_boxes"],
                     generator=torch.Generator().manual_seed(seed))

    with torch.no_grad():
        eval_out = run(0)
        model.train()
        a, a2, c = run(0), run(0), run(1)
        model.eval()
    assert torch.equal(a, a2)
    assert not torch.equal(a, c)
    assert not torch.equal(a, eval_out)
    g1 = step_generator(3, 7, "cpu")
    g2 = step_generator(3, 7, "cpu")
    assert torch.equal(torch.rand(5, generator=g1),
                       torch.rand(5, generator=g2))
    assert not torch.equal(torch.rand(5, generator=step_generator(3, 8,
                                                                 "cpu")),
                           torch.rand(5, generator=step_generator(3, 7,
                                                                 "cpu")))


# ---- the masked batch-stat BatchNorm's gradients -------------------------

@pytest.mark.parametrize("mask_kind", ["none", "weights", "groups"])
def test_masked_bn_gradients_match_jax(mask_kind):
    """Gradients of the ReID BatchNorm (E[x^2] - E[x]^2, clamped at 0) with
    respect to its input, scale and bias, against flax's."""
    rng = np.random.RandomState(3)
    x = rng.randn(6, 5, 4, 8).astype(np.float32) * 2 + 1  # NHWC
    cot = rng.randn(*x.shape).astype(np.float32)
    mask = {"none": None,
            "weights": np.array([1, 1, 0, 1, 2, 0], np.float32),
            "groups": np.eye(2, dtype=np.float32)[[0, 0, 1, 1, 0, 1]]
            * np.array([[1], [0], [1], [2], [1], [1]], np.float32)}[mask_kind]
    jbn = JBatchNorm(8)
    variables = jbn.init(jax.random.PRNGKey(0), x, mask)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.randn(8).astype(np.float32)
    params = {"weight": scale, "bias": bias}

    def jf(xx, p):
        y = jbn.apply({**variables, "params": p}, xx, mask)
        return jnp.sum(y * cot)

    jgx, jgp = jax.grad(jf, argnums=(0, 1))(x, params)

    bn = BatchNorm(8)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    y = bn(xt, None if mask is None else torch.from_numpy(mask))
    (y * torch.from_numpy(cot.transpose(0, 3, 1, 2).copy())).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1),
                               np.asarray(jgx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bn.weight.grad.numpy(),
                               np.asarray(jgp["weight"]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(bn.bias.grad.numpy(),
                               np.asarray(jgp["bias"]), rtol=1e-4, atol=1e-5)
    assert torch.equal(bn.running_mean, torch.zeros(8))  # no stats updated


def test_train_smoke_returns_finite_metrics():
    model, metrics = train_smoke(steps=2, batch=4, seed=1, device="cpu")
    assert set(metrics) == {"loss", "accuracy"}
    assert np.isfinite(metrics["loss"]) and 0.0 <= metrics["accuracy"] <= 1.0
    assert model.training
