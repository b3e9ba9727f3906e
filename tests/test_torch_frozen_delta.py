"""The port's frozen-stats deviation harness (eval/frozen_delta.py) on the
CPU: every case of tests/test_frozen_delta.py, and the calibration against
busca_tpu's on the same crops.

Calibration is exact: frozen BN fed the statistics of one batch reproduces
batch-stat BN on that batch (features within 2e-4 / 1e-3 relative, the JAX
test's bound), and two batches pool as their concatenation at the first BN
(1e-5).  The port's statistics equal busca_tpu's ``calibrate_batch_stats``
on the same crops and weights: the stem BN within 1e-5 of its mean
square, every other BN within 1e-4 (see the test).  The measurement runs
at a small size here (a few training steps); the JAX suite runs it as a
``slow`` test.
"""

import jax
import numpy as np
import pytest
import torch

from busca_tpu.eval import frozen_delta as jfd
from busca_tpu.models.busca import BuscaConfig as JCfg
from busca_tpu.models.busca import BuscaModel as JModel
from busca_tpu_torch.eval.frozen_delta import (
    DualEngine,
    calibrate_batch_stats,
    frozen_model,
    measure_frozen_delta,
    shift_transform,
)
from busca_tpu_torch.models.busca import BuscaConfig, BuscaModel
from busca_tpu_torch.models.convert import load_into, state_dict_from_flax
from test_torch_strongsort import one_torch_thread  # noqa: F401

TINY = dict(num_layer=1, reid_num_classes=5, reid_layers=(1, 1, 1, 1),
            dropout_p=0.0)
H, W = 64, 32


@pytest.fixture(scope="module")
def shared():
    """busca_tpu's tiny variables and the port's model on them."""
    cfg = JCfg(**TINY)
    variables = jax.jit(JModel(cfg).init)(
        jax.random.PRNGKey(0),
        np.zeros((1, 2, H, W, 3), np.float32),
        np.zeros((1, 2, H, W, 3), np.float32),
        np.zeros((1, 2, 4), np.float32),
        np.zeros((1, 2, 4), np.float32),
    )
    variables = jax.tree_util.tree_map(np.asarray, variables)
    model = BuscaModel(BuscaConfig(**TINY))
    load_into(model, state_dict_from_flax(variables))
    return cfg, variables, model


def test_single_batch_calibration_reproduces_batch_stat_forward(shared):
    """Calibrated on ONE batch, frozen BN equals batch-stat BN on that
    batch layer by layer, so the features agree."""
    _, _, model = shared
    x = torch.from_numpy(
        np.random.RandomState(0).randn(12, H, W, 3).astype(np.float32))
    frozen = frozen_model(BuscaConfig(**TINY), model)
    calibrate_batch_stats(frozen, [x.numpy()], load=True)
    with torch.no_grad():
        _, f_batch = model.reid_encoder.model(x)
        _, f_frozen = frozen.reid_encoder.model(x)
    np.testing.assert_allclose(f_batch.numpy(), f_frozen.numpy(), atol=2e-4,
                               rtol=1e-3)
    # the batch-mode model is untouched: its BN still reads the batch
    assert model.reid_encoder.model.bn1.use_batch_stats
    assert float(model.reid_encoder.model.bn1.running_var.min()) == 1.0


def test_calibration_pools_across_batches(shared):
    """Two batches calibrated together equal their concatenation as one at
    the stem BN (deeper BNs see batch-normalized inputs, which is the
    deviation measured)."""
    _, _, model = shared
    rng = np.random.RandomState(1)
    a = rng.randn(6, H, W, 3).astype(np.float32)
    b = rng.randn(10, H, W, 3).astype(np.float32)
    two = calibrate_batch_stats(model, [a, b])
    one = calibrate_batch_stats(model, [np.concatenate([a, b])])
    key = "reid_encoder.model.bn1."
    np.testing.assert_allclose(two[key + "running_mean"].numpy(),
                               one[key + "running_mean"].numpy(), atol=1e-5)
    np.testing.assert_allclose(two[key + "running_var"].numpy(),
                               one[key + "running_var"].numpy(), rtol=1e-3,
                               atol=1e-5)
    with pytest.raises(ValueError, match="at least one batch"):
        calibrate_batch_stats(model, [])


def test_calibration_matches_jax(shared):
    """The port's pooled statistics equal busca_tpu's on the same crops and
    weights, relative to the aggregates' scale: the mean to a share of the
    root mean square, the variance to a share of the mean square E[x^2].
    The stem BN, which sees the raw convolution, to 1e-5 (reads 1.7e-6);
    every other BN to 1e-4, the ReID features' bar
    (tests/test_torch_features.py).  Deeper BNs normalize with batch statistics that carry
    the two libraries' float32 noise layer by layer (layer 4 reads 2.7e-5
    of E[x^2]); the variance is E[x^2] - mean^2, so relative to itself it
    carries that noise times E[x^2] / var (up to 32 here)."""
    cfg, variables, model = shared
    rng = np.random.RandomState(2)
    batches = [rng.randn(n, H, W, 3).astype(np.float32) for n in (6, 10)]
    want = jfd.calibrate_batch_stats(cfg, variables["params"], batches)
    want = {k: v.numpy() for k, v in state_dict_from_flax(
        {"params": variables["params"],
         "batch_stats": jax.tree_util.tree_map(np.asarray, want)}).items()
        if k.endswith(("running_mean", "running_var"))}
    got = calibrate_batch_stats(model, batches)
    assert set(got) == set(want) and len(got) == 2 * 17
    for k in got:
        if not k.endswith("running_mean"):
            continue
        kv = k[:-len("mean")] + "var"
        tol = 1e-5 if k == "reid_encoder.model.bn1.running_mean" else 1e-4
        mean_sq = want[k].astype(np.float64) ** 2 + want[kv]
        np.testing.assert_array_less(
            np.abs(got[k].numpy() - want[k]), tol * np.sqrt(mean_sq),
            err_msg=k)
        np.testing.assert_array_less(
            np.abs(got[kv].numpy() - want[kv]), tol * mean_sq, err_msg=kv)


class _FakeEngine:
    """Deterministic stand-in with the engine's tracker-facing surface."""

    device = torch.device("cpu")

    def __init__(self, probs):
        self._probs = probs

    def center_distances(self, tracks, dets):
        return np.zeros((len(tracks), len(dets)))

    _center_distances = center_distances

    def associate(self, tracks, dets, dists_matrix=None, **kw):
        return self._probs(len(tracks), len(dets)), np.ones(len(tracks), bool)


def _kalman_wins(t, d):
    p = np.zeros((t, d + t))
    for i in range(t):
        p[i, d + i] = 0.9
    return p


def _first_det_wins(t, d):
    p = np.zeros((t, d + t))
    p[:, 0] = 0.9
    return p


def test_dual_engine_same_mode_zero_flips():
    dual = DualEngine(_FakeEngine(_kalman_wins), _FakeEngine(_kalman_wins),
                      rescue_thresh=0.5)
    pb, _ = dual.associate([0, 1], [0, 1, 2])
    assert pb.shape == (2, 5)
    s = dual.summary()
    assert s["rows"] == 2
    assert s["argmax_flips"] == 0 and s["rescue_flips"] == 0
    assert s["rescues_batch"] == 2 and s["rescues_frozen"] == 2
    assert s["argmax_flip_rate"] == 0.0 and s["rescue_flip_rate"] == 0.0
    assert dual.device == torch.device("cpu")


def test_dual_engine_counts_flips():
    """The port's recorder counts as busca_tpu's on the same calls."""
    dual = DualEngine(_FakeEngine(_kalman_wins), _FakeEngine(_first_det_wins),
                      rescue_thresh=0.5)
    jdual = jfd.DualEngine(_FakeEngine(_kalman_wins),
                           _FakeEngine(_first_det_wins), rescue_thresh=0.5)
    for d in (dual, jdual):
        d.associate([0, 1, 2], [0])
        d.associate([0], [0, 1])
    s = dual.summary()
    assert s == jdual.summary()
    assert s["rows"] == 4 and s["argmax_flips"] == 4
    assert s["rescues_batch"] == 4 and s["rescues_frozen"] == 0


def test_measure_frozen_delta_report_shape():
    out = measure_frozen_delta(steps=4, train_batch=4, seed=3, num_frames=24,
                               seq_seeds=(0,), calib_batches=2, device="cpu")
    f = out["flip"]
    assert f["calls"] > 0 and f["rows"] > 0
    assert 0.0 <= f["argmax_flip_rate"] <= 1.0
    assert 0.0 <= f["rescue_flip_rate"] <= 1.0
    for tag in ("base", "batch", "frozen"):
        m = out["metrics"][tag]
        assert np.isfinite([m["mota"], m["hota"], m["idf1"]]).all()
    assert set(out["delta"]) == {"mota", "idf1", "hota", "fn", "ids"}


def test_shift_transform_shapes_and_determinism():
    """The port's shifts are busca_tpu's, bit for bit."""
    frame = np.random.RandomState(0).randint(0, 255, (48, 64, 3)) \
        .astype(np.uint8)
    assert shift_transform("none") is None
    for kind in ("dim", "glare"):
        f = shift_transform(kind)
        out1, out2 = f(frame), f(frame)
        assert out1.shape == frame.shape and out1.dtype == np.uint8
        np.testing.assert_array_equal(out1, out2)
        np.testing.assert_array_equal(out1, jfd.shift_transform(kind)(frame))
        assert np.abs(out1.astype(int) - frame.astype(int)).mean() > 5
    with pytest.raises(ValueError, match="unknown shift"):
        shift_transform("fog")


def test_measure_frozen_delta_shift_arm_runs():
    """The calibrate-on-A / deploy-on-B arm: the shifted frames reach the
    tracker, decisions are recorded, the report is well formed."""
    seen = {"calls": 0}
    dim = shift_transform("dim")

    def spying_dim(frame):
        seen["calls"] += 1
        return dim(frame)

    out = measure_frozen_delta(steps=4, train_batch=4, seed=3, num_frames=24,
                               seq_seeds=(0,), calib_batches=2,
                               frame_transform=spying_dim, n_drop=2,
                               device="cpu")
    assert seen["calls"] == 24
    assert out["flip"]["calls"] > 0 and out["flip"]["rows"] > 0
    for tag in ("base", "batch", "frozen"):
        m = out["metrics"][tag]
        assert np.isfinite([m["mota"], m["hota"], m["idf1"]]).all()


def test_frozen_delta_cli(capsys):
    """``python -m busca_tpu_torch.eval.frozen_delta --device cpu`` prints
    each arm's report and the JSON record."""
    from busca_tpu_torch.eval.frozen_delta import main

    record = main(["--steps", "2", "--train-batch", "4", "--frames", "16",
                   "--seeds", "1", "--shift", "glare", "--device", "cpu"])
    assert set(record) == {"in-domain", "shift:glare"}
    out = capsys.readouterr().out
    assert "== arm: in-domain ==" in out and "== arm: shift:glare ==" in out
    assert "frozen-batch delta" in out
