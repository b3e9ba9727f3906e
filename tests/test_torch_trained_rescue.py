"""The full loop on the port (tests/test_trained_rescue.py on
busca_tpu_torch): training improves the model, and the trained engine runs
live inside the tracker and rescues the track through its dropout.  The
torch-trained weights, converted with busca_tpu's BUSCA converter, give
busca_tpu's engine the same ids and boxes on the rescue sequence (boxes
exactly: the Kalman state is float64 host code in both packages, and the
decisions agree).

busca_tpu's size (45 steps of batch 12, seed 3) is ``slow``, as its test is;
Tier-1 trains 25 steps of batch 8 (seed 3) and holds the same bars:
accuracy > 0.6, base MOTA > 0.6, BUSCA MOTA >= base, no identity switch.
The port initializes its weights from a torch generator, not from flax's
keys, so the trained models of the two packages differ; the shared-weight
comparison is the converted one.
"""

import numpy as np
import pytest
import torch

from busca_tpu.assoc.engine import AssociationEngine as JEngine
from busca_tpu.eval.runner import run_sequence as j_run_sequence
from busca_tpu.models.busca import BuscaConfig as JCfg
from busca_tpu.models.convert import convert_busca_state_dict
from busca_tpu.trackers.byte import ByteTracker as JByte
from busca_tpu.trackers.byte import ByteTrackerConfig as JByteCfg
from busca_tpu.train.demo import run_trained_rescue as j_run_trained_rescue
from busca_tpu_torch.train.demo import (
    main,
    rescue_sequence,
    run_trained_rescue,
    train_demo_model,
)

FRAMES = 22


@pytest.fixture(autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_busca_results(model):
    """busca_tpu's BYTE + BUSCA over the rescue sequence with the port's
    trained weights (every parameter, the ReID head too)."""
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    params = convert_busca_state_dict(sd, ignore_reid_fc=False)["params"]
    cfg = JCfg(num_layer=1, reid_num_classes=5, reid_layers=(1, 1, 1, 1),
               dropout_p=0.0)
    seq = rescue_sequence(FRAMES)
    dets = [seq.detections(t) for t in range(FRAMES)]
    # the BUSCA arm of run_trained_rescue renders its frames after the base
    # arm's, from the sequence's own random state
    for t in range(FRAMES):
        seq.frame(t)
    engine = JEngine(cfg, {"params": params}, seq_len=3, num_candidates=2,
                     crop_hw=(64, 32), buckets=(1, 2, 4))
    tracker = JByte(JByteCfg(use_busca=True, seq_len=3, num_candidates=2,
                             crop_hw=(64, 32), use_broader_memory=False),
                    assoc_engine=engine)
    res = j_run_sequence(tracker, (seq.frame(t) for t in range(FRAMES)),
                         dets)
    return cfg, params, res.results


def _assert_bars(metrics, out):
    # well above the ~37% no-skill rate of the episode mix
    assert metrics["accuracy"] > 0.6
    assert np.isfinite(metrics["loss"])
    assert out["base"]["mota"] > 0.6
    assert out["busca"]["mota"] >= out["base"]["mota"] - 1e-9
    assert out["busca"]["ids"] == 0


@pytest.mark.parametrize("steps,batch", [
    pytest.param(45, 12, marks=pytest.mark.slow),
    (25, 8),
])
def test_training_learns_and_engine_deploys(steps, batch):
    cfg, model, metrics = train_demo_model(steps=steps, batch=batch, seed=3,
                                           device="cpu")
    assert not model.training
    out = run_trained_rescue(cfg, model, num_frames=FRAMES)
    _assert_bars(metrics, out)
    # the rescue is the trained model's: BUSCA keeps the track through
    # the dropout the base tracker loses it in
    assert out["busca"]["fn"] < out["base"]["fn"]

    # the same weights in busca_tpu's engine: the same ids and boxes
    jcfg, params, jres = _jax_busca_results(model)
    res = out["busca"]["results"]
    assert len(res) == len(jres) == FRAMES
    relabel, jrelabel = {}, {}  # both packages count ids process-wide
    for (f, tlwhs, ids, _), (jf, jtlwhs, jids, _) in zip(res, jres):
        assert f == jf
        assert [relabel.setdefault(i, len(relabel)) for i in ids] == \
            [jrelabel.setdefault(i, len(jrelabel)) for i in jids], f
        np.testing.assert_array_equal(np.asarray(tlwhs).reshape(-1, 4),
                                      np.asarray(jtlwhs).reshape(-1, 4),
                                      err_msg=f"frame {f}")
    jout = j_run_trained_rescue(jcfg, params, num_frames=FRAMES)
    for tag in ("base", "busca"):
        for k in ("mota", "idf1", "fn", "ids"):
            assert out[tag][k] == pytest.approx(jout[tag][k]), (tag, k)


def test_demo_cli_refuses_a_missing_card(monkeypatch):
    """The demo runs on the card unless asked for the CPU, and never falls
    back to it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([])
