"""The ByteTrack + BUSCA loop of the port against busca_tpu, frame by frame,
on the CPU: the 40-frame synthetic dropout sequence, a small BUSCA model
(ResNet (1,1,1,1), d=64, 2 layers, 64x32 crops) with weights shared through
the weight bridge, ECC camera-motion compensation on in both.

Track ids and boxes must be equal on every frame; third-round probabilities
must agree within 0.0242, the measured crop-noise tail of the JAX pipeline
fuzz (tests/test_pipeline_fuzz.py::test_byte_pipeline_fuzz_noise_tail); the
``run_synthetic`` metric dicts must be equal (all but the wall-clock fps).
"""

import types

import jax
import numpy as np
import pytest

from busca_tpu.assoc.bank import DeviceCropBank as JBank
from busca_tpu.assoc.engine import AssociationEngine as JEngine
from busca_tpu.eval import run as jrun
from busca_tpu.eval.synthetic import default_dropout_sequence
from busca_tpu.models.busca import BuscaConfig as JCfg
from busca_tpu.models.busca import BuscaModel as JModel
from busca_tpu.trackers.base import Track as JTrack
from busca_tpu.trackers.byte import ByteTracker as JByte
from busca_tpu.trackers.byte import ByteTrackerConfig as JByteCfg
from busca_tpu_torch.assoc.bank import DeviceCropBank
from busca_tpu_torch.assoc.engine import AssociationEngine
from busca_tpu_torch.eval import run as trun
from busca_tpu_torch.models.busca import BuscaConfig, BuscaModel
from busca_tpu_torch.models.convert import load_into, state_dict_from_flax
from busca_tpu_torch.trackers.base import Track
from busca_tpu_torch.trackers.byte import ByteTracker, ByteTrackerConfig

CROP_HW = (64, 32)
N_FRAMES = 40
PROB_TOL = 0.0242
SMALL = dict(num_layer=2, nhead=4, trans_dim=64, ff_size=128,
             reid_layers=(1, 1, 1, 1), reid_num_classes=7)


@pytest.fixture(scope="module")
def engines():
    cfg = JCfg(**SMALL)
    h, w = CROP_HW
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        JModel(cfg).init)(
        jax.random.PRNGKey(5),
        np.zeros((1, 11, h, w, 3), np.float32),
        np.zeros((1, 5, h, w, 3), np.float32),
        np.zeros((1, 11, 4), np.float32),
        np.zeros((1, 5, 4), np.float32),
    ))
    # random decoder weights saturate the softmax; shrink them so that the
    # probabilities are spread over the choices and the Kalman candidate
    # clears busca_thresh on some frames (both pipelines share the values)
    dec = variables["params"]["decoder_linear"]
    dec["weight"] = dec["weight"] * np.float32(0.02)
    model = BuscaModel(BuscaConfig(**SMALL))
    load_into(model, state_dict_from_flax(variables))
    jeng = JEngine(cfg, {"params": variables["params"]}, crop_hw=CROP_HW,
                   bank=JBank(CROP_HW, 256))
    teng = AssociationEngine(BuscaConfig(**SMALL), model, crop_hw=CROP_HW,
                             bank=DeviceCropBank(CROP_HW, 256, "cpu"))
    return jeng, teng


def _logged(engine, log):
    orig = engine.associate

    def associate(*a, **k):
        out = orig(*a, **k)
        log.append(None if out[0] is None else np.array(out[0]))
        return out

    engine.associate = associate
    return orig


def test_byte_busca_frame_by_frame(engines):
    jeng, teng = engines
    seq = default_dropout_sequence(N_FRAMES)
    # continuous probabilities (no one-hot) and a threshold the random
    # weights reach, so that rescues happen and probabilities are compared
    kw = dict(use_busca=True, crop_hw=CROP_HW, busca_thresh=0.1,
              select_highest_candidate=False)
    JTrack.reset_id_counter()
    Track.reset_id_counter()
    jtrk = JByte(JByteCfg(**kw), jeng)
    ttrk = ByteTracker(ByteTrackerConfig(**kw), teng)
    jlog, tlog = [], []
    jorig, torig = _logged(jeng, jlog), _logged(teng, tlog)
    third_rounds = rescued = 0
    try:
        for t in range(N_FRAMES):
            frame = seq.frame(t)
            boxes, scores = seq.detections(t)
            n_log = len(jlog)
            jout = jtrk.update(boxes.copy(), scores.copy(), 1.0, frame)
            tout = ttrk.update(boxes.copy(), scores.copy(), 1.0, frame)
            assert [x.track_id for x in tout] == [x.track_id for x in jout], \
                f"frame {t + 1}: ids diverged"
            for a, b in zip(tout, jout):
                np.testing.assert_array_equal(a.tlwh, b.tlwh,
                                              err_msg=f"frame {t + 1}")
            assert len(tlog) == len(jlog), f"frame {t + 1}"
            for pt, pj in zip(tlog[n_log:], jlog[n_log:]):
                assert (pt is None) == (pj is None)
                if pj is not None:
                    third_rounds += 1
                    np.testing.assert_allclose(pt, pj, rtol=0, atol=PROB_TOL,
                                               err_msg=f"frame {t + 1}")
            if not seq.objects[0].detected_at(t):
                # the dropped object's track kept alive by the third round
                rescued += len(tout) == 2
    finally:
        jeng.associate, teng.associate = jorig, torig
    assert third_rounds >= 5, "the dropout never reached the third round"
    assert rescued >= 1, "the third round never kept a track alive"


def test_run_synthetic_metrics_equal(engines):
    jeng, teng = engines
    args = types.SimpleNamespace(tracker="byte", num_frames=N_FRAMES,
                                 crop_hw=CROP_HW)
    JTrack.reset_id_counter()
    want = jrun.run_synthetic(args, jeng, {"use_busca": True})
    Track.reset_id_counter()
    got = trun.run_synthetic(args, teng, {"use_busca": True})
    assert set(got) == set(want) == {"base", "busca"}
    for tag in ("base", "busca"):
        got[tag].pop("fps")
        want[tag].pop("fps")
        assert got[tag] == want[tag], tag
