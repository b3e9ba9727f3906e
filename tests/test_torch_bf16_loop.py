"""busca_tpu's bfloat16 mode through the port's ByteTrack + BUSCA loop, on
the CPU: tests/test_torch_byte_pipeline.py's small engine (ResNet (1,1,1,1),
d=64, 2 layers, 64x32 crops) in bf16 in both packages, on the same float32
weights, over the 40-frame synthetic dropout sequence.

Ids and boxes must be equal on every frame, and the third-round
probabilities within 0.12 (tests/test_bf16.py's bar; the measured
|delta p|, pinned below it, is in tests/test_torch_bf16.py); the
``run_synthetic`` metric dicts (all but the wall-clock fps) must be equal.
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
from test_torch_bf16 import BF16, PROB_BAR, PROB_PIN, _np_tree
from test_torch_byte_pipeline import CROP_HW, N_FRAMES, SMALL


@pytest.fixture(scope="module")
def bf16_engines():
    """tests/test_torch_byte_pipeline.py's engines, in bf16."""
    h, w = CROP_HW
    variables = _np_tree(jax.jit(JModel(JCfg(**SMALL)).init)(
        jax.random.PRNGKey(5),
        np.zeros((1, 11, h, w, 3), np.float32),
        np.zeros((1, 5, h, w, 3), np.float32),
        np.zeros((1, 11, 4), np.float32),
        np.zeros((1, 5, 4), np.float32),
    ))
    dec = variables["params"]["decoder_linear"]
    dec["weight"] = dec["weight"] * np.float32(0.02)
    cfg = BuscaConfig(**SMALL, dtype=BF16)
    model = BuscaModel(cfg)
    load_into(model, state_dict_from_flax(variables))
    jeng = JEngine(JCfg(**SMALL, dtype=BF16),
                   {"params": variables["params"]}, crop_hw=CROP_HW,
                   bank=JBank(CROP_HW, 256))
    teng = AssociationEngine(cfg, model, crop_hw=CROP_HW,
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


def test_byte_busca_bf16_frame_by_frame(bf16_engines):
    jeng, teng = bf16_engines
    seq = default_dropout_sequence(N_FRAMES)
    kw = dict(use_busca=True, crop_hw=CROP_HW, busca_thresh=0.1,
              select_highest_candidate=False)
    JTrack.reset_id_counter()
    Track.reset_id_counter()
    jtrk = JByte(JByteCfg(**kw), jeng)
    ttrk = ByteTracker(ByteTrackerConfig(**kw), teng)
    jlog, tlog = [], []
    jorig, torig = _logged(jeng, jlog), _logged(teng, tlog)
    worst = 0.0
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
                    worst = max(worst, float(np.abs(pt - pj).max()))
    finally:
        jeng.associate, teng.associate = jorig, torig
    print(f"bf16 loop: {len(tlog)} third rounds, max |dp| {worst:.3g}")
    assert len(tlog) >= 5, "the dropout never reached the third round"
    assert worst <= min(PROB_BAR, PROB_PIN)


def test_run_synthetic_bf16_metrics_equal(bf16_engines):
    jeng, teng = bf16_engines
    args = types.SimpleNamespace(tracker="byte", num_frames=N_FRAMES,
                                 crop_hw=CROP_HW)
    JTrack.reset_id_counter()
    want = jrun.run_synthetic(args, jeng, {"use_busca": True})
    Track.reset_id_counter()
    got = trun.run_synthetic(args, teng, {"use_busca": True})
    for tag in ("base", "busca"):
        got[tag].pop("fps")
        want[tag].pop("fps")
        assert got[tag] == want[tag], tag
