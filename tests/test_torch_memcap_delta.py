"""The port's bounded-memory deviation harness (eval/memcap_delta.py) on
the CPU: both cases of tests/test_memcap_delta.py, at a small size (a few
training steps; the JAX suite runs them as ``slow`` tests), and the CLI.
"""

import numpy as np

from busca_tpu_torch.eval.memcap_delta import main, measure_memcap_delta
from test_torch_strongsort import one_torch_thread  # noqa: F401


def test_measure_memcap_delta_report_shape():
    out = measure_memcap_delta(caps=(8,), steps=4, train_batch=4, seed=3,
                               num_frames=40, seq_seeds=(0,), device="cpu")
    assert set(out["metrics"]) == {"unbounded", "cap8"}
    for tag, m in out["metrics"].items():
        assert np.isfinite([m["mota"], m["hota"], m["idf1"]]).all(), tag
    assert set(out["delta"]) == {"cap8"}
    assert set(out["delta"]["cap8"]) == {"mota", "idf1", "hota", "fn", "ids"}
    dv = out["divergence"]["cap8"]
    assert dv["diff_frames_total"] >= 0
    assert dv["first_diff_frame"] is None or (
        0 <= dv["first_diff_frame"] <= 40)


def test_broader_arm_divergence_onset_respects_cap():
    """With the broader-memory sampler (the one consumer of the compacted
    archive) a capped run may diverge from the unbounded one, but never
    before a track's admissions exceed the cap; the capped run's realized
    compaction state is reported."""
    cap = 8
    out = measure_memcap_delta(caps=(cap,), steps=4, train_batch=4,
                               num_frames=50, seq_seeds=(0,),
                               long_stream=True, use_broader_memory=True,
                               device="cpu")
    dv = out["divergence"][f"cap{cap}"]
    first = dv["first_diff_frame"]
    assert first is None or first > cap, dv
    m = out["metrics"][f"cap{cap}"]
    assert m["max_mem_len"] <= cap < m["max_admissions"]
    assert m["max_stride"] >= 2


def test_memcap_delta_cli(capsys):
    """``python -m busca_tpu_torch.eval.memcap_delta --device cpu`` prints
    a line per arm and per cap, and the JSON record."""
    out = main(["--frames", "30", "--caps", "8", "--seeds", "1", "--steps",
                "3", "--device", "cpu"])
    assert out["caps"] == [8]
    text = capsys.readouterr().out
    assert "cap8-unbounded delta" in text and "unbounded  MOTA=" in text
