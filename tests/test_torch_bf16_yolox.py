"""busca_tpu's bfloat16 mode in the port's YOLOX, against busca_tpu on the
CPU: both packages run ``dtype=bfloat16`` on the same float32 parameters
(tests/test_torch_yolox.py's two small models and their weight bridges), on
seeded numpy inputs.

- The raw head outputs and the decoded rows, in bf16 ulps of each map's
  scale (the ulp of its largest magnitude; ``torch_oracles.
  bf16_scale_ulps``): the convolutions and BatchNorms round as flax's do,
  while torch's bf16 SiLU rounds once where XLA's CPU backend rounds per
  step (or, fused under jit, not at all), and the two libraries sum in
  different orders, so a value moves by an ulp here and there and the next
  layers carry it.
- ``yolox_postprocess`` on bf16 rows: equal exactly, rows, ``valid`` and
  the tracker's scores (both select, sort and gather the same bf16 values
  and cast where busca_tpu casts).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from busca_tpu.eval.detector import rows_to_detector_output
from busca_tpu.models.yolox import YOLOX as JYOLOX
from busca_tpu.models.yolox import YoloxConfig as JConfig
from busca_tpu.ops.nms import yolox_postprocess as j_postprocess
from busca_tpu_torch.eval import detector as tdetector
from busca_tpu_torch.models.yolox import YOLOX, YoloxConfig
from busca_tpu_torch.ops.nms import yolox_postprocess
from test_torch_yolox import CONFIGS, _predictions, models  # noqa: F401
from torch_oracles import bf16_scale_ulps

BF16 = "bfloat16"
# measured on these seeds: each level's reg, obj and cls maps within 4 ulps
# of their scale, the decoded rows within 0.5 (their xy columns are the
# grid's and land on the same bf16 values)
YOLOX_ULPS = 8.0


def _ulps(got, want, bound, label):
    ulps, exact = bf16_scale_ulps(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    print(f"{label}: {ulps:.2f} ulps of scale, exact {exact:.3f}")
    assert ulps <= bound, label


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_yolox_bf16_head_and_decode_match_jax(models, name):
    jcfg, variables, tmod32 = models[name]
    d, w, c = CONFIGS[name]
    jcfg = JConfig(depth=d, width=w, num_classes=c, dtype=BF16)
    tmod = YOLOX(YoloxConfig(depth=d, width=w, num_classes=c, dtype=BF16))
    tmod.load_state_dict(tmod32.state_dict())
    tmod.eval()
    hw = (64, 96)
    x = np.random.RandomState(4).randn(1, *hw, 3).astype(np.float32)
    apply = jax.jit(JYOLOX(jcfg).apply, static_argnames=("decode",))
    jraw = apply(variables, jnp.asarray(x), decode=False)
    jrows = apply(variables, jnp.asarray(x))
    assert jrows.dtype == jnp.bfloat16
    with torch.no_grad():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        traw = tmod(xt, decode=False)
        trows = tmod(xt)
    assert trows.dtype == torch.bfloat16  # the decode in the head's dtype
    for lvl, (jmaps, tmaps) in enumerate(zip(jraw, traw)):
        for part, a, b in zip(("reg", "obj", "cls"), jmaps, tmaps):
            assert b.dtype == torch.bfloat16
            _ulps(b.permute(0, 2, 3, 1), a, YOLOX_ULPS,
                  f"{name} level {lvl} {part}")
    _ulps(trows, jrows, YOLOX_ULPS, f"{name} rows")


@pytest.mark.parametrize("num_classes", [1, 2])
def test_postprocess_on_bf16_rows_equals_jax(num_classes):
    """bf16 rows (ties are far more common than in float32): the same
    rows and ``valid`` as busca_tpu, and the rows in float32 (the float32
    class column promotes the concatenation, as jnp's)."""
    pred = _predictions(5, num_classes=num_classes)
    jpred = jnp.asarray(pred).astype(jnp.bfloat16)
    tpred = torch.from_numpy(np.asarray(jpred.astype(jnp.float32))).to(
        torch.bfloat16)
    kw = dict(conf_threshold=0.1, nms_threshold=0.7, max_outputs=256,
              pre_nms_topk=1024)
    want_rows, want_valid = j_postprocess(jpred, num_classes, **kw)
    rows, valid = yolox_postprocess(tpred, num_classes, **kw)
    assert rows.dtype == torch.float32 and want_rows.dtype == jnp.float32
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
    srows, svalid, converged = yolox_postprocess(tpred, num_classes,
                                                 nms_steps=8, **kw)
    assert bool(converged)
    assert torch.equal(srows, rows) and torch.equal(svalid, valid)
    # the detector's output from those rows: the tracker's score is the
    # float32 product of the two bf16 columns, as busca_tpu's
    got = tdetector.rows_to_detector_output(rows.numpy(), valid.numpy(),
                                            None, 1.0)
    want = rows_to_detector_output(np.asarray(want_rows),
                                   np.asarray(want_valid), None, 1.0)
    np.testing.assert_array_equal(got.scores, want.scores)
    np.testing.assert_array_equal(got.boxes_tlbr, want.boxes_tlbr)
