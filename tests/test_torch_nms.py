"""The port's static-size NMS (busca_tpu_torch/ops/nms.py) against
busca_tpu.ops.nms.nms on the same seeded boxes: clustered boxes (so that
suppression chains form), tied scores and -inf rows.  Indices and the valid
mask must be equal exactly.
"""

import numpy as np
import pytest
import torch

from busca_tpu.core.boxes import iou_matrix_std as j_iou_matrix_std
from busca_tpu.ops.nms import nms as j_nms
from busca_tpu_torch.ops.nms import iou_matrix_std, nms


def _boxes(seed, n=96):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(0, 200, (8, 2))
    c = centers[rng.randint(0, 8, n)] + rng.normal(0, 6, (n, 2))
    wh = rng.uniform(10, 60, (n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    # scores on a coarse grid: many exact ties
    scores = (rng.randint(0, 12, n) / 12.0).astype(np.float32)
    scores[rng.rand(n) < 0.2] = -np.inf
    boxes[5] = boxes[4]  # an identical pair with equal scores
    scores[5] = scores[4] = 0.5
    return boxes, scores


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("iou_thr,max_outputs", [(0.7, 64), (0.3, 32),
                                                 (0.5, 128)])
def test_nms_equals_jax(seed, iou_thr, max_outputs):
    boxes, scores = _boxes(seed)
    want_idx, want_valid = j_nms(boxes, scores, iou_thr, max_outputs)
    idx, valid = nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                     iou_thr, max_outputs)
    assert idx.dtype == torch.int32 and idx.shape == (max_outputs,)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert 0 < int(valid.sum()) < (scores > -np.inf).sum()


def test_nms_all_masked():
    boxes, _ = _boxes(3, n=8)
    scores = np.full(8, -np.inf, np.float32)
    idx, valid = nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5,
                     4)
    assert not valid.any() and (idx == -1).all()


def test_iou_matrix_std_equals_jax():
    boxes, _ = _boxes(4, n=32)
    boxes[7] = [3.0, 3.0, 3.0, 9.0]  # zero area
    want = np.asarray(j_iou_matrix_std(boxes, boxes))
    got = iou_matrix_std(torch.from_numpy(boxes), torch.from_numpy(boxes))
    np.testing.assert_array_equal(got.numpy(), want)
