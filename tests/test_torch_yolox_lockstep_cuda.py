"""The lockstep batch step on the card: ``detect_batch_async`` enqueues
without a host sync, and through the float32 GEMM convolutions each frame
of a batch gets the single-frame step's rows and detections bit for bit.
These need an NVIDIA GPU and skip without one; ``python3 chip_smoke.py``
phase 12 runs the same checks on the full-width YOLOX-X inside the
lockstep loop.
"""

import numpy as np
import pytest
import torch

from test_torch_yolox_cuda import _detector, _frames, cuda  # noqa: F401

pytestmark = pytest.mark.cuda


def test_batch_step_equals_single_frame_step(cuda):  # noqa: F811
    frames = _frames(4, (540, 960))
    det = _detector(cuda, (416, 736))
    det.calibrate_random_weights(frames, 0.0, 4.0, (100.0, 40.0))
    batch = np.stack(frames)
    det.wait_batch(det.detect_batch_async(batch))  # warm at this batch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = det.detect_batch_async(batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    outs = det.wait_batch(handle)
    for i, frame in enumerate(frames):
        single = det.detect(frame)
        assert outs[i].image.is_cuda and outs[i].image.is_contiguous()
        assert torch.equal(outs[i].image, single.image)
        with torch.no_grad():
            assert torch.equal(handle.pred[i], det.forward(single.image))
        np.testing.assert_array_equal(outs[i].boxes_tlbr, single.boxes_tlbr)
        np.testing.assert_array_equal(outs[i].scores, single.scores)
