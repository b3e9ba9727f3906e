"""The YOLOX path on the card: K1 at the YOLOX letterbox shape, the YOLOX
step against the same weights on the CPU, and the enqueue-only step.  These
need an NVIDIA GPU and skip without one; ``python3 chip_smoke.py`` phase 7
runs the same checks at full size inside the loop.

Tolerances: K1 exact (its plain version's float32 operations in the same
order, built with -fmad=false); the YOLOX step's raw head outputs and
decoded rows within 1e-3 of max |diff| / (1 + |want|) (float32 with TF32
off, cuDNN's and the CPU's reduction orders), the smoke's bar.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

LETTERBOX_KW = dict(normalize=False, bgr_input=True, rgb_output=False,
                    quantize_uint8=True)
TOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the YOLOX path's kernel K1 is CUDA: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _frames(n, hw=(1080, 1920)):
    from busca_tpu_torch.eval.synthetic import (
        SyntheticSequence,
        default_dropout_sequence,
    )

    base = default_dropout_sequence(40)
    seq = SyntheticSequence(base.objects, num_frames=base.num_frames,
                            height=hw[0], width=hw[1], seed=base.seed)
    return [seq.frame(t) for t in range(n)]


def test_k1_at_the_yolox_letterbox_equals_plain(cuda):
    from busca_tpu_torch.ops.crop import crop_resize_normalize_plain
    from busca_tpu_torch.ops.crop_cuda import crop_resize_cuda

    rng = np.random.RandomState(3)
    frame = torch.from_numpy(
        rng.randint(0, 256, (1080, 1920, 3), dtype=np.uint8)).to(cuda)
    box = torch.tensor([[0.0, 0.0, 1920.0, 1080.0]], device=cuda)
    got = crop_resize_cuda(frame, box, (800, 1422), **LETTERBOX_KW)
    want = crop_resize_normalize_plain(frame, box, (800, 1422),
                                       **LETTERBOX_KW)
    assert got.shape == (1, 800, 1422, 3)
    assert torch.equal(got, want)


def _detector(device, test_size, state=None):
    from busca_tpu_torch.eval.detector import YoloxDetector
    from busca_tpu_torch.models.yolox import YoloxConfig

    return YoloxDetector(YoloxConfig.size("x"), state, test_size=test_size,
                         conf_thresh=0.3, device=device, seed=0)


def test_yolox_step_on_the_card_matches_the_cpu(cuda):
    from busca_tpu_torch.eval.detector import normalize_canvas
    from busca_tpu_torch.models.yolox import decode_outputs

    frames = _frames(4, (270, 480))
    det = _detector(cuda, (128, 224))
    det.calibrate_random_weights(frames, 0.0, 4.0, (40.0, 16.0))
    cpu = _detector("cpu", (128, 224), {
        k: v.cpu() for k, v in det.model.state_dict().items()})
    canvas, _ = cpu.prep(torch.as_tensor(frames[0]))
    x = normalize_canvas(canvas, cpu._mean, cpu._std).permute(2, 0, 1)[None]
    with torch.no_grad():
        want = cpu.model(x, decode=False)
        got = det.model(x.to(cuda), decode=False)
    pairs = [(g, w) for gs, ws in zip(got, want) for g, w in zip(gs, ws)]
    pairs.append((decode_outputs(got, (8, 16, 32)),
                  decode_outputs(want, (8, 16, 32))))
    for g, w in pairs:
        err = float(((g.cpu() - w).abs() / (1.0 + w.abs())).max())
        assert err <= TOL
    # the canvas itself: K1's letterbox equals the CPU's plain one
    card_canvas, _ = det.prep(torch.as_tensor(frames[0]).to(cuda))
    assert torch.equal(card_canvas.cpu(), canvas)


def test_detect_async_enqueues_without_a_host_sync(cuda):
    frames = _frames(2, (540, 960))
    det = _detector(cuda, (416, 736))
    det.calibrate_random_weights(frames, 0.0, 4.0, (100.0, 40.0))
    det.detect(frames[0])  # warm: K1 built, letterbox box cached
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = det.detect_async(det.put_frame(frames[1]))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out = det.wait(handle)
    assert out.image.is_cuda and out.image.shape == (416, 736, 3)
    again = det.detect(frames[1])
    np.testing.assert_array_equal(out.boxes_tlbr, again.boxes_tlbr)
    np.testing.assert_array_equal(out.scores, again.scores)
