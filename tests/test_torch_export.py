"""The port's ahead-of-time artifacts (busca_tpu_torch/serve/export.py and
serve/detector.py) on the CPU: the cases of tests/test_export.py on the
tiny YOLOX (the loaded program's rows equal the live step's exactly, baked
and unbaked; an unbaked artifact refuses to run without weights; the scorer
round trip against the engine's dedup scoring call; the batch family pads
to its bucket and refuses an oversized batch and a wrong frame size;
``eval.run --detector-artifact`` writes the live ``--detector``'s file,
alone and with ``--lockstep``), the server with ``--detector-artifact
--lockstep``, and

- parity with busca_tpu's artifact: both packages export the same weights
  (the designed colour YOLOX of tests/test_torch_yolox_loop.py) and detect
  the same frames; rows within 1e-4, boxes within 0.1 frame pixels
  (tests/test_torch_yolox.py's bounds: XLA's CPU letterbox can land a
  canvas value 1 LSB off, ROADMAP.md Queue 3);
- the program holds the crop op as one node (K1 on the card) and the
  float32 YOLOX's cuDNN-free convolution, ``aten._convolution`` with
  ``cudnn_enabled`` False;
- a program exported on one device is refused by name on another
  (busca_tpu's cross-platform lowering,
  tests/test_export.py::test_cross_platform_export_lowers_for_tpu, has no
  counterpart: ROADMAP.md Queue 3).
"""

import json
import os
import shutil
import threading
import types

import numpy as np
import pytest
import torch

from busca_tpu_torch.eval.detector import YoloxDetector
from busca_tpu_torch.models.yolox import YoloxConfig
from busca_tpu_torch.serve import (
    ArtifactBatchDetector,
    ArtifactDetector,
    export_associate_scorer,
    export_detector_batch_steps,
    export_detector_step,
    load_artifact,
)
from test_run_cli import mot_fixture  # noqa: F401 (the fixture)
from test_torch_strongsort import one_torch_thread  # noqa: F401
from test_torch_yolox_loop import (
    LOOP_BOX_TOL,
    TEST_SIZE,
    TINY,
    _bf16_frames,
    bright_object_state,
)

FRAME_HW = (64, 80)  # the MOT fixture's frames
DET_TEST_SIZE = (64, 96)
CONF = 0.05
ROW_TOL = 1e-4  # busca_tpu vs the port (tests/test_torch_yolox.py)
SEQ = "MOT17-05-FRCNN"


def _fixture_frames(seq_dir):
    import cv2

    img = os.path.join(seq_dir, "img1")
    return [cv2.imread(os.path.join(img, f)) for f in sorted(os.listdir(img))]


@pytest.fixture(scope="module")
def tiny(mot_fixture, tmp_path_factory):  # noqa: F811
    """The tiny YOLOX the CLI builds (``--detector yolox-tiny``),
    calibrated on the fixture's frames and saved as an official ``.pth``
    (so that the CLI runs track something), its artifacts at the fixture's
    frame size (the baked single-frame step, the unbaked step, an unbaked
    (2, 4) batch family) and the fixture's frames."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("artifacts")
    frames = _fixture_frames(mot_fixture)
    det = YoloxDetector(YoloxConfig.size("tiny", num_classes=1), None,
                        test_size=DET_TEST_SIZE, conf_thresh=CONF,
                        device="cpu", seed=3)
    det.calibrate_random_weights(frames, 1.5, 1.5, (24.0, 12.0))
    ckpt = str(root / "yolox_tiny.pth")
    torch.save({"model": det.model.state_dict()}, ckpt)
    det = YoloxDetector.build("tiny", ckpt_path=ckpt,
                              test_size=DET_TEST_SIZE, conf_thresh=CONF,
                              device="cpu")
    dirs = {k: str(root / k) for k in ("step", "unbaked", "family")}
    manifests = {
        "step": export_detector_step(det, FRAME_HW, dirs["step"]),
        "unbaked": export_detector_step(det, FRAME_HW, dirs["unbaked"],
                                        bake_weights=False),
        "family": export_detector_batch_steps(
            det, FRAME_HW, (2, 4), dirs["family"], bake_weights=False),
    }
    torch.set_num_threads(n)
    return types.SimpleNamespace(det=det, ckpt=ckpt, dirs=dirs,
                                 manifests=manifests, frames=frames)


def _live(det, frame):
    with torch.no_grad():
        canvas, _ = det.prep(torch.from_numpy(frame))
        rows, valid, converged, pred = det.step(canvas)
    return rows, valid, converged, canvas, pred


def _assert_outputs_equal(got, want):
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def _assert_dets_equal(got, want):
    assert len(got.scores) > 0, "nothing detected"
    np.testing.assert_array_equal(got.boxes_tlbr, want.boxes_tlbr)
    np.testing.assert_array_equal(got.scores, want.scores)
    assert torch.equal(got.image, want.image) and got.scale == want.scale


def test_detector_export_roundtrip(tiny, one_torch_thread):  # noqa: F811
    det, dirs, m = tiny.det, tiny.dirs, tiny.manifests["step"]
    assert m["kind"] == "yolox_detector_step" and m["frame_hw"] == [64, 80]
    assert m["device"] == "cpu" and m["bake_weights"] is True
    assert os.path.exists(os.path.join(dirs["step"], "fn.pt2"))
    with open(os.path.join(dirs["step"], "manifest.json")) as f:
        assert json.load(f) == m
    art = load_artifact(dirs["step"], device="cpu")
    frame = tiny.frames[1]
    _assert_outputs_equal(art.call(torch.from_numpy(frame)),
                          _live(det, frame))
    # through the frame loop's API, with the upload handle too
    live = det.detect(frame)
    adet = ArtifactDetector(art, device="cpu")
    for got in (adet.detect(frame), adet.detect(adet.put_frame(frame))):
        _assert_dets_equal(got, live)
    with pytest.raises(ValueError, match="frame_hw"):
        adet.detect(np.zeros((48, 80, 3), np.uint8))


def test_detector_export_unbaked_takes_weights(tiny,
                                               one_torch_thread):  # noqa
    det, dirs, manifests = tiny.det, tiny.dirs, tiny.manifests
    assert manifests["unbaked"]["bake_weights"] is False
    # the program holds no weights: a fraction of the baked one's bytes
    assert manifests["unbaked"]["size_bytes"] < \
        manifests["step"]["size_bytes"] / 4
    art = load_artifact(dirs["unbaked"], device="cpu")
    frame = tiny.frames[2]
    state = dict(det.model.state_dict())
    _assert_outputs_equal(art.call(state, torch.from_numpy(frame)),
                          _live(det, frame))
    with pytest.raises(ValueError, match="without baked weights"):
        ArtifactDetector(dirs["unbaked"], device="cpu")
    got = ArtifactDetector(dirs["unbaked"], variables=state,
                           device="cpu").detect(frame)
    _assert_dets_equal(got, det.detect(frame))


def test_batch_steps_family_pads_and_refuses(tiny,
                                             one_torch_thread):  # noqa
    """3 frames go through bucket 4 with the last frame repeated, 1 through
    bucket 2: the live batch step over the same padded batch, exactly (on
    the CPU a batch's size may change a frame's last bits; the card's
    float32 YOLOX is batch-invariant); 5 frames and another frame size are
    refused."""
    det, dirs, m = tiny.det, tiny.dirs, tiny.manifests["family"]
    assert m["batches"] == [2, 4] and set(m["size_bytes"]) == {"2", "4"}
    with pytest.raises(ValueError, match="without baked weights"):
        ArtifactBatchDetector(dirs["family"], device="cpu")
    art = ArtifactBatchDetector(dirs["family"],
                                variables=det.model.state_dict(),
                                device="cpu")
    calls = []
    for b, step in art._steps.items():
        orig = step.call
        step.call = (lambda *a, _b=b, _o=orig: calls.append(_b) or _o(*a))
    frames = np.stack(tiny.frames[:3])
    want = det.detect_batch(np.concatenate([frames, frames[-1:]]))
    got = art.detect_batch(frames)
    assert calls == [4] and len(got) == 3
    for g, w in zip(got, want):
        _assert_dets_equal(g, w)
    want = det.detect_batch(np.stack([frames[0]] * 2))
    _assert_dets_equal(art.detect(frames[0]), want[0])
    # the frame loop's upload handle (an eval run without --lockstep)
    _assert_dets_equal(art.detect(art.put_frame(frames[0])), want[0])
    assert calls == [4, 2, 2]
    with pytest.raises(ValueError, match="largest exported bucket"):
        art.detect_batch(np.stack(tiny.frames[:5]))
    with pytest.raises(ValueError, match="frame_hw"):
        art.detect_batch(np.zeros((2, 48, 80, 3), np.uint8))


def test_associate_scorer_export_roundtrip(tmp_path,
                                           one_torch_thread):  # noqa
    """The scorer program against the engine's dedup scoring call
    (``_score_bucketed_unique``'s ``_probs``), baked and unbaked, on a
    one-layer engine (tests/test_torch_snapshot.py's)."""
    from busca_tpu_torch.assoc.engine import AssociationEngine
    from busca_tpu_torch.models.busca import BuscaConfig, BuscaModel

    h, w, seq_len, c = 32, 16, 3, 2
    cfg = BuscaConfig(num_layer=1, reid_num_classes=5,
                      reid_layers=(1, 1, 1, 1))
    model = BuscaModel(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    engine = AssociationEngine(cfg, model.eval(), seq_len=seq_len,
                               num_candidates=c, crop_hw=(h, w))
    rng = np.random.RandomState(3)
    b, u_pad = 4, 8
    mem = rng.randint(0, 255, (b, seq_len, h, w, 3)).astype(np.uint8)
    uniq = np.zeros((u_pad, h, w, 3), np.uint8)
    uniq[1:4] = rng.randint(0, 255, (3, h, w, 3))
    weights = np.zeros(u_pad, np.float32)
    weights[:4] = [2.0, 1.0, 1.0, 2.0]
    gather = rng.randint(0, 4, (b, c)).astype(np.int32)
    mem_boxes = rng.uniform(0, 50, (b, seq_len, 4)).astype(np.float32)
    can_boxes = rng.uniform(0, 50, (b, c, 4)).astype(np.float32)
    mask = np.array([1, 1, 1, 0], np.float32)
    want = engine._probs(torch.from_numpy(mem), torch.from_numpy(uniq),
                         mem_boxes, can_boxes, mask, True,
                         can_weights=weights, can_gather=gather)
    args = [torch.from_numpy(a) for a in (mem, uniq, weights, gather,
                                          mem_boxes, can_boxes, mask)]
    m = export_associate_scorer(engine, b, u_pad, str(tmp_path / "assoc"))
    assert (m["kind"], m["bucket"], m["u_pad"], m["seq_len"]) == (
        "associate_score_unique", b, u_pad, seq_len)
    got = load_artifact(str(tmp_path / "assoc"), device="cpu").call(*args)
    np.testing.assert_array_equal(got.numpy(), want)
    export_associate_scorer(engine, b, u_pad, str(tmp_path / "unbaked"),
                            bake_weights=False)
    got = load_artifact(str(tmp_path / "unbaked")).call(
        dict(engine.model.state_dict()), *args)
    np.testing.assert_array_equal(got.numpy(), want)


def test_program_holds_the_crop_op_and_the_gemm_convolution(tiny):
    """The traced step calls the registered crop op (so the program
    launches K1 on the card), and ``gemm_conv2d`` stays
    ``aten._convolution`` with cuDNN off through export."""
    from busca_tpu_torch.models.precision import Conv2d, gemm_conv2d

    program = load_artifact(tiny.dirs["step"]).program
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets.count("busca_tpu_torch.crop_resize.default") == 1

    class Gemm(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = Conv2d(3, 4, 3, padding=1)

        def forward(self, x):
            return gemm_conv2d(self.conv, x)

    ep = torch.export.export(Gemm(), (torch.randn(1, 3, 8, 8),))
    convs = [n for n in ep.graph.nodes if n.op == "call_function"
             and "conv" in str(n.target)]
    assert [str(n.target) for n in convs] == ["aten._convolution.default"]
    assert convs[0].args[11] is False  # cudnn_enabled


def test_artifact_refused_on_another_device(tiny):
    dirs = tiny.dirs
    for make in (lambda: ArtifactDetector(dirs["step"], device="cuda"),
                 lambda: ArtifactBatchDetector(dirs["family"],
                                               device="cuda"),
                 lambda: load_artifact(dirs["step"], device="cuda")):
        with pytest.raises(ValueError,
                           match="exported on 'cpu' and cannot run on "
                                 "'cuda'"):
            make()


def test_artifact_matches_busca_tpu_artifact(tmp_path,
                                             one_torch_thread):  # noqa
    """busca_tpu's and the port's artifacts exported from the same weights
    (the designed colour YOLOX) detect the same frames."""
    from busca_tpu.eval import detector as jdetector
    from busca_tpu.models.yolox import YoloxConfig as JConfig
    from busca_tpu.models.yolox import convert_yolox_state_dict
    from busca_tpu.serve.export import export_detector_step as jexport
    from busca_tpu.serve.export import load_artifact as jload

    d, w, c = TINY
    sd = bright_object_state(YoloxConfig(d, w, c))
    jcfg = JConfig(depth=d, width=w, num_classes=c)
    kw = dict(test_size=TEST_SIZE, conf_thresh=CONF, nms_thresh=0.7,
              max_outputs=32)
    jdet = jdetector.YoloxDetector(jcfg, convert_yolox_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jcfg), **kw)
    tdet = YoloxDetector(YoloxConfig(d, w, c), sd, device="cpu", **kw)
    frames = _bf16_frames()
    hw = frames[0].shape[:2]
    jexport(jdet, hw, str(tmp_path / "j"))
    export_detector_step(tdet, hw, str(tmp_path / "t"))
    jart = jload(str(tmp_path / "j"))
    tart = ArtifactDetector(str(tmp_path / "t"), device="cpu")
    n = 0
    for frame in frames:
        jrows, jvalid, _ = (np.asarray(a) for a in jart.call(frame))
        trows, tvalid, _, _, _ = tart._art.call(torch.from_numpy(frame))
        np.testing.assert_array_equal(tvalid.numpy(), jvalid)
        np.testing.assert_allclose(trows.numpy()[:, 4:], jrows[:, 4:],
                                   rtol=0, atol=ROW_TOL)
        got = tart.detect(frame)
        want = jdetector.rows_to_detector_output(jrows, jvalid, None,
                                                 tart.scale)
        np.testing.assert_allclose(got.boxes_tlbr / got.scale,
                                   want.boxes_tlbr / want.scale, rtol=0,
                                   atol=LOOP_BOX_TOL)
        n += len(got.scores)
    assert n > 0, "the designed detector detected nothing"


# --------------------------------- the CLIs ---------------------------------

def _eval_main(argv):
    """The port's eval CLI on the CPU, the track ids counted from 1."""
    from busca_tpu_torch.eval.run import main
    from busca_tpu_torch.trackers.base import Track

    Track.reset_id_counter()
    return main(argv + ["--device", "cpu"])


def _second_sequence(seq_dir, tmp_path):
    """A copy of the fixture sequence under another name (a lockstep
    group of two at one resolution)."""
    other = str(tmp_path / "MOT17-09-FRCNN")
    shutil.copytree(seq_dir, other)
    ini = os.path.join(other, "seqinfo.ini")
    with open(ini) as f:
        text = f.read().replace(SEQ, "MOT17-09-FRCNN")
    with open(ini, "w") as f:
        f.write(text)
    return other


def _read(path):
    with open(path) as f:
        return f.read()


def test_cli_detector_artifact_matches_live(tiny, mot_fixture,  # noqa
                                            tmp_path, one_torch_thread):
    """``--detector-artifact`` writes the live ``--detector`` run's file
    (the same calibrated weights on both sides)."""
    ckpt, dirs = tiny.ckpt, tiny.dirs
    live = ["--mot-dir", mot_fixture, "--detector", "yolox-tiny",
            "--detector-ckpt", ckpt, "--test-h", "64", "--test-w", "96",
            "--det-conf", str(CONF)]
    out_live = _eval_main(live + ["--output-dir", str(tmp_path / "live")])
    out_art = _eval_main(["--mot-dir", mot_fixture, "--detector-artifact",
                          dirs["step"], "--output-dir",
                          str(tmp_path / "art")])
    assert out_live.keys() == out_art.keys()
    text = _read(tmp_path / "live" / f"{SEQ}.txt")
    assert text and text == _read(tmp_path / "art" / f"{SEQ}.txt")


def test_cli_lockstep_batch_artifact(tiny, mot_fixture, tmp_path,  # noqa
                                     monkeypatch, one_torch_thread):
    """``--lockstep --detector-artifact`` with a batch family (unbaked:
    the weights come from the checkpoint) writes the live lockstep run's
    files for a group of two sequences."""
    import busca_tpu_torch.serve.server as server_mod

    det, ckpt, dirs = tiny.det, tiny.ckpt, tiny.dirs
    seqs = [mot_fixture, _second_sequence(mot_fixture, tmp_path)]
    _eval_main(["--mot-dir", *seqs, "--detector", "yolox-tiny",
                "--detector-ckpt", ckpt, "--test-h", "64", "--test-w", "96",
                "--det-conf", str(CONF), "--lockstep", "--output-dir",
                str(tmp_path / "live")])
    state = det.model.state_dict()
    monkeypatch.setattr(server_mod, "load_artifact_detector",
                        lambda d, device: ArtifactBatchDetector(
                            d, variables=state, device=device))
    _eval_main(["--mot-dir", *seqs, "--detector-artifact", dirs["family"],
                "--lockstep", "--output-dir", str(tmp_path / "art")])
    for name in (SEQ, "MOT17-09-FRCNN"):
        text = _read(tmp_path / "live" / f"{name}.txt")
        assert text and text == _read(tmp_path / "art" / f"{name}.txt")


def test_clis_refuse_lockstep_with_a_single_step(tiny, mot_fixture,  # noqa
                                                 capsys):
    from busca_tpu_torch.serve import server as server_mod

    dirs = tiny.dirs
    with pytest.raises(SystemExit):
        _eval_main(["--mot-dir", mot_fixture, "--detector-artifact",
                    dirs["step"], "--lockstep"])
    assert "needs a --batches artifact family" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        _eval_main(["--mot-dir", mot_fixture, "--detector-artifact",
                    dirs["step"], "--detector", "yolox-tiny"])
    assert "--detector-artifact replaces --detector" in \
        capsys.readouterr().err
    with pytest.raises(SystemExit):
        server_mod.main(["--socket", "/tmp/x.sock", "--detector-artifact",
                         dirs["step"], "--lockstep", "--device", "cpu"])
    assert "needs a batch-capable detector" in capsys.readouterr().err


def test_server_artifact_lockstep(tiny, tmp_path, monkeypatch,
                                  one_torch_thread):  # noqa: F811
    """``serve.server --detector-artifact FAMILY --lockstep --device cpu``:
    two clients at once, every tick full; each stream's replies equal the
    in-process lockstep loop over the live detector (ids relabelled by
    first appearance)."""
    from concurrent.futures import ThreadPoolExecutor

    from busca_tpu_torch.eval.detector import track_sequences_lockstep
    from busca_tpu_torch.eval.run import make_tracker
    from busca_tpu_torch.serve import server as server_mod
    from busca_tpu_torch.trackers.base import Track
    from test_torch_lockstep import _canon
    from test_torch_server import _wait_for_socket

    det, dirs = tiny.det, tiny.dirs
    state = det.model.state_dict()
    monkeypatch.setattr(server_mod, "load_artifact_detector",
                        lambda d, device: ArtifactBatchDetector(
                            d, variables=state, device=device))
    path = str(tmp_path / "art.sock")
    t = threading.Thread(target=server_mod.main, args=([
        "--socket", path, "--detector-artifact", dirs["family"],
        "--lockstep", "--tick-timeout", "1.0", "--track-thresh", "0.3",
        "--device", "cpu", "--max-connections", "2"],), daemon=True)
    t.start()
    frames = [tiny.frames, tiny.frames[::-1]]
    barrier = threading.Barrier(2)

    def stream(si):
        client = _wait_for_socket(path)
        assert client.start(f"s{si}")["ok"]
        out = []
        for f in frames[si]:
            barrier.wait(timeout=60)
            out.append(client.frame(f))
        client.stop()
        return out

    with ThreadPoolExecutor(2) as pool:
        got = list(pool.map(stream, range(2)))
    t.join(timeout=60)
    assert not t.is_alive()
    assert all(r["ok"] and r["batch"] == 2 for rs in got for r in rs), got
    Track.reset_id_counter()
    want = track_sequences_lockstep(
        det, [make_tracker("byte", {"track_thresh": 0.3}, None)
              for _ in frames], [iter(f) for f in frames])
    for si in range(2):
        rows = [(r["frame_id"], [tr["tlwh"] for tr in r["tracks"]],
                 [tr["id"] for tr in r["tracks"]], []) for r in got[si]]
        assert _canon(rows) == _canon(want[si].results), f"stream {si}"
    assert sum(len(r["tracks"]) for rs in got for r in rs) > 0
