"""``--lockstep``, ``--mem-cap``, ``--reid-stats`` and ``--lockstep-dp`` of
both packages' eval CLIs on the CPU (the lockstep cases of
tests/test_torch_run_cli.py's comparisons).

Two one-object MOTChallenge sequences of 8 and 6 frames (the lockstep
fixture of tests/test_torch_lockstep.py: JPEG frames, det.txt, gt, and
deep_sort ``.npy`` artifacts), run through ``busca_tpu.eval.run.main`` and
``busca_tpu_torch.eval.run.main`` with ``--lockstep``: the result files
must be identical and the accumulated CLEAR equal, over det.txt (BYTE,
GHOST, StrongSORT, SORT, and BYTE with the small BUSCA model in float32 and
``--mem-cap``), StrongSORT's ``--npy-det`` and the live tiny YOLOX (frames
and ids equal, boxes within the loop test's bound plus one printed step).
Each lockstep file also equals the port's run without ``--lockstep``.
"""

import os

import numpy as np
import pytest
import torch

from busca_tpu.eval import run as jrun
from busca_tpu.eval.synthetic import default_dropout_sequence
from busca_tpu_torch.eval import run as trun
from busca_tpu_torch.models.yolox import YoloxConfig
from test_run_cli import mot_fixture  # noqa: F401 (the fixture)
from test_torch_byte_pipeline import CROP_HW
from test_torch_lockstep import _write_sequence
from test_torch_run_cli import (  # noqa: F401 (the fixture)
    _reset_jax_ids,
    _reset_torch_ids,
    artifacts,
)
from test_torch_strongsort import one_torch_thread  # noqa: F401
from test_torch_yolox_loop import LOOP_BOX_TOL, calibrated_state

NAMES = ("MOT17-02-FRCNN", "MOT17-04-FRCNN")


@pytest.fixture(scope="module")
def two_sequences(tmp_path_factory):
    """Two det.txt sequences of 8 and 6 frames and their ``.npy``
    artifacts in one directory."""
    root = tmp_path_factory.mktemp("lockstep")
    dirs = [_write_sequence(root, name, si + 2, [80 + 70 * si, 160, 110],
                            30 + 60 * si, n=8 - 2 * si, features=True)
            for si, name in enumerate(NAMES)]
    return dirs, str(root)


def _run(main, dirs, out, argv, reset):
    reset()
    per_seq = main(["--mot-dir", *dirs, "--output-dir", str(out)] + argv)
    texts = []
    for d in dirs:
        with open(os.path.join(out, os.path.basename(d) + ".txt")) as f:
            texts.append(f.read())
    return texts, per_seq


def _both(dirs, tmp_path, argv):
    """The port's lockstep and sequential runs and busca_tpu's lockstep
    run of ``argv``."""
    cpu = ["--device", "cpu"]
    return (_run(trun.main, dirs, tmp_path / "lock", argv + ["--lockstep"]
                 + cpu, _reset_torch_ids),
            _run(trun.main, dirs, tmp_path / "seq", argv + cpu,
                 _reset_torch_ids),
            _run(jrun.main, dirs, tmp_path / "jax", argv + ["--lockstep"],
                 _reset_jax_ids))


def _assert_identical(runs):
    (lock, lock_m), (seq, seq_m), (jax, jax_m) = runs
    assert lock == seq == jax
    assert any(lock), "no track was written"
    assert set(lock_m) == set(jax_m) == set(NAMES)
    for name in NAMES:
        assert lock_m[name].as_dict() == seq_m[name].as_dict() \
            == jax_m[name].as_dict()


@pytest.mark.parametrize("tracker", ["byte", "ghost", "strongsort", "sort"])
def test_lockstep_det_txt_matches_jax(two_sequences, tmp_path, tracker):
    dirs, _ = two_sequences
    _assert_identical(_both(dirs, tmp_path, ["--tracker", tracker]))


def test_lockstep_busca_mem_cap_matches_jax(two_sequences, artifacts,
                                            tmp_path):
    """BYTE with the small BUSCA model (float32) and a memory cap below
    the sequences' lengths: every third round of the two sequences goes
    through one ``associate_many`` in both packages."""
    dirs, _ = two_sequences
    _assert_identical(_both(dirs, tmp_path, [
        "--use-busca", "--busca-dtype", "float32", "--busca-config",
        artifacts["cfg"], "--busca-ckpt", artifacts["busca"], "--crop-h",
        str(CROP_HW[0]), "--crop-w", str(CROP_HW[1]), "--mem-cap", "4"]))


def test_lockstep_npy_det_matches_jax(two_sequences, tmp_path):
    dirs, root = two_sequences
    _assert_identical(_both(dirs, tmp_path, [
        "--tracker", "strongsort", "--npy-det", root,
        "--min-confidence", "0.3"]))


def _relabelled(ids):
    first = {}
    return [first.setdefault(i, len(first)) for i in ids]


@pytest.fixture(scope="module")
def live_sequences(tmp_path_factory):
    """The synthetic dropout sequence written as two MOTChallenge
    directories of 10 and 7 frames (JPEG frames, gt)."""
    import cv2

    seq = default_dropout_sequence(40)
    gt = seq.ground_truth()
    dirs = []
    for name, n in zip(NAMES, (10, 7)):
        root = tmp_path_factory.mktemp("live") / name
        (root / "img1").mkdir(parents=True)
        (root / "gt").mkdir()
        with open(root / "gt" / "gt.txt", "w") as f:
            for t in range(n):
                cv2.imwrite(str(root / "img1" / f"{t + 1:06d}.jpg"),
                            seq.frame(t))
                for tlwh, gid in zip(*gt[t + 1]):
                    f.write(f"{t + 1},{gid},{tlwh[0]:.2f},{tlwh[1]:.2f},"
                            f"{tlwh[2]:.2f},{tlwh[3]:.2f},1,1,1\n")
        (root / "seqinfo.ini").write_text(
            f"[Sequence]\nname={name}\nimDir=img1\nframeRate=30\n"
            f"seqLength={n}\nimWidth={seq.width}\nimHeight={seq.height}\n"
            "imExt=.jpg\n")
        dirs.append(str(root))
    return dirs


def test_lockstep_live_yolox_matches_jax(live_sequences, artifacts,
                                         tmp_path):
    """``--detector yolox-tiny --lockstep`` with BUSCA over two sequences of
    one resolution: one batch step per lockstep frame.  Frames and ids
    equal to busca_tpu's lockstep run and to the port's sequential run
    (there after relabelling by first appearance: lockstep interleaves
    the sequences' new tracks on one id counter); boxes within the loop's
    bound plus one printed step."""
    yolox = str(tmp_path / "yolox_tiny.pth")
    seq = default_dropout_sequence(40)
    torch.save(calibrated_state(YoloxConfig.size("tiny"), 22,
                                [seq.frame(t) for t in range(10)],
                                (128, 224), (56.0, 28.0)), yolox)
    runs = _both(live_sequences, tmp_path, [
        "--detector", "yolox-tiny", "--detector-ckpt", yolox, "--test-h",
        "128", "--test-w", "224", "--det-conf", "0.3", "--use-busca",
        "--busca-dtype", "float32", "--busca-config", artifacts["cfg"],
        "--busca-ckpt", artifacts["busca"], "--crop-bank-slots", "2048",
        "--crop-h", str(CROP_HW[0]), "--crop-w", str(CROP_HW[1])])
    (lock, lock_m), (seq_txt, _), (jax, jax_m) = runs
    assert set(lock_m) == set(jax_m) == set(NAMES)
    for name, a, b, c in zip(NAMES, lock, seq_txt, jax):
        rows = [np.loadtxt(t.splitlines(), delimiter=",", ndmin=2)
                for t in (a, b, c)]
        assert len(rows[0]) > 5, f"{name}: no track was written"
        for other, relabel in ((rows[1], True), (rows[2], False)):
            assert other.shape == rows[0].shape
            np.testing.assert_array_equal(other[:, 0], rows[0][:, 0])
            if relabel:
                assert _relabelled(other[:, 1]) == _relabelled(rows[0][:, 1])
            else:
                np.testing.assert_array_equal(other[:, 1], rows[0][:, 1])
            np.testing.assert_allclose(other[:, 2:6], rows[0][:, 2:6],
                                       rtol=0, atol=LOOP_BOX_TOL + 0.01)
        for k, v in jax_m[name].as_dict().items():
            assert lock_m[name].as_dict()[k] == pytest.approx(
                v, rel=0, abs=1e-3), k


def test_lockstep_refusals(two_sequences, capsys):
    """The paths busca_tpu's ``--lockstep`` refuses, refused alike: a
    feedback detector, and the trackers of the detector-feedback family
    without a detector."""
    dirs, _ = two_sequences
    base = ["--mot-dir", *dirs, "--device", "cpu", "--lockstep"]
    for argv in (["--detector", "transcenter", "--tracker", "transcenter"],
                 ["--detector", "centertrack", "--tracker", "centertrack"],
                 ["--tracker", "transcenter"]):
        with pytest.raises(SystemExit):
            trun.main(base + argv)
        assert "--lockstep needs" in capsys.readouterr().err


def test_reid_stats_batch_accepted_and_later_modes_refused(
        artifacts, monkeypatch, capsys):  # noqa: F811
    """``--reid-stats batch`` (busca_tpu's default) is accepted and runs as
    the default does; ``frozen`` and ``auto`` (ported with items 7 and 24)
    build a frozen engine and run BUSCA to the report; ``--lockstep-dp``
    still names item 23."""
    argv = ["--synthetic", "--num-frames", "12", "--tracker", "sort",
            "--device", "cpu"]
    out = []
    for extra in ([], ["--reid-stats", "batch"]):
        _reset_torch_ids()
        res = trun.main(argv + extra)
        res["base"].pop("fps")
        out.append(res)
    assert out[0] == out[1]
    built = []
    real_build = trun.build_engine

    def spy(*a, **kw):
        built.append(real_build(*a, **kw)[0])
        return built[-1], {}

    monkeypatch.setattr(trun, "build_engine", spy)
    busca = ["--synthetic", "--num-frames", "12", "--tracker", "byte",
             "--use-busca", "--busca-config", artifacts["cfg"],
             "--busca-ckpt", artifacts["busca"], "--crop-h",
             str(CROP_HW[0]), "--crop-w", str(CROP_HW[1]), "--device", "cpu"]
    for mode in ("frozen", "auto"):
        _reset_torch_ids()
        res = trun.main(busca + ["--reid-stats", mode])
        assert built[-1].reid_stats == mode and built[-1].bank is None
        assert np.isfinite(res["busca"]["mota"])
    with pytest.raises(SystemExit):
        trun.main(argv + ["--lockstep-dp", "2"])
    assert "item 23" in capsys.readouterr().err
