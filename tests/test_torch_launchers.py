"""The port's launchers (``scripts/run_*_torch.sh`` over
``busca_tpu_torch.eval.run``): valid bash; the ByteTrack launcher driven end
to end on the CPU on a tiny MOT17 layout (JPEG frames, the per-dataset YOLOX
checkpoint from ``CKPT_DIR`` as the official ``{"model": ...}`` envelope,
BUSCA from a YAML and a ``.pth``), its result file equal to the eval CLI's
``main`` run in-process with the arguments the launcher passes, and its
experiment-dir layout; the MOT17-test FRCNN->DPM/SDP replication through the
StrongSORT launcher on the sequence's ``det/det.txt``."""

import os
import re
import shutil
import subprocess

import pytest
import torch
import yaml

from busca_tpu_torch.eval import run as trun
from busca_tpu_torch.eval.detector import YoloxDetector
from busca_tpu_torch.eval.synthetic import default_dropout_sequence
from busca_tpu_torch.models.busca import BuscaConfig, BuscaModel
from busca_tpu_torch.models.yolox import YoloxConfig
from busca_tpu_torch.trackers.base import Track

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("_run_common_torch", "run_bytetrack_torch", "run_strongsort_torch",
           "run_ghost_torch", "run_centertrack_torch",
           "run_transcenter_torch")
SEQ = "MOT17-90-FRCNN"
N_FRAMES = 10
TEST_SIZE = (64, 96)
# what a CPU run passes through the launcher as extra arguments
CPU_ARGS = ["--device", "cpu", "--detector", "yolox-tiny",
            "--test-h", str(TEST_SIZE[0]), "--test-w", str(TEST_SIZE[1]),
            "--crop-h", "64", "--crop-w", "32"]
SMALL = dict(num_layer=2, nhead=4, trans_dim=64, ff_size=128,
             reid_layers=[1, 1, 1, 1], reid_num_classes=7)
RUN_DIR = re.compile(r"\d{4}-\d\d-\d\d_\d\d-\d\d-\d\d_(\w+)_(BUSCA|BASE)")


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def deployment(tmp_path_factory):
    """``MOT_DATA_DIR`` with ``MOT17/train/SEQ`` (10 JPEG frames of the
    dropout sequence from three frames before its dropout, seqinfo.ini,
    gt/gt.txt, det/det.txt), ``CKPT_DIR`` with a calibrated YOLOX-tiny as
    ``bytetrack_ablation.pth.tar``, and a small BUSCA's YAML and
    ``.pth``."""
    root = tmp_path_factory.mktemp("deployment")
    seq = default_dropout_sequence(40)
    start = next(t for t in range(seq.num_frames)
                 if not seq.objects[0].detected_at(t)) - 3
    frames = [seq.frame(t) for t in range(start, start + N_FRAMES)]
    seq_dir = root / "datasets" / "MOT17" / "train" / SEQ
    for sub in ("img1", "gt", "det"):
        (seq_dir / sub).mkdir(parents=True)
    gt = seq.ground_truth()
    gt_rows, det_rows = [], []
    for i, frame in enumerate(frames):
        assert cv2.imwrite(str(seq_dir / "img1" / f"{i + 1:06d}.jpg"), frame)
        for tlwh, gid in zip(*gt[start + i + 1]):
            gt_rows.append(f"{i + 1},{gid},{tlwh[0]:.2f},{tlwh[1]:.2f},"
                           f"{tlwh[2]:.2f},{tlwh[3]:.2f},1,1,1")
        boxes, scores = seq.detections(start + i)
        for b, s in zip(boxes, scores):
            det_rows.append(f"{i + 1},-1,{b[0]:.2f},{b[1]:.2f},"
                            f"{b[2] - b[0]:.2f},{b[3] - b[1]:.2f},{s:.3f},"
                            "-1,-1,-1")
    (seq_dir / "gt" / "gt.txt").write_text("\n".join(gt_rows) + "\n")
    (seq_dir / "det" / "det.txt").write_text("\n".join(det_rows) + "\n")
    (seq_dir / "seqinfo.ini").write_text(
        f"[Sequence]\nname={SEQ}\nimDir=img1\nframeRate=30\n"
        f"seqLength={N_FRAMES}\nimWidth={seq.width}\n"
        f"imHeight={seq.height}\nimExt=.jpg\n")

    ckpt_dir = root / "pretrained"
    ckpt_dir.mkdir()
    det = YoloxDetector(YoloxConfig.size("tiny", num_classes=1), None,
                        test_size=TEST_SIZE, device="cpu", seed=21)
    det.calibrate_random_weights(frames, 1.0, 1.0, (28.0, 14.0))
    torch.save({"model": det.model.state_dict()},
               ckpt_dir / "bytetrack_ablation.pth.tar")
    model = BuscaModel(BuscaConfig.from_dict(SMALL))
    model.init_weights(torch.Generator().manual_seed(5))
    pth = root / "model_busca.pth"
    torch.save({"model_state_dict": model.state_dict()}, pth)
    yml = root / "busca.yml"
    yml.write_text(yaml.safe_dump({
        "transformer": SMALL,
        "tracker": {"busca_thresh": 0.1, "select_highest_candidate": False,
                    "track_thresh": 0.5}}))
    return {"data": str(root / "datasets"), "ckpt_dir": str(ckpt_dir),
            "seq_dir": str(seq_dir), "pth": str(pth), "yml": str(yml)}


def _launch(script, deployment, args, timeout=120):
    env = dict(os.environ, MOT_DATA_DIR=deployment["data"],
               CKPT_DIR=deployment["ckpt_dir"], OMP_NUM_THREADS="1")
    out = subprocess.run(
        ["bash", os.path.join(REPO, "scripts", f"{script}.sh"), *args],
        env=env, capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def _run_dir(exp, tracker, testset, arm):
    """The one experiment dir of a launcher run, checked against the
    layout ``exp/<Tracker>/MOT17/<testset>/<ts>_<Tracker>_<arm>``."""
    base = os.path.join(exp, tracker, "MOT17", testset)
    (name,) = os.listdir(base)
    assert RUN_DIR.fullmatch(name).groups() == (tracker, arm), name
    run = os.path.join(base, name)
    assert sorted(os.listdir(run)) == ["out.txt", "track_results"]
    return run


def test_launcher_scripts_parse():
    """Every port launcher is executable, valid bash, sources the port's
    core, and calls the port's CLI; the core inserts no --device."""
    for name in SCRIPTS:
        path = os.path.join(REPO, "scripts", f"{name}.sh")
        assert os.access(path, os.X_OK), name
        out = subprocess.run(["bash", "-n", path], capture_output=True)
        assert out.returncode == 0, f"{name}: {out.stderr}"
        with open(path) as f:
            body = f.read()
        if name != "_run_common_torch":
            assert '/_run_common_torch.sh"' in body, name
    with open(os.path.join(REPO, "scripts", "_run_common_torch.sh")) as f:
        core = f.read()
    assert "python3 -m busca_tpu_torch.eval.run" in core
    assert "busca_tpu.eval" not in core and "--device" not in core.split(
        "\nset -euo pipefail")[1]


def test_bytetrack_launcher_matches_cli(deployment, tmp_path,
                                       one_torch_thread):
    exp = str(tmp_path / "exp")
    busca = ["--busca-config", deployment["yml"], "--busca-ckpt",
             deployment["pth"]]
    stdout = _launch("run_bytetrack_torch", deployment,
                     ["--use-busca", *busca, "--output-base-folder", exp,
                      *CPU_ARGS])
    run = _run_dir(exp, "ByteTrack", "val", "BUSCA")
    assert "BUSCA ENABLED" in stdout
    with open(os.path.join(run, "out.txt")) as f:
        assert f"{SEQ}: {N_FRAMES} frames @" in f.read()
    with open(os.path.join(run, "track_results", f"{SEQ}.txt")) as f:
        launched = f.read()

    # the eval CLI in this process, with the arguments the launcher passes:
    # its per-dataset YOLOX checkpoint, the BUSCA arguments, the extras
    Track.reset_id_counter()
    out = tmp_path / "cli"
    trun.main(["--tracker", "byte", "--mot-dir", deployment["seq_dir"] + "/",
               "--output-dir", str(out), "--detector", "yolox-x",
               "--detector-ckpt", os.path.join(deployment["ckpt_dir"],
                                               "bytetrack_ablation.pth.tar"),
               "--use-busca", *busca, *CPU_ARGS])
    with open(out / f"{SEQ}.txt") as f:
        direct = f.read()
    assert launched and launched == direct
    frames = {int(row.split(",")[0]) for row in launched.splitlines()}
    assert len(frames) >= N_FRAMES // 2


def test_strongsort_launcher_replicates_mot17_test(deployment, tmp_path):
    """``--testset test`` reads ``MOT17/test`` and copies each -FRCNN result
    to -DPM and -SDP (the reference's server format)."""
    data = tmp_path / "data"
    shutil.copytree(deployment["seq_dir"], data / "MOT17" / "test" / SEQ)
    exp = str(tmp_path / "exp")
    _launch("run_strongsort_torch", dict(deployment, data=str(data)),
            ["--testset", "test", "--output-base-folder", exp,
             "--device", "cpu"])
    results = os.path.join(_run_dir(exp, "StrongSORT", "test", "BASE"),
                           "track_results")
    stem = SEQ[:-len("-FRCNN")]
    assert sorted(os.listdir(results)) == [f"{stem}-DPM.txt",
                                           f"{stem}-FRCNN.txt",
                                           f"{stem}-SDP.txt"]
    with open(os.path.join(results, f"{SEQ}.txt")) as f:
        frcnn = f.read()
    assert frcnn
    for copy in ("DPM", "SDP"):
        with open(os.path.join(results, f"{stem}-{copy}.txt")) as f:
            assert f.read() == frcnn
