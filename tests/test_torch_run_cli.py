"""Both packages' CLIs (``busca_tpu.eval.run.main`` and
``busca_tpu_torch.eval.run.main``) on the MOTChallenge fixture of
tests/test_run_cli.py: the cached ``det/det.txt`` mode for each tracker
(SORT and MOTDT too), ``--gsi``, ``--aflink`` on a ``.npz`` saved by
busca_tpu, StrongSORT's ``--npy-det`` with ``--ecc-json``, and BUSCA
(float32, 64x32 crops, the small model of tests/test_torch_byte_pipeline.py,
its ``.npz`` saved by busca_tpu).  The result files must be identical and
the accumulated CLEAR equal; ``global_metrics`` must equal
``metrics.accumulate``.  ``--synthetic`` with SORT, MOTDT and the
CenterTrack adapter: equal metric dicts.

The live CenterTrack path (``--detector centertrack --tracker centertrack
--centertrack-arch tiny``, with and without BUSCA) runs on the synthetic
dropout sequence written as JPEGs, with the designed colour detector of
tests/test_torch_centertrack_loop.py saved by busca_tpu as ``.npz``: frames
and ids equal, boxes within the loop test's bound plus one printed step.
"""

import os

import jax
import numpy as np
import pytest
import yaml

from busca_tpu.eval import run as jrun
from busca_tpu.models.aflink import AFLinkModel as JAFLink
from busca_tpu.models.aflink import AFLinkConfig, synthetic_batch
from busca_tpu.models.busca import BuscaConfig as JCfg
from busca_tpu.models.busca import BuscaModel as JModel
from busca_tpu.models.checkpoint import save_params_npz
from busca_tpu.trackers import motdt as jmotdt
from busca_tpu.trackers import sort as jsort
from busca_tpu.trackers.base import IdCounter as JIdCounter
from busca_tpu.trackers.base import Track as JTrack
from busca_tpu_torch.eval import run as trun
from busca_tpu_torch.eval.metrics import accumulate
from busca_tpu_torch.eval.runner import global_metrics
from busca_tpu_torch.trackers import motdt as tmotdt
from busca_tpu_torch.trackers import sort as tsort
from busca_tpu_torch.trackers.base import IdCounter, Track
from test_run_cli import mot_fixture  # noqa: F401 (the fixture)
from test_torch_byte_pipeline import CROP_HW, SMALL, engines  # noqa: F401
from test_torch_strongsort import one_torch_thread  # noqa: F401

NAME = "MOT17-05-FRCNN"


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory, mot_fixture):  # noqa: F811
    """A BUSCA YAML + ``.npz``, an AFLink ``.npz``, a deep_sort ``.npy``
    and an ECC JSON for the fixture sequence, written once."""
    root = tmp_path_factory.mktemp("artifacts")
    h, w = CROP_HW
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        JModel(JCfg(**SMALL)).init)(
        jax.random.PRNGKey(5),
        np.zeros((1, 11, h, w, 3), np.float32),
        np.zeros((1, 5, h, w, 3), np.float32),
        np.zeros((1, 11, 4), np.float32),
        np.zeros((1, 5, 4), np.float32),
    ))
    busca = str(root / "busca.npz")
    save_params_npz(busca, {"params": variables["params"]})
    cfg = str(root / "busca.yml")
    with open(cfg, "w") as f:
        yaml.safe_dump({"transformer": dict(
            SMALL, reid_layers=list(SMALL["reid_layers"])),
            "tracker": {"busca_thresh": 0.1,
                        "select_highest_candidate": False}}, f)
    s1, s2, _ = synthetic_batch(np.random.RandomState(3), 4, AFLinkConfig())
    link = str(root / "aflink.npz")
    save_params_npz(link, jax.tree_util.tree_map(np.asarray, jax.jit(
        JAFLink().init)(jax.random.PRNGKey(11), s1, s2)))
    # deep_sort .npy: det.txt rows + a feature per row
    det = np.loadtxt(os.path.join(mot_fixture, "det", "det.txt"),
                     delimiter=",")
    feats = np.random.RandomState(1).randn(len(det), 8)
    npy = str(root / f"{NAME}.npy")
    np.save(npy, np.concatenate([det, feats], axis=1))
    ecc = str(root / "ecc.json")
    with open(ecc, "w") as f:
        f.write('{"%s": {"3": [[1, 0, 2.5], [0, 1, -1.0], [0, 0, 1]]}}'
                % NAME)
    return {"busca": busca, "cfg": cfg, "aflink": link, "npy": npy,
            "ecc": ecc}


def _reset_torch_ids():
    Track.reset_id_counter()
    tsort.SortTrack._count = IdCounter(1)
    tmotdt.MotdtTrack._count = IdCounter(1)


def _reset_jax_ids():
    JTrack.reset_id_counter()
    jsort.SortTrack._count = JIdCounter(1)
    jmotdt.MotdtTrack._count = JIdCounter(1)


def _both(mot_dir, tmp_path, argv, name=NAME):
    """Run both CLIs; returns ((rows txt, per-seq) torch, (...) jax)."""
    out = []
    for tag, main, extra, reset in (
            ("torch", trun.main, ["--device", "cpu"], _reset_torch_ids),
            ("jax", jrun.main, [], _reset_jax_ids)):
        reset()
        per_seq = main(["--mot-dir", mot_dir, "--output-dir",
                        str(tmp_path / tag)] + argv + extra)
        with open(tmp_path / tag / f"{name}.txt") as f:
            out.append((f.read(), per_seq))
    return out


def _assert_equal(got, want):
    (got_txt, got_m), (want_txt, want_m) = got, want
    assert got_txt and got_txt == want_txt
    assert set(got_m) == set(want_m) == {NAME}
    assert got_m[NAME].as_dict() == want_m[NAME].as_dict()
    assert global_metrics(got_m) == accumulate(got_m)


@pytest.mark.parametrize("tracker", ["byte", "strongsort", "deepsort",
                                     "ghost", "sort", "motdt"])
def test_det_txt_mode_matches_jax(mot_fixture, tmp_path,  # noqa: F811
                                  tracker):
    got, want = _both(mot_fixture, tmp_path, ["--tracker", tracker])
    _assert_equal(got, want)


@pytest.mark.parametrize("post", ["gsi", "aflink", "aflink+gsi"])
def test_postprocessing_matches_jax(mot_fixture, artifacts,  # noqa: F811
                                    tmp_path, post):
    argv = ["--tracker", "strongsort", "--max-frames", "5"]
    if "gsi" in post:
        argv.append("--gsi")
    if "aflink" in post:
        argv += ["--aflink", artifacts["aflink"]]
    got, want = _both(mot_fixture, tmp_path, argv)
    _assert_equal(got, want)


def test_npy_det_with_ecc_json_matches_jax(mot_fixture, artifacts,  # noqa
                                           tmp_path):
    got, want = _both(mot_fixture, tmp_path, [
        "--tracker", "strongsort", "--npy-det",
        os.path.dirname(artifacts["npy"]), "--ecc-json", artifacts["ecc"],
        "--min-confidence", "0.5"])
    _assert_equal(got, want)


@pytest.mark.parametrize("tracker", ["byte", "strongsort"])
def test_busca_matches_jax(mot_fixture, artifacts, tmp_path,  # noqa: F811
                           tracker):
    got, want = _both(mot_fixture, tmp_path, [
        "--tracker", tracker, "--use-busca", "--busca-dtype", "float32",
        "--busca-config", artifacts["cfg"], "--busca-ckpt",
        artifacts["busca"], "--crop-h", str(CROP_HW[0]), "--crop-w",
        str(CROP_HW[1])])
    _assert_equal(got, want)


def test_global_metrics_equal_accumulate():
    from busca_tpu_torch.eval.metrics import MotMetrics

    rng = np.random.RandomState(0)
    per_seq = {}
    for i in range(4):
        gt, m = int(rng.randint(50, 500)), int(rng.randint(10, 50))
        per_seq[f"s{i}"] = MotMetrics(
            mota=float(rng.uniform()), motp=float(rng.uniform()),
            idf1=float(rng.uniform()), idp=float(rng.uniform(0.1, 1)),
            idr=float(rng.uniform()), num_switches=int(rng.randint(5)),
            num_false_positives=int(rng.randint(20)),
            num_misses=int(rng.randint(20)), num_matches=m, num_gt=gt,
            mostly_tracked=int(rng.randint(5)),
            mostly_lost=int(rng.randint(5)),
            num_pred=int(rng.randint(0, 2)) * int(rng.randint(50, 500)))
    got, want = global_metrics(per_seq).as_dict(), accumulate(per_seq).as_dict()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


def test_evaluate_sequences_parallel_matches_serial_and_jax():
    """Per-sequence CLEAR over a spawn pool equals the serial pass and
    busca_tpu's, on seeded scenes of tests/test_metrics_fuzz.py."""
    from busca_tpu.eval.runner import evaluate_sequences_parallel as jeval
    from busca_tpu_torch.eval.runner import evaluate_sequences_parallel
    from test_metrics_fuzz import _random_scene

    rng = np.random.RandomState(3)
    per_seq = {f"s{i}": _random_scene(rng, n_frames=8, max_gt=4)
               for i in range(3)}
    serial = evaluate_sequences_parallel(per_seq, num_workers=1)
    pooled = evaluate_sequences_parallel(per_seq, num_workers=2)
    want = jeval(per_seq, num_workers=1)
    assert set(serial) == set(pooled) == set(want) == set(per_seq)
    for k in per_seq:
        assert serial[k] == pooled[k]
        assert serial[k].as_dict() == want[k].as_dict()


def test_run_ab_matches_jax(engines):  # noqa: F811
    """The base-vs-BUSCA harness on the dropout sequence, ByteTrack with
    the small BUSCA of tests/test_torch_byte_pipeline.py: equal metrics."""
    from busca_tpu.eval.runner import run_ab as jrun_ab
    from busca_tpu.eval.synthetic import default_dropout_sequence
    from busca_tpu.trackers.byte import ByteTracker as JByte
    from busca_tpu.trackers.byte import ByteTrackerConfig as JByteCfg
    from busca_tpu_torch.eval.runner import run_ab
    from busca_tpu_torch.trackers.byte import ByteTracker, ByteTrackerConfig

    jeng, teng = engines
    seq = default_dropout_sequence(30)
    dets = [seq.detections(t) for t in range(seq.num_frames)]
    kw = dict(use_busca=True, crop_hw=CROP_HW, busca_thresh=0.1,
              select_highest_candidate=False)

    # rendered once: the renderer's noise is drawn per call
    rendered = [seq.frame(t) for t in range(seq.num_frames)]

    def frames():
        return iter(rendered)

    JTrack.reset_id_counter()
    want = jrun_ab(lambda: JByte(JByteCfg()),
                   lambda: JByte(JByteCfg(**kw), jeng), frames, dets,
                   seq.ground_truth())
    Track.reset_id_counter()
    got = run_ab(lambda: ByteTracker(ByteTrackerConfig()),
                 lambda: ByteTracker(ByteTrackerConfig(**kw), teng), frames,
                 dets, seq.ground_truth())
    assert set(got) == set(want) == {"base", "busca"}
    for tag in got:
        assert got[tag].as_dict() == want[tag].as_dict(), tag


@pytest.mark.parametrize("tracker", ["sort", "motdt", "centertrack"])
def test_synthetic_matches_jax(tracker, capsys):
    """``--synthetic`` without BUSCA (SORT and MOTDT have no BUSCA hook;
    CenterTrack's adapter through ``CenterTrackShim``): equal metrics but
    the wall-clock fps."""
    out = []
    for main, extra, reset in ((trun.main, ["--device", "cpu"],
                                _reset_torch_ids),
                               (jrun.main, [], _reset_jax_ids)):
        reset()
        out.append(main(["--synthetic", "--tracker", tracker,
                         "--num-frames", "30"] + extra))
    got, want = out
    assert set(got) == set(want) == {"base"}
    for d in (got["base"], want["base"]):
        d.pop("fps")
    assert got == want
    assert got["base"]["mota"] > 0.5


CT_NAME = "CT-SYN"
CT_FRAMES = 12


@pytest.fixture(scope="module")
def ct_sequence(tmp_path_factory):
    """The occluded dropout sequence of tests/test_torch_centertrack_loop.py
    as a MOTChallenge directory (JPEG frames and gt), and the designed
    colour detector's busca_tpu variables as ``.npz``."""
    import cv2

    from busca_tpu.eval.synthetic import default_dropout_sequence
    from busca_tpu.models.convert import convert_centertrack_state_dict
    from test_torch_centertrack_loop import (
        colour_detector_state,
        occluded_frames,
    )

    root = tmp_path_factory.mktemp("ct") / CT_NAME
    (root / "img1").mkdir(parents=True)
    (root / "gt").mkdir()
    seq = default_dropout_sequence(CT_FRAMES)
    gt = seq.ground_truth()
    with open(root / "gt" / "gt.txt", "w") as f:
        for t, frame in enumerate(occluded_frames(CT_FRAMES)):
            cv2.imwrite(str(root / "img1" / f"{t + 1:06d}.jpg"), frame)
            for tlwh, gid in zip(*gt[t + 1]):
                f.write(f"{t + 1},{gid},{tlwh[0]:.2f},{tlwh[1]:.2f},"
                        f"{tlwh[2]:.2f},{tlwh[3]:.2f},1,1,1\n")
    with open(root / "seqinfo.ini", "w") as f:
        f.write(f"[Sequence]\nname={CT_NAME}\nimDir=img1\nframeRate=30\n"
                f"seqLength={CT_FRAMES}\nimWidth={seq.width}\n"
                f"imHeight={seq.height}\nimExt=.jpg\n")
    npz = str(root.parent / "ct.npz")
    save_params_npz(npz, convert_centertrack_state_dict(
        {k: v.numpy() for k, v in colour_detector_state().items()}))
    return str(root), npz


@pytest.mark.parametrize("busca", [False, True], ids=["base", "busca"])
def test_centertrack_cli_matches_jax(ct_sequence, artifacts, tmp_path,
                                     one_torch_thread, busca):  # noqa: F811
    from test_torch_centertrack_loop import BOX_TOL, OUT_THRESH, TEST_SIZE

    seq_dir, npz = ct_sequence
    argv = ["--detector", "centertrack", "--tracker", "centertrack",
            "--centertrack-arch", "tiny", "--detector-ckpt", npz,
            "--test-h", str(TEST_SIZE[0]), "--test-w", str(TEST_SIZE[1]),
            "--det-conf", str(OUT_THRESH)]
    if busca:
        argv += ["--use-busca", "--busca-dtype", "float32",
                 "--busca-config", artifacts["cfg"], "--busca-ckpt",
                 artifacts["busca"], "--crop-h", str(CROP_HW[0]),
                 "--crop-w", str(CROP_HW[1])]
    (got_txt, got_m), (want_txt, want_m) = _both(seq_dir, tmp_path, argv,
                                                 CT_NAME)
    got = np.loadtxt(got_txt.splitlines(), delimiter=",")
    want = np.loadtxt(want_txt.splitlines(), delimiter=",")
    assert want.shape == got.shape and len(want) == 2 * CT_FRAMES
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 2:6], want[:, 2:6], rtol=0,
                               atol=BOX_TOL + 0.01)
    np.testing.assert_allclose(got[:, 6], want[:, 6], rtol=0, atol=0.011)
    a, b = got_m[CT_NAME].as_dict(), want_m[CT_NAME].as_dict()
    for k in b:
        assert a[k] == pytest.approx(b[k], rel=0, abs=1e-3), k
