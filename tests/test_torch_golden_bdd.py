"""The port's golden-number harness (eval/golden.py) and BDD conversion
(eval/bdd.py) against busca_tpu's, on the CPU.

Golden: the reference's MOT17 val split, the clean SKIP without artifacts
(the same lines as busca_tpu's), and a full run with its diff report on a
synthetic StrongSORT fixture: the same report as busca_tpu's harness.
BDD: the MOT -> BDD conversion, the results-directory conversion, the
reader and the per-category evaluation equal busca_tpu's on the cases of
tests/test_bdd.py.
"""

import json
import os

import numpy as np
import pytest

from busca_tpu.eval import bdd as jbdd
from busca_tpu.eval import golden as jgolden
from busca_tpu_torch.eval import bdd as tbdd
from busca_tpu_torch.eval import golden as tgolden
from test_golden import _fixture


def test_val_split_matches_reference():
    assert tgolden.MOT17_VAL_SEQUENCES == jgolden.MOT17_VAL_SEQUENCES
    assert len(tgolden.MOT17_VAL_SEQUENCES) == 7


def test_clean_skip_without_artifacts(tmp_path, capsys):
    argv = ["--mot-root", str(tmp_path), "--npy-dir", str(tmp_path)]
    assert jgolden.main(argv) is None
    want = capsys.readouterr().out
    assert tgolden.main(argv + ["--device", "cpu"]) is None
    got = capsys.readouterr().out
    assert "SKIP" in got and "MOT17-02-FRCNN" in got
    assert got == want
    assert tgolden.check_artifacts(str(tmp_path), str(tmp_path)) == \
        jgolden.check_artifacts(str(tmp_path), str(tmp_path))


@pytest.mark.parametrize("lockstep", [False, True])
def test_golden_run_and_diff_report(tmp_path, capsys, lockstep):
    """StrongSORT on the synthetic fixture through both harnesses: the
    same diff report and the same result file."""
    mot_root, npy_dir = _fixture(tmp_path)
    argv = ["--mot-root", mot_root, "--npy-dir", npy_dir,
            "--sequences", "SSTEST-01"] + (["--lockstep"] if lockstep else [])
    want = jgolden.main(argv + ["--output-dir", str(tmp_path / "jax")])
    got = tgolden.main(argv + ["--output-dir", str(tmp_path / "torch"),
                               "--device", "cpu"])
    assert got is not None and set(got) == {"mota", "hota", "idf1", "ids"}
    assert got == want
    for v in got.values():
        assert v["diff"] is not None
    rows = [np.loadtxt(tmp_path / d / "SSTEST-01.txt", delimiter=",")
            for d in ("jax", "torch")]
    np.testing.assert_array_equal(rows[1], rows[0])
    assert '"variant": "strongsort"' in capsys.readouterr().out


ROWS = np.array([
    [1, 5, 10, 20, 30, 40, 0.9, -1, 3, -1],   # car
    [1, 6, 50, 60, 10, 10, 0.8, -1, 1, -1],   # pedestrian
    [1, 2, 0, 0, 5, 5, 1.0, -1, 99, -1],      # unknown label: dropped
    [2, 5, 12, 22, 30, 40, 0.9, -1, 3, -1],
    [2, 9, 50, 60, 20, 20, 0.8, -1, -1, -1],  # missing label: pedestrian
    [3, 1, 0, 0, 5, 5, 1.0, -1, 6, -1],       # train
])


@pytest.mark.parametrize("classes_for_eval", [None, ["pedestrian"],
                                              ["car", "train"]])
def test_mot_rows_to_bdd_matches_jax(classes_for_eval):
    got = tbdd.mot_rows_to_bdd("seq01", ROWS,
                               classes_for_eval=classes_for_eval)
    assert got == jbdd.mot_rows_to_bdd("seq01", ROWS,
                                       classes_for_eval=classes_for_eval)
    assert got[0]["name"] == "seq01-0000001.jpg"
    assert tbdd.mot_rows_to_bdd("s", np.zeros((0, 10))) == []
    assert tbdd.BDD_NAME_MAPPING == jbdd.BDD_NAME_MAPPING


def test_convert_results_dir_matches_jax(tmp_path):
    for name in ("jax", "torch"):
        d = tmp_path / name
        d.mkdir()
        (d / "MOT-01.txt").write_text("1,7,10,20,30,40,0.9,-1,-1,-1\n"
                                      "2,7,11,21,30,40,0.9,-1,3,-1\n")
        (d / "empty.txt").write_text("")
    wj = jbdd.convert_results_dir(str(tmp_path / "jax"))
    wt = tbdd.convert_results_dir(str(tmp_path / "torch"))
    assert [os.path.basename(p) for p in wt] == \
        [os.path.basename(p) for p in wj] == ["MOT-01.json", "empty.json"]
    for a, b in zip(wt, wj):
        assert json.loads(open(a).read()) == json.loads(open(b).read())


def test_read_bdd_json_matches_jax():
    frames = [
        {"videoName": "a", "frameIndex": 0, "labels": [
            {"id": 1, "category": "pedestrian",
             "box2d": {"x1": 0, "y1": 0, "x2": 10, "y2": 10}},
            {"id": 2, "category": "pedestrian",
             "attributes": {"crowd": True},
             "box2d": {"x1": 50, "y1": 50, "x2": 90, "y2": 90}}]},
        {"videoName": "b", "frameIndex": 0, "labels": [
            {"id": 3, "category": "car",
             "box2d": {"x1": 5, "y1": 5, "x2": 15, "y2": 15}}]},
    ]
    with pytest.raises(ValueError):
        tbdd.read_bdd_json(frames)
    for video in ("a", "b"):
        got = tbdd.read_bdd_json(frames, video=video)
        want = jbdd.read_bdd_json(frames, video=video)
        assert list(got) == list(want)
        for f in got:
            np.testing.assert_array_equal(got[f][0], want[f][0])
            np.testing.assert_array_equal(got[f][1], want[f][1])
    bdd = tbdd.mot_rows_to_bdd("seq", ROWS)
    for cls in (None, ["car"]):
        got = tbdd.read_bdd_json(bdd, classes_for_eval=cls)
        want = jbdd.read_bdd_json(bdd, classes_for_eval=cls)
        assert sorted(got) == sorted(want)
        for f in got:
            np.testing.assert_array_equal(got[f][1], want[f][1])


def test_evaluate_bdd_matches_jax(tmp_path):
    """Per-category CLEAR and mMOTA/mIDF1 equal busca_tpu's: a perfect
    prediction, a cross-category one (no credit) and a noisy one."""
    rng = np.random.RandomState(4)
    gt_rows = np.array([[f, 1 + k, 10 + 40 * k + 2 * f, 20, 30, 40, 1.0, -1,
                         1 + 2 * (k % 2), -1]
                        for f in range(1, 9) for k in range(4)], float)
    noisy = gt_rows.copy()
    noisy[:, 2:4] += rng.randn(len(noisy), 2) * 6
    noisy[::5, 1] += 10  # identity changes
    relabel = gt_rows.copy()
    relabel[:, 8] = 3
    gt = tbdd.mot_rows_to_bdd("s", gt_rows)
    gt_path = tmp_path / "gt.json"
    gt_path.write_text(json.dumps(gt))
    for pred_rows in (gt_rows, noisy, relabel):
        pred = tbdd.mot_rows_to_bdd("s", pred_rows)
        got = tbdd.evaluate_bdd(str(gt_path), pred)
        want = jbdd.evaluate_bdd(str(gt_path), pred)
        assert set(got) == set(want)
        for k, v in got.items():
            if isinstance(v, float):
                assert v == want[k], k
            else:
                assert v.as_dict() == want[k].as_dict(), k
    perfect = tbdd.evaluate_bdd(gt, gt)
    assert perfect["mMOTA"] == 1.0
