"""The port's detection AP (eval/detection.py) against busca_tpu's, and the
eval CLI's ``--det-ap`` table against busca_tpu's CLI.

``average_precision``, ``coco_map`` and ``coco_eval_full`` are the same
numpy code on both sides, so they must agree exactly on the hand-computed
cases of tests/test_detection_ap.py and on seeded random scenes;
``format_coco_table`` gives the same string.  Both CLIs print the same
table on a tiny ``--mot-dir --detector yolox-tiny`` run with the same
detector weights.
"""

import os

import numpy as np
import pytest
import torch

from busca_tpu.eval import detection as jdet
from busca_tpu_torch.eval import detection as tdet
from test_torch_yolox_loop import mot_sequence  # noqa: F401  (a fixture)


def _b(x, y=0, s=10):
    return np.array([x, y, x + s, y + s], float)


HAND = {  # tests/test_detection_ap.py's scenes
    "perfect": ({0: (np.stack([_b(0), _b(50)]), np.array([0.9, 0.8])),
                 1: (np.stack([_b(100)]), np.array([0.95]))},
                {0: np.stack([_b(0), _b(50)]), 1: np.stack([_b(100)])}),
    "fp_after_tps": ({0: (np.stack([_b(0), _b(500)]), np.array([0.9, 0.3]))},
                     {0: np.stack([_b(0)])}),
    "fp_first": ({0: (np.stack([_b(500), _b(0)]), np.array([0.9, 0.3]))},
                 {0: np.stack([_b(0)])}),
    "duplicate": ({0: (np.stack([_b(0), _b(1)]), np.array([0.9, 0.8]))},
                  {0: np.stack([_b(0)])}),
    "miss": ({0: (np.stack([_b(0)]), np.array([0.9]))},
             {0: np.stack([_b(0), _b(50)])}),
    "no_gt": ({0: (np.stack([_b(0)]), np.array([0.9]))}, {0: np.zeros((0, 4))}),
}


def _random_scene(seed):
    """Images of up to 30 gt boxes of every COCO area range, detections
    jittered from them (some missed, some duplicated) plus false
    positives, scores random."""
    rng = np.random.RandomState(seed)
    dets, gts = {}, {}
    for img in range(int(rng.randint(3, 8))):
        n = int(rng.randint(0, 30))
        xy = rng.uniform(0, 900, (n, 2))
        wh = np.exp(rng.uniform(np.log(4), np.log(300), (n, 2)))
        gt = np.concatenate([xy, xy + wh], 1)
        keep = rng.rand(n) > 0.2
        jitter = wh[keep].mean(1, keepdims=True) * 0.08
        d = gt[keep] + rng.randn(int(keep.sum()), 4) * jitter
        fp_xy = rng.uniform(0, 900, (int(rng.randint(0, 6)), 2))
        fp = np.concatenate([fp_xy, fp_xy + rng.uniform(5, 200, fp_xy.shape)],
                            1)
        d = np.concatenate([d, d[:2] + 1.0, fp])
        gts[("seq", img)] = gt
        dets[("seq", img)] = (d, rng.rand(len(d)))
    return dets, gts


@pytest.mark.parametrize("name", sorted(HAND))
def test_hand_cases_match_jax(name):
    dets, gts = HAND[name]
    for thr in (0.5, 0.75):
        assert tdet.average_precision(dets, gts, thr) == \
            jdet.average_precision(dets, gts, thr)
    assert tdet.coco_map(dets, gts) == jdet.coco_map(dets, gts)
    assert tdet.coco_eval_full(dets, gts) == jdet.coco_eval_full(dets, gts)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_scenes_match_jax(seed):
    dets, gts = _random_scene(seed)
    for thr in (0.5, 0.7, 0.95):
        assert tdet.average_precision(dets, gts, thr) == \
            jdet.average_precision(dets, gts, thr)
    assert tdet.coco_map(dets, gts) == jdet.coco_map(dets, gts)
    full = tdet.coco_eval_full(dets, gts)
    assert full == jdet.coco_eval_full(dets, gts)
    assert tdet.format_coco_table(full) == jdet.format_coco_table(full)
    assert len(tdet.format_coco_table(full).splitlines()) == 12


def test_det_ap_cli_table_matches_jax(mot_sequence, tmp_path, capsys):
    """``--det-ap`` on a tiny live-YOLOX run: both CLIs print the same
    12-line table, and the port warns where no table applies, as
    busca_tpu does."""
    from busca_tpu.eval import run as jrun
    from busca_tpu_torch.eval import run as trun
    from busca_tpu_torch.eval.synthetic import default_dropout_sequence
    from busca_tpu_torch.models.yolox import YoloxConfig
    from test_torch_yolox_loop import calibrated_state

    seq_dir = mot_sequence
    yolox = str(tmp_path / "yolox_tiny.pth")
    seq = default_dropout_sequence(40)
    torch.save(calibrated_state(YoloxConfig.size("tiny"), 22,
                                [seq.frame(t) for t in range(10)],
                                (128, 224), (56.0, 28.0)), yolox)
    common = ["--mot-dir", seq_dir, "--detector", "yolox-tiny",
              "--detector-ckpt", yolox, "--test-h", "128", "--test-w", "224",
              "--det-conf", "0.3", "--det-ap"]

    def table(text):
        return [ln for ln in text.splitlines()
                if ln.startswith(" Average ")]

    jrun.main(common + ["--output-dir", str(tmp_path / "jax")])
    want = table(capsys.readouterr().out)
    trun.main(common + ["--output-dir", str(tmp_path / "torch"),
                        "--device", "cpu"])
    got = table(capsys.readouterr().out)
    assert len(want) == 12 and got == want
    # no live detector: the warning, and no table
    trun.main(["--mot-dir", seq_dir, "--det-ap", "--max-frames", "3",
               "--output-dir", str(tmp_path / "txt"), "--device", "cpu"])
    cap = capsys.readouterr()
    assert "WARNING: --det-ap only applies" in cap.err
    assert not table(cap.out)
    assert os.path.exists(tmp_path / "torch" / "MOT17-05-FRCNN.txt")
