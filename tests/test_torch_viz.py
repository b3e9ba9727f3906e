"""The port's visualization (busca_tpu_torch.viz, ``write_viz_frame``,
``--online-visualization``) against busca_tpu's, on the CPU: the same
numpy and cv2 drawing, so every canvas is equal pixel for pixel and every
written JPEG byte for byte (one encoder on equal canvases).
"""

import os

import cv2
import numpy as np
import pytest
import torch

from busca_tpu.eval import run as jrun
from busca_tpu.eval.runner import write_viz_frame as j_write_viz_frame
from busca_tpu.viz import create_batch_image as j_batch_image
from busca_tpu.viz import id_color as j_id_color
from busca_tpu.viz import plot_box as j_plot_box
from busca_tpu_torch.eval import run as trun
from busca_tpu_torch.eval.runner import run_sequence, write_viz_frame
from busca_tpu_torch.eval.synthetic import default_dropout_sequence
from busca_tpu_torch.trackers.byte import ByteTracker, ByteTrackerConfig
from busca_tpu_torch.viz import create_batch_image, id_color, plot_box
from test_run_cli import mot_fixture  # noqa: F401 (the fixture)
from test_torch_run_cli import NAME, _reset_jax_ids, _reset_torch_ids


@pytest.mark.parametrize("style", ["solid", "dashed", "dotted"])
def test_plot_box_equals_busca_tpu(style):
    rng = np.random.RandomState(0)
    base = rng.randint(0, 255, (90, 120, 3)).astype(np.uint8)
    got, want = base.copy(), base.copy()
    for tid, box in ((3, [10, 12, 60, 70]), (81, [40.7, 5.2, 118, 88.9])):
        plot_box(got, tid, box, style=style, display_id=True)
        j_plot_box(want, tid, box, style=style, display_id=True)
    assert np.array_equal(got, want) and not np.array_equal(got, base)
    assert [id_color(i) for i in range(90)] == [j_id_color(i)
                                                for i in range(90)]


@pytest.mark.parametrize("probs", [True, False])
def test_create_batch_image_equals_busca_tpu(probs):
    rng = np.random.RandomState(1)
    mem = rng.randint(0, 255, (7, 4, 32, 16, 3)).astype(np.uint8)
    can = rng.randint(0, 255, (7, 3, 32, 16, 3)).astype(np.uint8)
    p = rng.dirichlet(np.ones(5), size=7) if probs else None
    got = create_batch_image(mem, can, p)
    assert got.shape == (5 * 34, 7 * 18 + 10, 3)  # max_batch_size rows
    assert np.array_equal(got, j_batch_image(mem, can, p))


def test_write_viz_frame_equals_busca_tpu(tmp_path):
    rng = np.random.RandomState(2)
    frame = rng.randint(0, 255, (60, 80, 3)).astype(np.uint8)
    tlwhs = [np.array([5.0, 6.0, 20.0, 30.0]), np.array([30.0, 10, 15, 25])]
    write_viz_frame(tmp_path / "t", 7, frame, tlwhs, [1, 2], scale=0.5)
    j_write_viz_frame(str(tmp_path / "j"), 7, frame, tlwhs, [1, 2],
                      scale=0.5)
    got = (tmp_path / "t" / "000007.jpg").read_bytes()
    assert got == (tmp_path / "j" / "000007.jpg").read_bytes()
    # a device canvas (a tensor) is drawn the same
    write_viz_frame(tmp_path / "d", 7, torch.from_numpy(frame), tlwhs,
                    [1, 2], scale=0.5)
    assert (tmp_path / "d" / "000007.jpg").read_bytes() == got


def test_run_sequence_writes_a_frame_each(tmp_path):
    seq = default_dropout_sequence(num_frames=6)
    dets = [seq.detections(t) for t in range(6)]
    frames = [seq.frame(t) for t in range(6)]
    res = run_sequence(ByteTracker(ByteTrackerConfig()), frames, dets,
                       viz_dir=str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == [f"{i:06d}.jpg"
                                            for i in range(1, 7)]
    img = cv2.imread(str(tmp_path / "000006.jpg"))
    assert img.shape == frames[0].shape and res.num_frames == 6


@pytest.mark.parametrize("extra", [[], ["--lockstep"]],
                         ids=["sequential", "lockstep"])
def test_online_visualization_files_equal_busca_tpu(mot_fixture,  # noqa
                                                    tmp_path, extra):
    """Both CLIs' ``--online-visualization`` over the fixture's det.txt:
    the same JPEGs, byte for byte, in ``<output-dir>/<seq>_viz``."""
    files = {}
    for tag, main, dev, reset in (
            ("torch", trun.main, ["--device", "cpu"], _reset_torch_ids),
            ("jax", jrun.main, [], _reset_jax_ids)):
        reset()
        main(["--mot-dir", mot_fixture, "--output-dir", str(tmp_path / tag),
              "--online-visualization"] + extra + dev)
        viz = tmp_path / tag / f"{NAME}_viz"
        files[tag] = {p: (viz / p).read_bytes()
                      for p in sorted(os.listdir(viz))}
    assert list(files["torch"]) == [f"{i:06d}.jpg" for i in range(1, 7)]
    assert files["torch"] == files["jax"]
