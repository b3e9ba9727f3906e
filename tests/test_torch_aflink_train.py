"""AFLink's synthetic training on the port (busca_tpu_torch.models.aflink):
the episodes equal busca_tpu's for the same ``RandomState``; training
learns (accuracy > 0.8 on the last batch) and the trained linker merges an
artificially split constant-velocity trajectory while a distant second
identity survives (tests/test_aflink.py:65-88, at its size: 150 steps of
batch 64); and the CLI's ``--aflink synthetic`` trains the link model and
links with it.
"""

import numpy as np
import pytest
import torch

from busca_tpu.models.aflink import _synthetic_pair as j_synthetic_pair
from busca_tpu.models.aflink import synthetic_batch as j_synthetic_batch
from busca_tpu_torch.eval import run as trun
from busca_tpu_torch.models.aflink import (
    AFLinkConfig,
    AFLinkModel,
    _synthetic_pair,
    synthetic_batch,
    train_aflink_synthetic,
)
from busca_tpu_torch.trackers import postprocess
from test_run_cli import mot_fixture  # noqa: F401 (the fixture)


@pytest.fixture(autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_batch_equals_busca_tpu(seed):
    cfg = AFLinkConfig()
    got = synthetic_batch(np.random.RandomState(seed), 32, cfg)
    want = j_synthetic_batch(np.random.RandomState(seed), 32, cfg)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[2].sum() == 16  # alternating labels
    # every negative kind, one pair at a time
    for positive in (True, False):
        rng, jrng = np.random.RandomState(seed), np.random.RandomState(seed)
        for _ in range(6):
            a = _synthetic_pair(rng, cfg, positive)
            b = j_synthetic_pair(jrng, cfg, positive)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            assert a[2] == b[2]


def _split_rows():
    rows = []
    # identity A split into ids 1 and 2 with a 6-frame gap
    for f in range(1, 21):
        rows.append([f, 1, 100 + 3.0 * f, 50 + 1.0 * f, 40, 90, 1, -1, -1,
                     -1])
    for f in range(27, 46):
        rows.append([f, 2, 100 + 3.0 * f, 50 + 1.0 * f, 40, 90, 1, -1, -1,
                     -1])
    # identity B far away, overlapping in time (must stay separate)
    for f in range(1, 46):
        rows.append([f, 7, 900 - 2.0 * f, 700, 40, 90, 1, -1, -1, -1])
    return np.asarray(rows, np.float64)


def test_training_learns_and_linker_merges():
    model, acc = train_aflink_synthetic(steps=150, batch=64, seed=0,
                                        device="cpu")
    assert isinstance(model, AFLinkModel) and not model.training
    assert acc > 0.8, f"synthetic AFLink training failed to learn: {acc}"
    linked = postprocess.aflink(_split_rows(), model=model)
    ids_a_tail = np.unique(linked[(linked[:, 0] >= 27)
                                  & (linked[:, 2] < 500), 1])
    assert ids_a_tail.tolist() == [1.0], "split trajectory was not merged"
    assert 7.0 in np.unique(linked[:, 1]), "distant identity must survive"
    assert 2.0 not in np.unique(linked[:, 1])


def test_cli_aflink_synthetic_trains_and_links(mot_fixture, tmp_path,  # noqa
                                               monkeypatch, capsys):
    """``--aflink synthetic`` trains the link model (200 steps, as
    busca_tpu's CLI) and links the written rows with it: the output equals
    the unlinked run's rows through ``aflink`` with that model."""
    linked_with = []
    orig = postprocess.aflink

    def recorded(results, model=None, **kw):
        linked_with.append(model)
        return orig(results, model=model, **kw)

    monkeypatch.setattr(postprocess, "aflink", recorded)
    argv = ["--mot-dir", mot_fixture, "--tracker", "strongsort",
            "--max-frames", "5", "--device", "cpu"]
    trun.main(argv + ["--output-dir", str(tmp_path / "plain")])
    trun.main(argv + ["--output-dir", str(tmp_path / "linked"),
                      "--aflink", "synthetic"])
    out = capsys.readouterr().out
    assert "aflink: synthetic-trained link model (acc" in out
    acc = float(out.split("(acc ")[1].split(")")[0])
    assert acc > 0.8
    assert len(linked_with) == 1 and isinstance(linked_with[0], AFLinkModel)
    name = "MOT17-05-FRCNN.txt"
    plain = np.loadtxt(tmp_path / "plain" / name, delimiter=",", ndmin=2)
    got = np.loadtxt(tmp_path / "linked" / name, delimiter=",", ndmin=2)
    want = orig(plain, model=linked_with[0])
    np.testing.assert_allclose(got[:, :6], want[:, :6], atol=0.01)
