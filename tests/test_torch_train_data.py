"""The port's training episodes (busca_tpu_torch.train.data) against
busca_tpu's on the CPU: ``synthetic_batch`` bit for bit for the same
``RandomState`` (``mem_stride_max`` 1 and 4), and ``MotEpisodeSampler``
on a MOT directory written to disk (tests/test_mot_episodes.py's fixture):
labels and boxes equal, crops within one uint8 step.

The crops are the crop op's in both packages: busca_tpu's through XLA,
the port's through its plain version on the CPU (K1 on the card).  The
two round a rare value of the resampling to the other uint8 neighbour
(ROADMAP.md Queue 3), so a normalized crop value may differ by one step,
1 / (255 * 0.224) (the smallest of the GHOST stds), on at most 1e-3 of
the values (measured: at most 1.1e-4 of them at 48x24, none at 32x16).
"""

import numpy as np
import pytest
import torch

from busca_tpu.train.data import EpisodeSpec as JSpec
from busca_tpu.train.data import MotEpisodeSampler as JSampler
from busca_tpu.train.data import synthetic_batch as j_synthetic_batch
from busca_tpu_torch.models.busca import (
    INPUT_PIXEL_MEAN_BGR,
    INPUT_PIXEL_STD_BGR,
    BuscaConfig,
    BuscaModel,
)
from busca_tpu_torch.train.data import (
    EpisodeSpec,
    MotEpisodeSampler,
    synthetic_batch,
)
from busca_tpu_torch.train.trainer import make_optimizer, make_train_step
from test_mot_episodes import mot_dir  # noqa: F401 (the fixture)

LSB = 1.0 / (255.0 * 0.224) + 1e-6
LSB_SHARE = 1e-3
SAMPLER_SPECS = [dict(batch=6, seq_len=4, num_candidates=3, crop_hw=(48, 24)),
                 dict(batch=8, seq_len=3, num_candidates=4, crop_hw=(32, 16))]


@pytest.mark.parametrize("stride", [1, 4])
def test_synthetic_batch_equals_busca_tpu(stride):
    kw = dict(batch=6, seq_len=3, num_candidates=2, crop_hw=(64, 32),
              mem_stride_max=stride)
    got = synthetic_batch(np.random.RandomState(5), EpisodeSpec(**kw))
    want = j_synthetic_batch(np.random.RandomState(5), JSpec(**kw))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert EpisodeSpec(**kw).num_choices == JSpec(**kw).num_choices


@pytest.mark.parametrize("spec_i", range(len(SAMPLER_SPECS)))
def test_sampler_matches_busca_tpu(mot_dir, spec_i):  # noqa: F811
    kw = SAMPLER_SPECS[spec_i]
    sampler = MotEpisodeSampler([mot_dir], EpisodeSpec(**kw), device="cpu")
    jsampler = JSampler([mot_dir], JSpec(**kw))
    for seed in (0, 1, 2):
        got = sampler.batch(np.random.RandomState(seed))
        want = jsampler.batch(np.random.RandomState(seed))
        for k in ("labels", "mem_boxes", "can_boxes"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("mem_crops", "can_crops"):
            assert got[k].shape == want[k].shape and got[k].dtype == \
                want[k].dtype
            gap = np.abs(got[k] - want[k])
            assert gap.max() <= LSB, (k, gap.max())
            assert (gap > 1e-6).mean() <= LSB_SHARE, k


def test_one_crop_call_per_sequence_frame(mot_dir, monkeypatch):  # noqa: F811
    import busca_tpu_torch.trackers.base as base

    calls = []
    orig = base.extract_uint8_crops

    def counted(frame, boxes, crop_hw, bank=None, device="cuda"):
        calls.append(len(boxes))
        return orig(frame, boxes, crop_hw, bank, device)

    monkeypatch.setattr(base, "extract_uint8_crops", counted)
    spec = EpisodeSpec(batch=8, seq_len=4, num_candidates=3,
                       crop_hw=(48, 24))
    sampler = MotEpisodeSampler([mot_dir], spec, device="cpu")
    frames = []
    orig_frame = sampler._frame
    sampler._frame = lambda si, f: frames.append((si, f)) or orig_frame(si, f)
    b = sampler.batch(np.random.RandomState(3))
    assert len(calls) == len(frames) == len(set(frames))
    # every memory crop and every candidate slot with a gt box is cropped;
    # a slot without one keeps the normalized zero crop
    zero = ((0.0 - INPUT_PIXEL_MEAN_BGR) / INPUT_PIXEL_STD_BGR)[::-1]
    n_can = int((~np.isclose(b["can_crops"], zero).all(axis=(2, 3, 4)))
                .sum())
    assert sum(calls) == spec.batch * spec.seq_len + n_can
    assert len(calls) < sum(calls)  # the batch's boxes share frames


def test_sampler_batches_drive_the_train_step(mot_dir):  # noqa: F811
    """tests/test_mot_episodes.py::test_trains_one_step on the port."""
    spec = EpisodeSpec(batch=2, seq_len=3, num_candidates=2,
                       crop_hw=(32, 16))
    batch = MotEpisodeSampler([mot_dir], spec, device="cpu").batch(
        np.random.RandomState(2))
    cfg = BuscaConfig(num_layer=1, reid_num_classes=5,
                      reid_layers=(1, 1, 1, 1))
    model = BuscaModel(cfg).init_weights(torch.Generator().manual_seed(0))
    step = make_train_step(model, make_optimizer(model.parameters()))
    metrics = step(batch, torch.Generator().manual_seed(1))
    assert np.isfinite(float(metrics["loss"]))
