"""The port's ReID feature extractor against busca_tpu's, on the CPU, with
the weights carried through the weight bridge
(``convert.resnet_state_dict_from_flax``): a small ResNet (layers
(1, 1, 1, 1)), 64x32 crops, buckets up to 8.

Batch-stat BN makes the batch part of the function, so a batch above the
largest bucket must be split at the same boundaries as busca_tpu splits it
(chunks of 8 here, 256 by default).  Bound: max |diff| of the
L2-normalized features <= 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from busca_tpu.eval.features import ReidFeatureExtractor as JExtractor
from busca_tpu.models.checkpoint import save_params_npz
from busca_tpu_torch.eval.features import ReidFeatureExtractor
from busca_tpu_torch.models.convert import resnet_state_dict_from_flax
from test_torch_strongsort import one_torch_thread  # noqa: F401

CROP_HW = (64, 32)
SMALL = dict(layers=(1, 1, 1, 1), num_classes=7, crop_hw=CROP_HW,
             buckets=(1, 2, 4, 8))
FEAT_TOL = 1e-4


@pytest.fixture(scope="module")
def extractors():
    jext = JExtractor(**SMALL)
    variables = jax.tree_util.tree_map(np.asarray, jext.variables)
    text = ReidFeatureExtractor(resnet_state_dict_from_flax(variables),
                                device="cpu", **SMALL)
    return jext, text, variables


def _crops(seed, n):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (n,) + CROP_HW + (3,)).astype(np.uint8)


def test_empty_input(extractors):
    jext, text, _ = extractors
    empty = np.zeros((0,) + CROP_HW + (3,), np.uint8)
    assert text(empty).shape == jext(empty).shape == (0, 512)
    assert text([]).shape == (0, 512)


@pytest.mark.parametrize("n", [1, 5, 8])
def test_features_match_jax(extractors, n):
    jext, text, _ = extractors
    crops = _crops(n, n)
    got, want = text(crops), jext(crops)
    assert got.shape == want.shape == (n, 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_chunk_boundary_above_largest_bucket(extractors):
    """11 crops run as 8 + 3, each chunk with its own BN statistics; the
    single 11-crop batch is a different function, which the bound sees."""
    jext, text, _ = extractors
    crops = _crops(11, 11)
    got, want = text(crops), jext(crops)
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_TOL)
    np.testing.assert_allclose(got[:8], text(crops[:8]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[8:], text(crops[8:]), rtol=0, atol=1e-6)
    one_batch = ReidFeatureExtractor(
        resnet_state_dict_from_flax(extractors[2]), device="cpu",
        **dict(SMALL, buckets=(16,)))(crops)
    assert np.abs(one_batch - want).max() > 10 * FEAT_TOL


def test_device_crops_equal_host_crops(extractors):
    """Crops handed over as a float tensor of uint8 values (the crop op's
    output) give the features of the same crops as a host uint8 array."""
    _, text, _ = extractors
    crops = _crops(3, 6)
    np.testing.assert_array_equal(
        text(torch.from_numpy(crops).to(torch.float32)), text(crops))
    np.testing.assert_array_equal(text(list(crops)), text(crops))


def test_padded_lanes_do_not_change_features(extractors):
    """busca_tpu's masked padded bucket and the port's exact batch are the
    same function: 5 crops padded to 8 with a sample mask equal the 5 crops
    alone, on the port's network and on busca_tpu's extractor."""
    jext, text, _ = extractors
    crops = _crops(4, 5)
    x = torch.from_numpy(crops).to(torch.float32)
    x = ((x / 255.0 - text._mean) / text._std).flip(-1)
    padded = torch.cat([x, torch.zeros((3,) + x.shape[1:])])
    mask = torch.tensor([1.0] * 5 + [0.0] * 3)
    with torch.no_grad():
        _, masked = text.model(padded, sample_mask=mask)
        _, exact = text.model(x)
    np.testing.assert_allclose(masked[:5].numpy(), exact.numpy(), rtol=0,
                               atol=FEAT_TOL)
    np.testing.assert_allclose(exact.numpy(), jext(crops), rtol=0,
                               atol=FEAT_TOL)


def test_from_checkpoint_npz_saved_by_busca_tpu(extractors, tmp_path):
    jext, _, variables = extractors
    path = str(tmp_path / "reid.npz")
    save_params_npz(path, variables)
    loaded = ReidFeatureExtractor.from_checkpoint(path, device="cpu",
                                                  **SMALL)
    crops = _crops(6, 5)
    np.testing.assert_allclose(loaded(crops), jext(crops), rtol=0,
                               atol=FEAT_TOL)


def test_from_checkpoint_reference_pth(extractors, tmp_path):
    """A reference-layout ``.pth`` (DataParallel ``module.`` keys in a
    ``state_dict`` envelope, with the unused ``fc_person`` head) loads."""
    jext, text, _ = extractors
    sd = {f"module.{k}": v for k, v in text.model.state_dict().items()}
    sd["module.fc_person.weight"] = torch.zeros(3, 512)
    path = str(tmp_path / "model_feats.pth")
    torch.save({"state_dict": sd}, path)
    loaded = ReidFeatureExtractor.from_checkpoint(path, device="cpu",
                                                  **SMALL)
    crops = _crops(8, 4)
    np.testing.assert_array_equal(loaded(crops), text(crops))
    with pytest.raises(KeyError, match="missing"):
        ReidFeatureExtractor({"conv1.weight": sd["module.conv1.weight"]},
                             device="cpu", **SMALL)
