"""The port's offline post-processing against busca_tpu's, on the CPU:
linear interpolation and GSI on seeded rows (max |diff| <= 1e-9), the
AFLink link model's logits with the flax parameters carried through
``convert.aflink_state_dict_from_flax`` (<= 1e-5), and the linker's rows on
tracklet scenes.

The linker takes candidate pairs greedily by descending probability, so a
reordering of two probabilities within the logits' tolerance could change
the links.  The scenes' candidate probabilities are checked to lie more
than 1e-5 apart (and from ``thrP``) before the rows are held equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from busca_tpu.models.aflink import AFLinkModel as JAFLink
from busca_tpu.models.aflink import synthetic_batch
from busca_tpu.trackers import postprocess as jpp
from busca_tpu_torch.models.aflink import (
    SEG_LEN,
    AFLinkConfig,
    AFLinkModel,
    normalize_segment,
)
from busca_tpu_torch.models.convert import aflink_state_dict_from_flax
from busca_tpu_torch.trackers import postprocess as tpp
from test_postprocess_oracle import _fragmenting_rows
from test_torch_strongsort import one_torch_thread  # noqa: F401

INTERP_TOL = 1e-9
LOGIT_TOL = 1e-5
THR_P = 0.05


def _rows(seed, n_ids=5, n_frames=40):
    """Seeded MOT rows with gaps of 1-25 frames and jittered boxes."""
    rng = np.random.RandomState(seed)
    rows = []
    for tid in range(1, n_ids + 1):
        frames = np.sort(rng.choice(np.arange(1, n_frames + 1),
                                    rng.randint(3, n_frames // 2),
                                    replace=False))
        x0, y0, vx = rng.uniform(0, 500, 2).tolist() + [rng.uniform(-3, 3)]
        for f in frames:
            rows.append([f, tid, x0 + vx * f + rng.randn(),
                         y0 + rng.randn(), 40 + rng.randn(),
                         90 + rng.randn(), rng.uniform(0.5, 1), -1, -1, -1])
    return np.asarray(rows, np.float64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interpolation_and_gsi_match_jax(seed):
    rows = _rows(seed)
    for interval in (5, 20):
        got = tpp.linear_interpolation(rows, interval)
        want = jpp.linear_interpolation(rows, interval)
        assert got.shape == want.shape and len(got) > len(rows)
        np.testing.assert_allclose(got, want, rtol=0, atol=INTERP_TOL)
    for tau in (5.0, 10.0):
        got = tpp.gaussian_smoothed_interpolation(rows, tau=tau)
        want = jpp.gaussian_smoothed_interpolation(rows, tau=tau)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=INTERP_TOL)
    assert len(tpp.linear_interpolation(rows[:0])) == 0


@pytest.fixture(scope="module")
def link_models():
    """busca_tpu's AFLinkModel with seeded ``init`` parameters, and the
    port's with the same parameters."""
    s1, s2, _ = synthetic_batch(np.random.RandomState(3), 4, AFLinkConfig())
    model = JAFLink()
    params = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(11), s1, s2)["params"])
    tmodel = AFLinkModel()
    tmodel.load_state_dict(aflink_state_dict_from_flax(params))
    return model, params, tmodel.eval()


def test_aflink_logits_match_flax(link_models):
    model, params, tmodel = link_models
    s1, s2, _ = synthetic_batch(np.random.RandomState(9), 16, AFLinkConfig())
    want = np.asarray(model.apply({"params": params}, jnp.asarray(s1),
                                  jnp.asarray(s2)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(s1), torch.from_numpy(s2)).numpy()
    assert got.shape == want.shape == (16, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)


def test_normalize_segment_matches_jax():
    from busca_tpu.models.aflink import normalize_segment as jnorm

    rows = _rows(4)[:12]
    for tail in (True, False):
        np.testing.assert_array_equal(
            normalize_segment(rows, 20.0, AFLinkConfig(), tail),
            jnorm(rows, 20.0, AFLinkConfig(), tail))
    assert normalize_segment(rows, 0, AFLinkConfig(), True).shape == \
        (SEG_LEN, 3)


def _split_scene():
    """tests/test_aflink.py's scene: one identity split into ids 1 and 2
    by a 6-frame gap, a distant identity 7 overlapping in time."""
    rows = []
    for f in range(1, 21):
        rows.append([f, 1, 100 + 3.0 * f, 50 + 1.0 * f, 40, 90, 1, -1, -1,
                     -1])
    for f in range(27, 46):
        rows.append([f, 2, 100 + 3.0 * f, 50 + 1.0 * f, 40, 90, 1, -1, -1,
                     -1])
    for f in range(1, 46):
        rows.append([f, 7, 900 - 2.0 * f, 700, 40, 90, 1, -1, -1, -1])
    return np.asarray(rows, np.float64)


def _near_ties(probs):
    p = np.sort(probs)
    return int((np.diff(p) <= LOGIT_TOL).sum()
               + (np.abs(p - THR_P) <= LOGIT_TOL).sum())


@pytest.mark.parametrize("scene", ["fragmenting", "split"])
def test_aflink_rows_match_jax(link_models, scene):
    model, params, tmodel = link_models
    rows = _fragmenting_rows() if scene == "fragmenting" else _split_scene()
    tracks = tpp._split_tracks(rows)
    cands = tpp.link_candidates(tracks)
    assert cands, "no candidate pair"
    probs = tpp.candidate_probs(tracks, cands, tmodel)
    assert _near_ties(probs) == 0, "a near-tie would make the order noise"
    got = tpp.aflink(rows, model=tmodel)
    want = jpp.aflink(rows, model=model, params=params)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[:, 1])) < len(np.unique(rows[:, 1])), \
        "no link fired"


def test_aflink_requires_model():
    with pytest.raises(ValueError):
        tpp.aflink(np.zeros((2, 10)))
