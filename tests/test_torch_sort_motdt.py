"""The port's SORT and MOTDT trackers (busca_tpu_torch/trackers/{sort,
motdt}.py) against busca_tpu's, frame by frame, on seeded random streams:
objects born and dying mid-stream, pairs that cross, missed frames, score
dips below the trackers' thresholds, false positives and box noise.  MOTDT
takes its features from a seeded table (an identity vector per object plus
noise, a random one per false positive), and once through each package's
``FeatureShim`` with a small ReID extractor on rendered frames.  Track ids,
boxes and scores must be equal on every frame (both run the same float64
host arithmetic).
"""

import numpy as np
import pytest

from busca_tpu.eval import run as jrun
from busca_tpu.trackers import motdt as jmotdt
from busca_tpu.trackers import sort as jsort
from busca_tpu.trackers.base import IdCounter as JIdCounter
from busca_tpu_torch.eval import run as trun
from busca_tpu_torch.trackers import motdt as tmotdt
from busca_tpu_torch.trackers import sort as tsort
from busca_tpu_torch.trackers.base import IdCounter
from test_pipeline_fuzz import _random_sequence
from test_torch_byte_pipeline import CROP_HW
from test_torch_ghost import extractors  # noqa: F401 (the fixture)
from test_torch_strongsort import one_torch_thread  # noqa: F401

STREAMS = range(10)
FEAT_DIM = 16


def random_stream(seed, n_frames=40, w=640, h=360):
    """Per frame ``(boxes_tlbr [N, 4], scores [N], features [N, 16])``."""
    rng = np.random.RandomState(seed)
    table = rng.randn(64, FEAT_DIM)
    objs = []
    for k in range(int(rng.randint(4, 9))):
        bw, bh = rng.uniform(20, 60), rng.uniform(50, 140)
        start = int(rng.randint(0, n_frames // 2)) if k % 2 else 0
        end = int(rng.randint(n_frames // 2, n_frames + 1)) if k % 3 \
            else n_frames
        x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
        vx, vy = rng.uniform(-4, 4), rng.uniform(-2, 2)
        objs.append(dict(bw=bw, bh=bh, x0=x0, y0=y0, vx=vx, vy=vy,
                         start=start, end=end, feat=table[k]))
    # a crossing: two objects that pass through each other mid-stream
    mid = n_frames / 2
    for sign in (1, -1):
        objs.append(dict(bw=40.0, bh=100.0, x0=w / 2 - sign * 6 * mid - 20,
                         y0=h / 2 - 50, vx=sign * 6.0, vy=0.0, start=0,
                         end=n_frames, feat=table[len(objs)]))
    for o in objs:
        o["miss"] = set(rng.randint(0, n_frames, int(rng.randint(0, 6))))
        d0 = int(rng.randint(0, n_frames))
        o["dip"] = set(range(d0, d0 + int(rng.randint(0, 6))))
    frames = []
    for t in range(n_frames):
        boxes, scores, feats = [], [], []
        for o in objs:
            if not o["start"] <= t < o["end"] or t in o["miss"]:
                continue
            x = o["x0"] + o["vx"] * t + rng.randn()
            y = o["y0"] + o["vy"] * t + rng.randn()
            boxes.append([x, y, x + o["bw"] + rng.randn(),
                          y + o["bh"] + rng.randn()])
            scores.append(rng.uniform(0.2, 0.5) if t in o["dip"]
                          else rng.uniform(0.6, 0.98))
            feats.append(o["feat"] + 0.3 * rng.randn(FEAT_DIM))
        for _ in range(int(rng.randint(0, 3))):  # false positives
            x, y = rng.uniform(0, w - 40), rng.uniform(0, h - 90)
            boxes.append([x, y, x + 40, y + 90])
            scores.append(rng.uniform(0.3, 0.8))
            feats.append(rng.randn(FEAT_DIM))
        frames.append((np.asarray(boxes, np.float64).reshape(-1, 4),
                       np.asarray(scores, np.float64),
                       np.asarray(feats, np.float64).reshape(-1, FEAT_DIM)))
    return frames


def assert_same_tracks(got, want, where):
    assert [t.track_id for t in got] == [t.track_id for t in want], where
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tlwh, b.tlwh, err_msg=where)
        assert a.score == b.score, where


def fresh_ids():
    jsort.SortTrack._count = JIdCounter(1)
    tsort.SortTrack._count = IdCounter(1)
    jmotdt.MotdtTrack._count = JIdCounter(1)
    tmotdt.MotdtTrack._count = IdCounter(1)


@pytest.mark.parametrize("seed", STREAMS)
def test_sort_matches_jax(seed):
    fresh_ids()
    kw = dict(det_thresh=0.5, min_hits=2, max_age=5)
    jt = jsort.SortTracker(jsort.SortConfig(**kw))
    tt = tsort.SortTracker(tsort.SortConfig(**kw))
    births, outputs = 0, 0
    for t, (boxes, scores, _) in enumerate(random_stream(seed)):
        want = jt.update(boxes.copy(), scores.copy(), 2.0)
        got = tt.update(boxes.copy(), scores.copy(), 2.0)
        assert_same_tracks(got, want, f"stream {seed} frame {t + 1}")
        outputs += len(got)
    births = next(tsort.SortTrack._count) - 1
    assert outputs > 0 and births > 4


@pytest.mark.parametrize("seed", STREAMS)
def test_motdt_matches_jax(seed):
    fresh_ids()
    kw = dict(max_time_lost=6)
    jt = jmotdt.MotdtTracker(jmotdt.MotdtConfig(**kw))
    tt = tmotdt.MotdtTracker(tmotdt.MotdtConfig(**kw))
    lost = 0
    for t, (boxes, scores, feats) in enumerate(random_stream(100 + seed)):
        want = jt.update(boxes.copy(), scores.copy(), feats.copy())
        got = tt.update(boxes.copy(), scores.copy(), feats.copy())
        assert_same_tracks(got, want, f"stream {seed} frame {t + 1}")
        lost += sum(tr.is_lost for tr in tt.tracks)
    assert lost > 0, "no track ever lived on its prediction alone"


def test_motdt_through_feature_shims(one_torch_thread,  # noqa: F811
                                     extractors):  # noqa: F811
    """Both CLIs' ``make_tracker("motdt")`` + ``shim_for_runner`` with a
    small ReID extractor on a rendered stream: the port cuts the crops
    from the frame on the extractor's device (K1 on the card), busca_tpu
    on the host.  Features agree to ~1e-6, far inside the appearance
    threshold's margins on this stream."""
    fresh_ids()
    jext, text = extractors
    seq = _random_sequence(909)
    kwargs = {"track_thresh": 0.5}
    jshim = jrun.shim_for_runner(
        "motdt", jrun.make_tracker("motdt", kwargs, None, CROP_HW), jext,
        CROP_HW)
    tshim = trun.shim_for_runner(
        "motdt", trun.make_tracker("motdt", kwargs, None, CROP_HW), text,
        CROP_HW)
    assert tshim.trk.cfg.min_cls_score == 0.5
    calls0 = text.calls
    for t in range(seq.num_frames):
        frame = seq.frame(t)
        boxes, scores = seq.detections(t)
        want = jshim.update(boxes.copy(), scores.copy(), 1.0, frame)
        got = tshim.update(boxes.copy(), scores.copy(), 1.0, frame)
        assert_same_tracks(got, want, f"frame {t + 1}")
    assert text.calls > calls0
    feats = [tr.smooth_feat for tr in tshim.trk.tracks]
    assert feats and all(f.shape == (512,) for f in feats)
