"""A cell is found by name: a new mix file and a new entry make a
resolvable cell without an edit to any file that is there."""

import json
import os
import shutil

import numpy as np

from bmk import spec, traffic

from conftest import BENCH, ROOT


def test_new_mix_file_is_a_cell(tmp_path, monkeypatch):
    here = tmp_path / "benchmark"
    shutil.copytree(os.path.join(BENCH, "mixes"), here / "mixes")
    shutil.copytree(os.path.join(BENCH, "configs"), here / "configs")
    before = {p: (here / "mixes" / p).read_bytes()
              for p in os.listdir(here / "mixes")}
    with open(os.path.join(BENCH, "mixes", "crowd_clear.json")) as f:
        mix = json.load(f)
    mix["streams"][0].update(height=720, width=1280, objects=48)
    (here / "mixes" / "crowd_720p.json").write_text(json.dumps(mix))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [dict(c, file=str(here / "configs" /
                                         os.path.basename(c["file"])))
                        for c in bench["configs"]]
    bench["workloads"].append({"name": "ghost_mot20.crowd_720p",
                               "config": "ghost_mot20",
                               "traffic": "crowd_720p", "chips": 1,
                               "why": "a new mix"})
    monkeypatch.setattr(spec, "HERE", str(here))
    cell, config, got = spec.resolve_cell(bench, "ghost_mot20.crowd_720p")
    assert got["streams"][0]["objects"] == 48
    assert config["name"] == "ghost_mot20"
    (stream,) = traffic.streams(traffic.rehearsal(got), 2**31 + 5)
    assert stream.shape == (72, 128, 3)
    ends = {m["name"] for m in spec.metrics_for(bench, cell["name"],
                                                "end_to_end")}
    assert ends == {"frames_per_s", "frame_ms_p50", "frame_ms_p95",
                    "setup_s"}
    assert before == {p: (here / "mixes" / p).read_bytes() for p in before}


def test_every_metric_has_a_reader_and_every_cell_its_files(monkeypatch):
    monkeypatch.chdir(ROOT)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    for cell in bench["workloads"]:
        spec.resolve_cell(bench, cell["name"])


def test_seed_changes_order_not_work():
    """Every seed plays the same rendered crowd (the mix's
    ``traffic_seed``), from its own starting points."""
    with open(os.path.join(BENCH, "mixes", "crowd_dropout.json")) as f:
        mix = json.load(f)
    a = traffic.streams(mix, 1)[0].sequence
    b = traffic.streams(mix, 2**31 + 7)[0].sequence
    assert len(a.objects) == len(b.objects) == 96
    assert [o.x0 for o in a.objects] == [o.x0 for o in b.objects]
    assert traffic.phases(mix, 1) != traffic.phases(mix, 2**31 + 7)
    share = [np.mean([not o.detected_at(t) for o in a.objects])
             for t in range(a.num_frames)]
    assert 0.05 < float(np.mean(share)) < 0.15
    n = mix["frames"]
    assert [traffic.pingpong(k, n) for k in range(2 * n)][n - 2:n + 2] == [
        n - 2, n - 1, n - 2, n - 3]


def test_reference_tracker_refuses_what_it_was_cut_without():
    """Both configurations build their reference tracker; an option the
    reference copy does not run is refused, never dropped."""
    import pytest

    from bmk.check import _ref_tracker

    for name in ("byte_mot20", "ghost_mot20"):
        with open(os.path.join(BENCH, "configs", name + ".json")) as f:
            config = json.load(f)
        cls, cfg = _ref_tracker(config)
        assert cfg.use_busca
        on = {"byte_mot20": {"use_camera_motion_compensation": True},
              "ghost_mot20": {"motion_compensation": True}}[name]
        for k, v in list(on.items()) + [("mem_cap", 64), ("unknown", 1)]:
            bad = dict(config, tracker=dict(config["tracker"], kwargs=dict(
                config["tracker"]["kwargs"], **{k: v})))
            with pytest.raises(ValueError, match=k):
                _ref_tracker(bad)
