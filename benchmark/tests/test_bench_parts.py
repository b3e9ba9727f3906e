"""A configuration's models are parts found by file
(``benchmark/bmk/parts/<role>_<kind>.py``): every part a configuration
names is there, a missing one stops the run before any weights are drawn,
the harness's core names no model, and a new detector kind is new files and
entries only."""

import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from bmk import parts

from conftest import BENCH, ROOT

PROVIDES = {
    "detector": ("make_weights", "build", "wrap", "gaps", "flops"),
    "extractor": ("make_weights", "build", "wrap", "watch", "gaps", "flops"),
    "tracker": ("reference", "start", "replay"),
}
MODEL_NAMES = {"RefYolox", "YoloxDetector", "ByteTracker", "GhostTracker",
               "ReidFeatureExtractor"}
MODEL_KINDS = {"yolox", "byte", "ghost"}


def bench_json():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def config_of(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


def test_every_part_a_configuration_names_is_a_file():
    seen = set()
    for c in bench_json()["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            named = parts.named(json.load(f))
        assert "tracker" in named
        for role, kind in named.items():
            path = parts.path(role, kind)
            assert os.path.dirname(path) == os.path.join(BENCH, "bmk",
                                                         "parts")
            assert os.path.exists(path), path
            mod = parts.part(role, kind)
            assert all(callable(getattr(mod, fn)) for fn in PROVIDES[role])
            seen.add(role)
    assert seen == set(PROVIDES)


def checkout_copy(tmp_path, program=False):
    """The checkout's ``BENCHMARK.json`` and ``benchmark/`` in ``tmp_path``
    (with the program beside them where ``program``)."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    if program:
        os.symlink(os.path.join(ROOT, "busca_tpu_torch"),
                   tmp_path / "busca_tpu_torch")
    return tmp_path


def add_config(root, name, detector_kind):
    """A copy of ``byte_mot20`` under ``name`` whose detector is
    ``detector_kind``, and its served4 cell, added to the copy's
    ``BENCHMARK.json``; returns the cell's name."""
    config = config_of("byte_mot20")
    config["name"] = name
    config["detector"]["kind"] = detector_kind
    rel = f"benchmark/configs/{name}.json"
    (root / rel).write_text(json.dumps(config, indent=1))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = dict(next(c for c in bench["configs"]
                      if c["name"] == "byte_mot20"), name=name, file=rel)
    bench["configs"].append(entry)
    cell = f"{name}.served4"
    bench["workloads"].append({"name": cell, "config": name,
                               "traffic": "served4", "chips": 1,
                               "why": "the served4 cell of a copy"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return cell


def run_copy(root, cell, *extra, timeout=120):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2**31 + 23), "--seconds", "8", "--trace", "1", "--rehearse",
         *extra], cwd=root, env=env, capture_output=True, text=True,
        timeout=timeout)


def test_a_missing_part_stops_the_run_and_names_its_file(tmp_path):
    root = checkout_copy(tmp_path)
    cell = add_config(root, "byte_nodet", "nodet")
    proc = run_copy(root, cell)
    assert proc.returncode == 2
    assert not proc.stdout.strip()
    assert "benchmark/bmk/parts/detector_nodet.py" in proc.stderr


def core_sources():
    for sub in ("bmk", "metrics"):
        for d, dirs, files in os.walk(os.path.join(BENCH, sub)):
            dirs[:] = [x for x in dirs if x != "parts"]
            for f in files:
                if f.endswith(".py"):
                    yield os.path.join(d, f)


def model_references(path):
    """The model names and kinds a source names in its code or holds as a
    whole string (docstrings and comments aside)."""
    tree = ast.parse(open(path).read(), path)
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            names = [node.id]
        elif isinstance(node, ast.Attribute):
            names = [node.attr]
        elif isinstance(node, ast.alias):
            names = [node.name.split(".")[-1], node.asname]
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names = [node.name]
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            names = [node.value]
        else:
            names = []
        found |= {n for n in names if n in MODEL_NAMES | MODEL_KINDS}
    return found


def test_the_core_names_no_model():
    found = {os.path.relpath(p, BENCH): model_references(p)
             for p in core_sources()}
    assert "bmk/parts.py" in found and "metrics/step_mfu.py" in found
    assert {p: f for p, f in found.items() if f} == {}


@pytest.mark.parametrize("source,want", [
    ("from benchref.detector import RefYolox\n", {"RefYolox"}),
    ("if t['name'] == 'ghost':\n    pass\n", {"ghost"}),
    ("x = cls.__name__ == 'GhostTracker' or kind in ('byte',)\n",
     {"GhostTracker", "byte"}),
    ('"""A YOLOX detector, ``RefYolox`` and ByteTracker."""\n', set()),
])
def test_the_model_scan_sees_code_not_prose(tmp_path, source, want):
    p = tmp_path / "m.py"
    p.write_text(source)
    assert model_references(str(p)) == want


def digests(root):
    out = {}
    for d, dirs, files in os.walk(root / "benchmark"):
        dirs[:] = [x for x in dirs if x not in ("_build", "__pycache__")]
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_a_new_detector_kind_is_files_and_entries_only(tmp_path):
    root = checkout_copy(tmp_path, program=True)
    before = digests(root)
    (root / "benchmark/bmk/parts/detector_yolox_again.py").write_text(
        '"""YOLOX under another kind: every function of detector_yolox."""'
        "\n\nfrom bmk.parts import part\n\n"
        "_yolox = part(\"detector\", \"yolox\")\n"
        "make_weights, build, wrap, gaps, flops = (\n"
        "    _yolox.make_weights, _yolox.build, _yolox.wrap, _yolox.gaps,\n"
        "    _yolox.flops)\n")
    cell = add_config(root, "byte_again", "yolox_again")
    proc = run_copy(root, cell, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result
    assert {"det_box_rel", "det_score", "det_unmatched"} <= set(
        result["checks"])
    after = digests(root)
    assert {p: h for p, h in before.items() if after.get(p) != h} == {}
    assert set(after) - set(before) == {
        "benchmark/bmk/parts/detector_yolox_again.py",
        "benchmark/configs/byte_again.json"}


def test_step_mfu_counts_each_forward_through_its_part():
    """The parts' operations are the counts ``bmk.flops`` gives each model,
    summed over the peaks of their dtypes as before the parts."""
    import types

    from bmk.flops import (PEAKS, busca_call_flops, reid_flops_per_crop,
                           yolox_flops)
    from bmk.spec import metric_reader

    config = config_of("byte_mot20")
    config["reid"] = config_of("ghost_mot20")["reid"]
    d, r, b = config["detector"], config["reid"], config["busca"]
    forwards = [("detector", 0.1, 2), ("busca", 0.2, 3, 11, 8),
                ("extractor", 0.3, 19), ("tracks", 0.4, 3),
                ("detector", 1.5, 1)]
    run = types.SimpleNamespace(
        device=object(), config=config, forwards=forwards,
        in_profiled=lambda t: 0.0 <= t < 1.0,
        profiled_seconds=lambda: 1.0)
    want = (yolox_flops(d["size"], int(d["num_classes"]),
                        tuple(d["test_size"])) * 2 / PEAKS[d["dtype"]]
            + busca_call_flops(b, 3, 11, 8, b["crop_hw"]) / PEAKS[b["dtype"]]
            + reid_flops_per_crop(tuple(r["layers"]), int(r["num_classes"]),
                                  tuple(r["crop_hw"])) * 19
            / PEAKS[r["dtype"]])
    assert metric_reader("step_mfu")(run) == 100.0 * want
