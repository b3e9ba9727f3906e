"""Multi-process data-parallel evaluation of the port, run for real: two
gloo ranks (spawned OS processes, torch only) each track their
``shard_sequences`` share of the synthetic dropout sequences, and
``global_metrics`` sums their float64 tallies with one ``all_reduce``.
The merged metrics must equal busca_tpu's single-process
``global_metrics`` over all the sequences (tests/test_multiprocess_dp.py's
bars: counts equal, rates within 1e-9).

On a one-rank group, ``global_metrics(group=...)`` and ``psum_tallies``
run their collective and equal the local sums exactly.
"""

import json

import numpy as np
import pytest
import torch.distributed as dist

from busca_tpu.eval.runner import evaluate_sequence as j_evaluate_sequence
from busca_tpu.eval.runner import global_metrics as j_global_metrics
from busca_tpu.eval.runner import run_sequence as j_run_sequence
from busca_tpu.eval.runner import shard_sequences as j_shard_sequences
from busca_tpu.eval.synthetic import default_dropout_sequence
from busca_tpu.trackers.byte import ByteTracker, ByteTrackerConfig
from busca_tpu_torch.eval.runner import (
    global_metrics,
    metrics_to_tally,
    psum_tallies,
    shard_sequences,
)
from busca_tpu_torch.parallel.dryrun import free_port, launch
from busca_tpu_torch.parallel.mesh import make_mesh

SEQUENCES, FRAMES = 4, 30
RATE_ATOL = 1e-9
COUNTS = ("num_switches", "num_false_positives", "num_misses",
          "num_matches", "num_gt", "mostly_tracked", "mostly_lost",
          "num_pred")
RATES = ("mota", "motp", "idf1", "idp", "idr")


def _jax_per_seq():
    per_seq = {}
    for i in range(SEQUENCES):
        seq = default_dropout_sequence(num_frames=FRAMES, seed=i)
        dets = [seq.detections(t) for t in range(seq.num_frames)]
        res = j_run_sequence(ByteTracker(ByteTrackerConfig(use_busca=False)),
                             [None] * seq.num_frames, dets, name=f"seq{i}")
        per_seq[f"seq{i}"] = j_evaluate_sequence(res, seq.ground_truth())
    return per_seq


def test_two_process_dp_matches_busca_tpu_single_process(tmp_path):
    out = tmp_path / "merged.json"
    launch(2, "metrics", dict(sequences=SEQUENCES, frames=FRAMES,
                              out=str(out)), timeout=180, backend="gloo")
    with open(out) as f:
        merged = json.load(f)
    assert merged["world_size"] == 2
    # rank 0 tracked its share only: the merge crossed processes
    assert merged["local_sequences"] == ["seq0", "seq2"]
    want = j_global_metrics(_jax_per_seq())
    got = merged["metrics"]
    for field in RATES:
        np.testing.assert_allclose(got[field], getattr(want, field),
                                   rtol=0, atol=RATE_ATOL, err_msg=field)
    for field in COUNTS:
        assert got[field] == getattr(want, field), field


def test_shard_sequences_matches_busca_tpu():
    names = [f"s{i}" for i in range(7)]
    for count in (1, 2, 3):
        for index in range(count):
            assert shard_sequences(names, index, count) == \
                j_shard_sequences(names, index, count)


@pytest.fixture
def one_rank_mesh():
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        yield make_mesh(1)
    finally:
        dist.destroy_process_group()


def test_collectives_on_one_rank_equal_local_sums(one_rank_mesh):
    per_seq = _jax_per_seq()
    local = global_metrics(per_seq)  # no group given, world of one
    reduced = global_metrics(per_seq, group=one_rank_mesh.get_group("dp"))
    assert reduced == local
    rows = np.stack([metrics_to_tally(m) for m in per_seq.values()])
    assert np.array_equal(psum_tallies(rows, one_rank_mesh), rows.sum(0))
