"""Breaks of the timed path that the check must catch (``run.py --fault``,
driven by ``benchmark/tests/test_bench_faults.py``), and the precision
control (``run.py --control``).

Faults, each planted in the program underneath the harness:

- ``state_unchanged``: a tracker update that returns its previous output
  and leaves its state as it was;
- ``half_batch``: the association model's BN statistics over the first
  half of the batch only (the second half's rows masked out);
- ``altered_answer``: one replied track moved by a pixel where the output
  is produced;
- ``crossed_requests``: a grouped third round (one model call over a
  lockstep tick's requests) answers its first request with the second's
  rows and the second with the first's, as far as both have tracks;
- ``wrong_memory``: a third round scored on the wrong memory: a track's
  latest crops and boxes where the configuration samples its whole memory
  at an even stride (``use_broader_memory``).

There is no exchange between chips to leave out: every cell runs on one.
"""

from __future__ import annotations

import torch

FAULTS = ("state_unchanged", "half_batch", "altered_answer",
          "crossed_requests", "wrong_memory")


def install(name: str):
    if name == "state_unchanged":
        from busca_tpu_torch.eval import run as cli

        make = cli.make_tracker

        def make_tracker(*a, **kw):
            trk = make(*a, **kw)
            _freeze(type(trk))
            return trk

        cli.make_tracker = make_tracker
    elif name == "half_batch":
        from busca_tpu_torch.assoc.engine import AssociationEngine

        orig = AssociationEngine._probs

        def _probs(self, mem_crops, can_crops, mem_boxes, can_boxes, mask,
                   *a, **kw):
            mask = mask.copy()
            live = mask.nonzero()[0]
            mask[live[(len(live) + 1) // 2:]] = 0.0
            return orig(self, mem_crops, can_crops, mem_boxes, can_boxes,
                        mask, *a, **kw)

        AssociationEngine._probs = _probs
    elif name == "altered_answer":
        from busca_tpu_torch.eval import runner

        orig_filter = runner.filter_output_tracks

        def filter_output_tracks(online, *a, **kw):
            tlwhs, ids, confs = orig_filter(online, *a, **kw)
            if tlwhs:
                tlwhs = [tlwhs[0] + [1.0, 0.0, 0.0, 0.0]] + list(tlwhs[1:])
            return tlwhs, ids, confs

        runner.filter_output_tracks = filter_output_tracks
    elif name == "crossed_requests":
        from busca_tpu_torch.assoc.engine import AssociationEngine

        orig_grouped = AssociationEngine._score_grouped

        def _score_grouped(self, preps, normalize_ims):
            probs, spans = orig_grouped(self, preps, normalize_ims)
            if len(spans) > 1:
                (_, ra, ta, *_), (_, rb, tb, *_) = spans[:2]
                n = min(ta, tb)
                probs = probs.copy()
                probs[ra:ra + n], probs[rb:rb + n] = (
                    probs[rb:rb + n].copy(), probs[ra:ra + n].copy())
            return probs, spans

        AssociationEngine._score_grouped = _score_grouped
    elif name == "wrong_memory":
        from busca_tpu_torch.assoc import engine

        orig_mem = engine._get_track_mem

        def _get_track_mem(track, seq_len, use_broader_memory):
            return orig_mem(track, seq_len, False)

        engine._get_track_mem = _get_track_mem
    else:
        raise ValueError(f"unknown fault {name!r}: one of {FAULTS}")


def _freeze(cls):
    """After its first frame, ``cls``'s update returns that frame's output
    and changes nothing (whichever tracker class the cell builds)."""
    if getattr(cls, "_fault_frozen", False):
        return
    cls._fault_frozen = True
    orig_gen = cls._update_gen

    def _update_gen(self, *args):
        if hasattr(self, "_fault_out"):
            return self._fault_out
        out = yield from orig_gen(self, *args)
        self._fault_out = out
        return out

    cls._update_gen = _update_gen


def control(run, eng):
    """The precision control in the program's place: TF32 for the float32
    products (the YOLOX detector, the ReID extractor) and, for BUSCA's bf16
    model, the reference model with its bf16 product operands rounded
    through float8 (e4m3)."""
    from bmk import weights

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    model = weights.busca_model(run.config["busca"], 0, run.device)
    model.load_state_dict(run.states["busca"])
    eng.model = Fp8Operands(model)


class Fp8Operands(torch.nn.Module):
    """A model whose bf16 products take float8-rounded operands.  The
    program's engine may hand it folded memory (``mem_gather``: each
    slot's unit) and more or fewer candidate crops than candidate rows
    (rows past the crops weigh 0, crops past the rows are padding no row
    reads); the reference model takes the unfolded batch, with as many
    candidate crops as rows."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, mem_crops, can_crops, *args, mem_gather=None, **kw):
        from benchref.precision import round_operands

        if mem_gather is not None:
            units = mem_crops.reshape((-1,) + mem_crops.shape[-3:])
            mem_crops = units[mem_gather.long().reshape(-1)].reshape(
                tuple(mem_gather.shape) + units.shape[1:])
            rows = kw["can_weights"].shape[0]
            can_crops = can_crops[:rows]
            if can_crops.shape[0] < rows:
                can_crops = torch.cat([can_crops, can_crops.new_zeros(
                    (rows - can_crops.shape[0],) + can_crops.shape[1:])])
        with round_operands(torch.float8_e4m3fn):
            return self.inner(mem_crops, can_crops, *args, **kw)
