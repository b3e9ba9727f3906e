"""Find a configuration's models by name: one file per role and kind,
``benchmark/bmk/parts/<role>_<kind>.py``, as ``spec.metric_reader`` finds a
metric's reader.  A configuration with another detector, tracker or
extractor brings its own part files; the harness's core names no model.

The names come from the configuration file:

- ``detector``: its ``detector.kind`` (served cells);
- ``tracker``: its ``tracker.name``;
- ``extractor``: ``reid`` where it has a ``reid`` block (feature trackers).

A detector or extractor part provides ``make_weights(run) -> state`` (the
state dict both sides load, drawn from the configuration's weights seed
under a ``weights.fill_`` key of its own: 1 YOLOX, 2 BUSCA, 3 the ReID),
``build(config, state, device)`` (the program's own model), ``wrap(model,
rec)`` (its spans, its forwards and the sampled calls the check needs),
``gaps(run) -> [(name, value, limit)]`` (its numbers of the check) and
``flops(config, *shape) -> (operations, dtype)`` (one recorded forward's
operations, for ``step_mfu``); an extractor also ``watch(shim, rec)``,
which keeps the sampled frames' features.  A tracker part provides
``reference(config) -> (cls, cfg)``, ``start(cls, cfg, engine, feats)``
and ``replay(trk, inputs, feats)``: the reference tracker that
``track_frames`` drives, and its update for one frame.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Optional

from bmk.spec import load_file

PARTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "parts")
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(PARTS)))

# the roles whose models have weights, in the order they are drawn
WEIGHTED = ("detector", "extractor")


def named(config: dict) -> Dict[str, str]:
    """``role -> kind`` of every part the configuration names."""
    out = {}
    if "detector" in config:
        out["detector"] = config["detector"]["kind"]
    out["tracker"] = config["tracker"]["name"]
    if "reid" in config:
        out["extractor"] = "reid"
    return out


def path(role: str, kind: str) -> str:
    return os.path.join(PARTS, f"{role}_{kind}.py")


def _existing(role: str, kind: str) -> str:
    p = path(role, kind)
    if not os.path.exists(p):
        raise FileNotFoundError(f"no {role} part {kind!r}: "
                                f"{os.path.relpath(p, CHECKOUT)} not found")
    return p


def require(config: dict):
    """Raise ``FileNotFoundError`` naming the file of the first part the
    configuration names that the checkout does not have."""
    for role, kind in named(config).items():
        _existing(role, kind)


@functools.lru_cache(maxsize=None)
def part(role: str, kind: str):
    """The module of ``benchmark/bmk/parts/<role>_<kind>.py``, loaded once."""
    return load_file(_existing(role, kind), "bench_part_", f"{role}_{kind}")


def of(config: dict, role: str) -> Optional[object]:
    """The configuration's part of ``role``, or None where it has none."""
    kind = named(config).get(role)
    return None if kind is None else part(role, kind)
