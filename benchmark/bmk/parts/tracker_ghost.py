"""GHOST (``tracker.name`` "ghost"): the reference tracker that
``track_frames`` drives beside the program's, fed the program's features
in the order it computed them."""

from __future__ import annotations

import numpy as np


def reference(config: dict):
    """The reference tracker's class and configuration."""
    from benchref import ghost
    from bmk.check import reference_config

    return ghost.GhostTracker, reference_config(config, ghost,
                                                ghost.GhostConfig)


def start(cls, cfg, engine, feats):
    return cls(cfg, engine, feats)


def replay(trk, inputs, feats):
    """One frame's update on the program's inputs and detection
    features."""
    boxes, scores, _scale, frame = inputs
    det_feats = feats(boxes) if len(boxes) else np.eye(1, 16)[:0]
    return trk.update(boxes, scores, det_feats, frame)
