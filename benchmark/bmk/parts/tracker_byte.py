"""BYTE (``tracker.name`` "byte"): the reference tracker that
``track_frames`` drives beside the program's."""

from __future__ import annotations


def reference(config: dict):
    """The reference tracker's class and configuration."""
    from benchref import byte
    from bmk.check import reference_config

    return byte.ByteTracker, reference_config(config, byte,
                                              byte.ByteTrackerConfig)


def start(cls, cfg, engine, feats):
    return cls(cfg, engine)


def replay(trk, inputs, feats):
    """One frame's update on the program's inputs."""
    boxes, scores, scale, frame = inputs
    return trk.update(boxes, scores, scale, frame)
