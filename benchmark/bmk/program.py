"""The system under test, built from a configuration file and the
benchmark's weights: the program's own classes and entry points
(``busca_tpu_torch``), nothing re-implemented.  A configuration's detector
and extractor are built by their parts (``bmk/parts``)."""

from __future__ import annotations

import dataclasses

from bmk.weights import BUSCA_KEYS


def set_precision():
    """The program's card precision (TF32 off, bf16 products reduced in
    float32), as its entry points set it."""
    from busca_tpu_torch.utils.device import set_card_precision

    set_card_precision()


def engine(config: dict, state: dict, device):
    """The program's association engine (``eval/run.py::build_engine``),
    holding the benchmark's weights; its BUSCA config must be the one the
    configuration states."""
    from busca_tpu_torch.eval.run import build_engine

    b = config["busca"]
    eng, _ = build_engine(None, None, device=device,
                          crop_hw=tuple(b["crop_hw"]), dtype=b["dtype"],
                          reid_stats=b["reid_stats"])
    got = dataclasses.asdict(eng.config)
    for k in BUSCA_KEYS:
        want = tuple(b[k]) if isinstance(b[k], list) else b[k]
        have = tuple(got[k]) if isinstance(got[k], (list, tuple)) else got[k]
        if have != want:
            raise ValueError(f"the program's BUSCA {k} is {have!r}, the "
                             f"configuration states {want!r}")
    eng.model.load_state_dict(state)
    return eng


def tracker_factory(config: dict, eng, feats=None):
    """A fresh tracker per stream, as the program's CLIs compose it
    (``make_tracker`` and ``shim_for_runner``)."""
    from busca_tpu_torch.eval.run import make_tracker, shim_for_runner

    t = config["tracker"]
    crop_hw = tuple(config["busca"]["crop_hw"])

    def factory():
        trk = make_tracker(t["name"], dict(t["kwargs"]), eng, crop_hw, feats)
        return shim_for_runner(t["name"], trk, feats, crop_hw)

    return factory


def server(config: dict, mix: dict, det, factory):
    f = config["output_filter"]
    if mix["driver"] == "lockstep_server":
        from busca_tpu_torch.serve.lockstep import LockstepTrackingServer

        return LockstepTrackingServer(
            det, factory, tick_timeout=float(mix["tick_timeout_s"]),
            min_box_area=float(f["min_box_area"]),
            vertical_thresh=f["vertical_thresh"])
    from busca_tpu_torch.serve.server import TrackingServer

    return TrackingServer(det, factory, min_box_area=float(f["min_box_area"]),
                          vertical_thresh=f["vertical_thresh"])
