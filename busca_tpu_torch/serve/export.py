"""Ahead-of-time export of the port's steps as ``torch.export`` programs
(port of ``busca_tpu.serve.export``).

The reference ships an optional TensorRT deployment path: the YOLOX detector
is converted once with torch2trt and the engine file is loaded at eval time
(`adapters/ByteTrack/tools/track.py:83,215-224`, `Dockerfile:88-95`).
busca_tpu lowers its jitted steps to StableHLO with ``jax.export``; the port
traces them with ``torch.export.export`` and writes the program with
``torch.export.save``.  A serving process then :func:`load_artifact`\\ s the
directory and calls the step without building the model: no module
construction, no config parsing, no weight conversion.

Layout of an artifact directory::

    <dir>/fn.pt2         the saved ExportedProgram
    <dir>/manifest.json  {"kind", "frame_hw", "test_size", ..., "device"}

Batch-step families (:func:`export_detector_batch_steps`) write one
``fn_b{N}.pt2`` per batch bucket instead, under one manifest.

The detector step's letterbox goes through the crop op as one registered
operator (``torch.ops.busca_tpu_torch.crop_resize``, ``ops/crop.py``), so
the program holds it as a node and launches kernel K1 on the card, as the
live step does; the float32 YOLOX's convolutions stay
``aten._convolution`` with cuDNN off (``models/precision.py::
gemm_conv2d``).  The program runs its aten ops eagerly: its rows equal the
live step's bit for bit (tests/test_torch_export.py, ``chip_smoke.py``
phase 13).

A program is pinned to the device it was traced on: its constants, its
factory calls and its convolution path are that device's.  The manifest
records the device, and the loaders refuse another one by name (busca_tpu
lowers for several platforms at once; the port re-exports on the target).
AOTInductor packaging is not used: a compiled package cannot call K1's
ctypes launch without a C++ registration of the op.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import torch

_FN_FILE = "fn.pt2"
_MANIFEST_FILE = "manifest.json"


def _check_device(manifest: dict, device) -> None:
    """Refuse a program traced on another device than ``device``."""
    if device is None:
        return
    want, have = torch.device(device).type, manifest.get("device")
    if have != want:
        raise ValueError(
            f"artifact was exported on {have!r} and cannot run on "
            f"{want!r}: a torch.export program keeps the device it was "
            f"traced on (its constants and convolution path); re-export "
            f"it on {want!r}")


def _write_manifest(out_dir: str, manifest: dict) -> dict:
    manifest = dict(manifest, torch_version=torch.__version__)
    with open(os.path.join(out_dir, _MANIFEST_FILE), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def _save(program, path: str) -> int:
    # the example inputs would be saved too: an unbaked program's are the
    # weights it exists to leave out
    program.example_inputs = None
    torch.export.save(program, path)
    return os.path.getsize(path)


class _Unbaked(torch.nn.Module):
    """A step whose weights are call-time arguments: ``forward(state,
    *args)`` runs ``step`` with its ``model``'s parameters and buffers
    replaced by ``state`` (the model's ``state_dict()`` keys), so the
    exported program holds no weights."""

    def __init__(self, step: torch.nn.Module):
        super().__init__()
        self._step = [step]  # not a submodule: its weights are not lifted

    def forward(self, state, *args):
        step = self._step[0]
        params = {"model." + k: v for k, v in state.items()}
        return torch.func.functional_call(step, params, args)


class _DetectorStep(torch.nn.Module):
    """A :class:`~busca_tpu_torch.eval.detector.YoloxDetector`'s device
    step as a module: a uint8 BGR frame ``[fh, fw, 3]`` (``[B, fh, fw, 3]``
    with ``batch``) -> ``(rows, valid, converged, canvas, pred)``: the
    letterbox through the crop op, the forward, ``yolox_postprocess``'s
    fixed-step rows, the canvas, and the decoded rows a frame whose NMS did
    not converge is finished from (``YoloxDetector.prep`` + ``step``, or
    ``batch_step``)."""

    def __init__(self, detector, batch: bool):
        super().__init__()
        self.model = detector.model
        self._detector = [detector]
        self.batch = batch

    def forward(self, frames):
        det = self._detector[0]
        if self.batch:
            rows, valid, converged, preds, canvases, _ = det.batch_step(
                frames)
            return rows, valid, converged, canvases, preds
        canvas, _ = det.prep(frames)
        rows, valid, converged, pred = det.step(canvas)
        return rows, valid, converged, canvas, pred


def _trace(module, args, detector=None):
    """``torch.export.export`` of ``module`` at ``args`` under no_grad.
    The detector's per-size caches (the letterbox's full-frame box, the
    decode's cell grids) are set aside while it traces, so no traced
    tensor lands in them and the program builds its own."""
    saved = None
    if detector is not None:
        saved = detector._boxes, detector.model._grids
        detector._boxes, detector.model._grids = {}, None
    try:
        with torch.no_grad():
            return torch.export.export(module, tuple(args))
    finally:
        if saved is not None:
            detector._boxes, detector.model._grids = saved


def _detector_manifest(detector, kind: str, key, scale: float,
                       bake_weights: bool) -> dict:
    return {
        "kind": kind,
        "frame_hw": list(key),
        "test_size": list(detector.test_size),
        "scale": scale,
        "conf_thresh": detector.conf_thresh,
        "nms_thresh": detector.nms_thresh,
        "max_outputs": detector.max_outputs,
        "pre_nms_topk": detector.pre_nms_topk,
        "num_classes": detector.num_classes,
        "bake_weights": bool(bake_weights),
        "device": detector.device.type,
    }


def _example_frames(detector, key, batch: Optional[int]):
    shape = (key[0], key[1], 3) if batch is None else (batch, key[0],
                                                        key[1], 3)
    return torch.zeros(shape, dtype=torch.uint8, device=detector.device)


def _detector_program(detector, key, batch: Optional[int],
                      bake_weights: bool):
    step = _DetectorStep(detector, batch is not None).eval()
    frames = _example_frames(detector, key, batch)
    if bake_weights:
        return _trace(step, [frames], detector)
    state = dict(detector.model.state_dict())
    return _trace(_Unbaked(step), [state, frames], detector)


def _scale(detector, key) -> float:
    th, tw = detector.test_size
    return min(th / key[0], tw / key[1])


def export_detector_step(detector, frame_hw: Tuple[int, int], out_dir: str,
                         *, bake_weights: bool = True) -> dict:
    """Export a :class:`~busca_tpu_torch.eval.detector.YoloxDetector` frame
    step for frames of ``frame_hw`` on the detector's device.

    The program maps a ``[fh, fw, 3]`` uint8 BGR frame to ``(rows [K, 7],
    valid [K], converged, canvas [th, tw, 3] uint8, pred)``: the live
    step's (tools/track.py:215-224 is the torch2trt analogue).  With
    ``bake_weights`` (default) the weights are saved in the program;
    otherwise it takes ``(state, frame)``, ``state`` being the model's
    ``state_dict()``.  Returns the written manifest."""
    key = (int(frame_hw[0]), int(frame_hw[1]))
    os.makedirs(out_dir, exist_ok=True)
    program = _detector_program(detector, key, None, bake_weights)
    size = _save(program, os.path.join(out_dir, _FN_FILE))
    manifest = _detector_manifest(detector, "yolox_detector_step", key,
                                  _scale(detector, key), bake_weights)
    manifest["size_bytes"] = size
    return _write_manifest(out_dir, manifest)


def export_detector_batch_steps(detector, frame_hw: Tuple[int, int],
                                batches: Sequence[int], out_dir: str, *,
                                bake_weights: bool = True) -> dict:
    """Export the detector's lockstep batch step at several batch sizes:
    one ``fn_b{N}.pt2`` per bucket under one manifest, the artifact family
    :class:`~busca_tpu_torch.serve.detector.ArtifactBatchDetector` pads
    each batch into.  With ``bake_weights`` every program holds its own
    copy of the weights; without, the family holds none and the loader
    takes them once."""
    key = (int(frame_hw[0]), int(frame_hw[1]))
    os.makedirs(out_dir, exist_ok=True)
    sizes = {}
    for b in sorted(set(int(b) for b in batches)):
        program = _detector_program(detector, key, b, bake_weights)
        sizes[str(b)] = _save(program, os.path.join(out_dir, f"fn_b{b}.pt2"))
    manifest = _detector_manifest(detector, "yolox_detector_batch_steps",
                                  key, _scale(detector, key), bake_weights)
    manifest["batches"] = sorted(int(b) for b in sizes)
    manifest["size_bytes"] = sizes
    return _write_manifest(out_dir, manifest)


class ExportedArtifact:
    """A loaded artifact: ``call(*args)`` runs the program's module (an
    unbaked program takes the state dict first)."""

    def __init__(self, program, manifest: dict):
        self.program = program
        self.manifest = manifest
        self._module = program.module()

    def call(self, *args):
        with torch.no_grad():
            return self._module(*args)

    __call__ = call


def _read_manifest(out_dir: str) -> dict:
    with open(os.path.join(out_dir, _MANIFEST_FILE)) as f:
        return json.load(f)


def artifact_kind(out_dir: str) -> Optional[str]:
    """The ``kind`` in an artifact directory's manifest, read without
    loading the program."""
    return _read_manifest(out_dir).get("kind")


def _load_program(path: str):
    # the crop op must be registered before a program that calls it loads
    import busca_tpu_torch.ops.crop  # noqa: F401

    return torch.export.load(path)


def load_artifact(out_dir: str, device=None) -> ExportedArtifact:
    """Load an artifact directory written by :func:`export_detector_step`
    or :func:`export_associate_scorer`; ``device``, when given, must be the
    device it was exported on."""
    manifest = _read_manifest(out_dir)
    _check_device(manifest, device)
    return ExportedArtifact(_load_program(os.path.join(out_dir, _FN_FILE)),
                            manifest)


def load_batch_artifacts(out_dir: str, device=None):
    """Load a batch-steps artifact directory -> ``(manifest, {batch:
    ExportedArtifact})``."""
    manifest = _read_manifest(out_dir)
    if manifest.get("kind") != "yolox_detector_batch_steps":
        raise ValueError(
            f"not a batch-steps artifact: kind={manifest.get('kind')!r}")
    _check_device(manifest, device)
    steps = {}
    for b in manifest["batches"]:
        program = _load_program(os.path.join(out_dir, f"fn_b{b}.pt2"))
        steps[int(b)] = ExportedArtifact(program, manifest)
    return manifest, steps


# --------------------------------------------------------------- associate --
class _Scorer(torch.nn.Module):
    """The association engine's dedup scoring call
    (``AssociationEngine._scores``) as a module."""

    def __init__(self, engine, normalize_ims: bool):
        super().__init__()
        self.model = engine.model
        self._engine = [engine]
        self.normalize_ims = normalize_ims

    def forward(self, mem_crops, uniq_can_crops, can_weights, can_gather,
                mem_boxes, can_boxes, mask):
        return self._engine[0]._scores(
            mem_crops, uniq_can_crops, mem_boxes, can_boxes, mask,
            self.normalize_ims, can_weights=can_weights,
            can_gather=can_gather)


def export_associate_scorer(engine, bucket: int, u_pad: int, out_dir: str,
                            *, bake_weights: bool = True,
                            normalize_ims: bool = True) -> dict:
    """Export the engine's dedup scorer at one ``(bucket, u_pad)`` shape:
    the model call of ``assoc/engine.py::_score_bucketed_unique`` (the
    reference's hot loop is busca/network.py:176-244).  Memory crops
    ``[B, L, H, W, 3]`` uint8, ``[u_pad]`` unique candidate crops with
    their occurrence weights and a ``[B, C]`` int32 gather map, the boxes
    and the lane mask -> ``[B, num_choices]`` softmax probabilities.  A
    standalone scoring artifact: the servers run the live engine, whose
    grouped and banked calls hold state (the crop bank) that a program does
    not."""
    h, w = engine.crop_hw
    b, seq_len, c = int(bucket), engine.seq_len, engine.num_candidates
    dev = engine.device
    u8, f32 = torch.uint8, torch.float32
    args = [
        torch.zeros((b, seq_len, h, w, 3), dtype=u8, device=dev),  # mem
        torch.zeros((u_pad, h, w, 3), dtype=u8, device=dev),  # uniq can
        torch.zeros((u_pad,), dtype=f32, device=dev),  # can_weights
        torch.zeros((b, c), dtype=torch.int32, device=dev),  # can_gather
        torch.zeros((b, seq_len, 4), dtype=f32, device=dev),  # mem_boxes
        torch.zeros((b, c, 4), dtype=f32, device=dev),  # can_boxes
        torch.zeros((b,), dtype=f32, device=dev),  # mask
    ]
    scorer = _Scorer(engine, normalize_ims).eval()
    if bake_weights:
        program = _trace(scorer, args)
    else:
        program = _trace(_Unbaked(scorer),
                         [dict(engine.model.state_dict())] + args)
    os.makedirs(out_dir, exist_ok=True)
    size = _save(program, os.path.join(out_dir, _FN_FILE))
    return _write_manifest(out_dir, {
        "kind": "associate_score_unique",
        "bucket": b,
        "u_pad": int(u_pad),
        "seq_len": seq_len,
        "num_candidates": c,
        "crop_hw": [h, w],
        "normalize_ims": bool(normalize_ims),
        "bake_weights": bool(bake_weights),
        "device": torch.device(dev).type,
        "size_bytes": size,
    })


# --------------------------------------------------------------------- CLI --
def main(argv: Optional[Sequence[str]] = None):
    """``python -m busca_tpu_torch.serve.export``: export a YOLOX detector
    step (or a lockstep batch family) on the card (``--device cpu`` for a
    CPU artifact), the reference's one-time TRT conversion
    (tools/track.py:215-224)."""
    import argparse

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--out", required=True, help="artifact directory")
    p.add_argument("--size", default="x", help="YOLOX size (tiny/s/m/l/x)")
    p.add_argument("--ckpt", default=None,
                   help="official YOLOX .pth or busca_tpu .npz; default: "
                        "random weights from --seed")
    p.add_argument("--frame-hw", type=int, nargs=2, default=(1080, 1920))
    p.add_argument("--test-size", type=int, nargs=2, default=(800, 1440))
    p.add_argument("--det-conf", type=float, default=0.1,
                   help="exp.test_conf baked into the step")
    p.add_argument("--det-nms", type=float, default=0.7,
                   help="exp.nmsthre baked into the step")
    p.add_argument("--no-bake-weights", action="store_true")
    p.add_argument(
        "--batches", type=int, nargs="*", default=None,
        help="export a lockstep batch-step family at these batch sizes "
             "(e.g. --batches 1 2 4 8) instead of the single-frame step")
    p.add_argument("--device", default="cuda",
                   help="the device the program is traced on and runs on: "
                        "cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from busca_tpu_torch.eval.detector import YoloxDetector
    from busca_tpu_torch.utils.device import set_card_precision

    set_card_precision()
    det = YoloxDetector.build(
        size=args.size, ckpt_path=args.ckpt,
        test_size=tuple(args.test_size), conf_thresh=args.det_conf,
        nms_thresh=args.det_nms, device=args.device, seed=args.seed)
    if args.batches:
        m = export_detector_batch_steps(
            det, tuple(args.frame_hw), args.batches, args.out,
            bake_weights=not args.no_bake_weights)
    else:
        m = export_detector_step(det, tuple(args.frame_hw), args.out,
                                 bake_weights=not args.no_bake_weights)
    print(json.dumps(m))
    return m


if __name__ == "__main__":
    main()
