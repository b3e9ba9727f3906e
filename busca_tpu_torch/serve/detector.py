"""Frame-loop detectors backed by exported programs (port of
``busca_tpu.serve.detector``).

The serving half of the TRT role: the reference converts the detector once
with torch2trt and the eval loop loads the engine file instead of building
the torch model (adapters/ByteTrack/tools/track.py:83,215-224).  Here the
eval loop and the server (``--detector-artifact``) load a
``serve/export.py`` directory and run its program: no model is built and no
weights are converted at serve time.

:class:`ArtifactDetector` has :class:`~busca_tpu_torch.eval.detector.
YoloxDetector`'s frame-loop API (``put_frame`` / ``detect_async`` /
``wait`` / ``detect``) with the same pinned upload, result copies and NMS
fallback (``PipelinedFrameIO``); :class:`ArtifactBatchDetector` has its
lockstep API (``detect_batch``, and ``detect_batch_async`` /
``wait_batch`` for the pipelined lockstep loop), padding each batch to an
exported bucket.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from busca_tpu_torch.eval.detector import (
    PipelinedFrameIO,
    _Pending,
    _Upload,
)


class _ArtifactIO(PipelinedFrameIO):
    """The manifest's step parameters and the device of a detector
    artifact."""

    def _setup(self, manifest: dict, variables, device, what: str):
        from busca_tpu_torch.utils.device import resolve_device

        if not manifest.get("bake_weights", True) and variables is None:
            raise ValueError(
                f"{what} was exported without baked weights; pass the "
                f"model's state dict as `variables`")
        self.manifest = manifest
        self.device = resolve_device(device)
        # a plain dict: the program's input spec is one
        self._variables = None if variables is None else dict(variables)
        self.frame_hw = tuple(manifest["frame_hw"])
        self.scale = float(manifest["scale"])
        self.test_size = tuple(manifest["test_size"])
        self.conf_thresh = float(manifest.get("conf_thresh", 0.0))
        self.nms_thresh = float(manifest["nms_thresh"])
        self.max_outputs = int(manifest["max_outputs"])
        self.pre_nms_topk = int(manifest["pre_nms_topk"])
        self.num_classes = int(manifest["num_classes"])
        self.nms_fallbacks = 0
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    def _check_hw(self, hw):
        hw = (int(hw[0]), int(hw[1]))
        if hw != self.frame_hw:
            raise ValueError(
                f"artifact compiled for frame_hw={self.frame_hw}, got {hw}")

    def _run(self, step, frames: torch.Tensor):
        if self._variables is None:
            return step.call(frames)
        return step.call(self._variables, frames)


class ArtifactDetector(_ArtifactIO):
    """Runs an exported ``yolox_detector_step`` program per frame.

    The program is traced for ONE frame geometry (``manifest.frame_hw``);
    frames of any other size are a hard error (the TRT engine file has the
    same contract).  ``variables``: the model's state dict on ``device``,
    for a program exported without baked weights.  ``device`` must be the
    one the program was exported on."""

    def __init__(self, artifact_or_dir, variables: Optional[dict] = None,
                 device="cuda"):
        from busca_tpu_torch.serve.export import (
            ExportedArtifact,
            _check_device,
            load_artifact,
        )

        if isinstance(artifact_or_dir, ExportedArtifact):
            art = artifact_or_dir
            _check_device(art.manifest, device)
        else:
            art = load_artifact(str(artifact_or_dir), device=device)
        if art.manifest.get("kind") != "yolox_detector_step":
            raise ValueError(
                f"not a detector artifact: kind={art.manifest.get('kind')!r}")
        self._art = art
        self._setup(art.manifest, variables, device, "artifact")

    def detect_async(self, frame) -> _Pending:
        """Enqueue the program for one frame (a :meth:`put_frame` upload, a
        host array or a tensor on the device) and the copies of its rows
        into pinned buffers; returns a handle for :meth:`wait`."""
        frame, stream = self._readable(frame)
        self._check_hw(frame.tensor.shape)
        rows, valid, converged, canvas, pred = self._run(self._art,
                                                         frame.tensor)
        host, done = self._copy_out(stream, (rows, valid, converged))
        return _Pending(*host, done, canvas, self.scale, pred,
                        (frame, rows, valid, converged))


class ArtifactBatchDetector(_ArtifactIO):
    """Runs an exported ``yolox_detector_batch_steps`` family.

    Each batch is padded with its last frame up to the nearest exported
    bucket, and the pad lanes' outputs are dropped; a batch beyond the
    largest bucket is a hard error (export a bigger family)."""

    def __init__(self, artifact_dir: str, variables: Optional[dict] = None,
                 device="cuda"):
        from busca_tpu_torch.serve.export import load_batch_artifacts

        manifest, steps = load_batch_artifacts(str(artifact_dir),
                                               device=device)
        self._steps = steps
        self.batches = sorted(steps)
        self._setup(manifest, variables, device, "artifact family")

    def _bucket(self, n: int) -> int:
        for b in self.batches:
            if n <= b:
                return b
        raise ValueError(
            f"batch {n} exceeds the largest exported bucket "
            f"{self.batches[-1]}: re-export with a bigger family")

    def detect_batch_async(self, frames_bgr) -> _Pending:
        """Enqueue the bucket's program for one frame of each of B
        same-resolution sequences (a ``[B, H, W, 3]`` array or sequence of
        frames, a :meth:`put_frame` upload of one, or a device tensor);
        returns a handle for :meth:`wait_batch` holding the B real lanes."""
        frames, stream = self._readable(frames_bgr)
        x = frames.tensor
        n = int(x.shape[0])
        self._check_hw(x.shape[1:3])
        bp = self._bucket(n)
        if bp > n:  # repeat the last frame; the pad lanes are dropped
            x = torch.cat([x, x[-1:].expand(bp - n, *x.shape[1:])])
        rows, valid, converged, canvases, preds = self._run(self._steps[bp],
                                                            x)
        rows, valid, converged = rows[:n], valid[:n], converged[:n]
        host, done = self._copy_out(stream, (rows, valid, converged))
        return _Pending(*host, done, canvases[:n], self.scale, preds[:n],
                        (frames, x, rows, valid, converged))

    def detect_batch(self, frames_bgr) -> list:
        """One frame of each of B same-resolution sequences; one
        :class:`~busca_tpu_torch.eval.detector.DetectorOutput` per
        frame."""
        return self.wait_batch(self.detect_batch_async(frames_bgr))

    def detect(self, frame):
        """One frame (a host array, a device tensor or a
        :meth:`put_frame` upload) through the bucket-1 program."""
        if isinstance(frame, _Upload):
            frame = _Upload(frame.tensor[None], frame.ready, frame.pinned)
        elif torch.is_tensor(frame):
            frame = frame[None]
        else:
            frame = np.asarray(frame)[None]
        return self.detect_batch(frame)[0]
