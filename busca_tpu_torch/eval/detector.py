"""Live detector-in-the-loop evaluation: frame -> detector -> NMS -> tracker
(port of ``busca_tpu.eval.detector``: YOLOX, TransCenter and CenterTrack).

Per frame:

1. preproc: aspect-preserving letterbox resize through the crop op (kernel
   K1 on the card) onto a canvas of the test size, filled with 114 for
   YOLOX and 0 for TransCenter and CenterTrack; ImageNet normalization
   after BGR -> RGB (YOLOX, TransCenter), CenterNet's BGR statistics
   (CenterTrack);
2. the detector forward: YOLOX (CSPDarknet + PAFPN + decoupled head, grid
   decode), TransCenter over the current and the previous canvas with the
   tracker's positions as a prior heatmap (kernel K2 in every decoder
   attention on the card), or CenterTrack (DLA-34 with DCNv2 upsampling)
   over the current and the previous canvas and a prior heatmap rendered
   from the tracker's dict tracks;
3. score filter and static-size NMS on the device (CenterTrack: the peak
   decode and a score filter, no NMS, as the reference);
4. the uint8 BGR canvas handed to the tracker for BUSCA crops (the
   reference's ``bboxes /= scale`` + crops at ``bboxes * scale`` scheme).

:class:`YoloxDetector` splits a frame into ``put_frame`` (a pinned host copy
and an upload on a copy stream), ``detect_async`` (the step, enqueued
without any host sync, and non-blocking copies of its fixed-size result
rows into pinned buffers) and ``wait``, so that
:func:`track_frames_with_detector` enqueues frame t+1 before it waits for
frame t.  Its canvas stays on the card for the tracker's crops, as
CenterTrack's does.  TransCenter and CenterTrack feed the tracker's state
back and cannot pipeline.

:class:`CenterTrackRunnerDetector` is CenterTrack's view for the tracking
server (``serve/server.py``).  The stateful detectors' ``state_dict`` /
``load_state_dict`` carry the previous canvas through a snapshot.

Lockstep evaluation across sequences: :meth:`YoloxDetector.
detect_batch_async` runs one batch-B step for one frame of each of B
same-resolution sequences (one pinned upload, K1 letterboxes each frame
into its slice of one canvas batch, one forward, the postprocess per
frame), and :func:`track_sequences_lockstep` drives B trackers with it,
their BUSCA third rounds served by one grouped association per frame.
:meth:`YoloxDetector.shard_lockstep` splits that batch over several
devices of the process (busca_tpu's dp-sharded lockstep): a replica of the
detector on each, each letterboxing and detecting its own frames, the
outputs gathered at fetch.

``viz_dir`` in the loops writes each frame with its tracks as a JPEG
(``eval/runner.py::write_viz_frame``), busca_tpu's online visualization.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from busca_tpu_torch.utils import profiling

# ImageNet RGB statistics (the ValTransform defaults the reference evaluates
# with, exps/transcenterdetr_base.py:327-333)
IMAGENET_MEAN_RGB = (0.485, 0.456, 0.406)
IMAGENET_STD_RGB = (0.229, 0.224, 0.225)
# x / 255 as XLA evaluates a division by a constant: times the float32
# reciprocal (busca_tpu's detector step rounds this way)
INV_255 = float(np.float32(1.0) / np.float32(255.0))
# IoU threshold of the detections' NMS (the YOLOX postprocess default the
# reference pipes TransCenter's output through, mot_evaluator.py:160)
NMS_IOU = 0.7
# YOLOX's letterbox fill (the reference preproc, exps/*.py ``preproc``)
PAD_VALUE = 114
# CenterNet/CenterTrack input statistics, in BGR channel order as the
# published code applies them (no channel flip after cv2.imread)
CENTERNET_MEAN_BGR = (0.408, 0.447, 0.470)
CENTERNET_STD_BGR = (0.289, 0.274, 0.278)


@dataclasses.dataclass
class DetectorOutput:
    """One frame's detections, in detector (resized) coordinates.

    ``image`` is the uint8 BGR canvas: :class:`YoloxDetector` leaves it on
    its device (a tensor), where the tracker's BUSCA crops read it, as
    busca_tpu leaves a device array; :class:`TransCenterDetector` returns a
    host copy (numpy)."""

    boxes_tlbr: np.ndarray  # [N, 4] detector coords
    scores: np.ndarray  # [N]
    image: object  # [test_h, test_w, 3] uint8 BGR canvas
    scale: float  # detector coords = original coords * scale


def rows_to_detector_output(out, valid, image, scale) -> DetectorOutput:
    """Postprocessed rows ``[K, 7]`` and their ``valid`` mask (host arrays)
    -> :class:`DetectorOutput`: columns 0-3 are the tlbr boxes, the tracker's
    score is obj_conf * cls_conf (byte_tracker.py:230-234)."""
    rows = np.asarray(out)[np.asarray(valid)]
    return DetectorOutput(
        boxes_tlbr=rows[:, :4].astype(np.float64),
        scores=(rows[:, 4] * rows[:, 5]).astype(np.float64),
        image=image,
        scale=scale,
    )


def letterbox(frame: torch.Tensor, test_size: Tuple[int, int], fill: int,
              boxes: dict, out: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, float]:
    """uint8 BGR frame ``[H, W, 3]`` -> the uint8 BGR canvas ``[test_h,
    test_w, 3]`` (the frame resized by ``r = min(test_h / H, test_w / W)``
    through the crop op, INTER_LINEAR and rounded, at the top left; ``fill``
    elsewhere) and ``r``.  ``boxes`` caches the full-frame box per frame
    size and device; it is made with device ops, so no call copies from the
    host.  ``out``, a uint8 ``[test_h, test_w, 3]`` view filled with
    ``fill`` (one slice of a canvas batch), receives the resized frame
    instead of a new canvas."""
    fh, fw = int(frame.shape[0]), int(frame.shape[1])
    th, tw = test_size
    r = min(th / fh, tw / fw)
    rh, rw = int(fh * r), int(fw * r)
    key = (fh, fw, str(frame.device))
    if key not in boxes:
        box = torch.zeros((1, 4), dtype=torch.float32, device=frame.device)
        box[0, 2] = float(fw)
        box[0, 3] = float(fh)
        boxes[key] = box
    from busca_tpu_torch.ops.crop import crop_resize_normalize

    resized = crop_resize_normalize(
        frame, boxes[key], out_hw=(rh, rw), normalize=False, bgr_input=True,
        rgb_output=False, quantize_uint8=True,
    )[0]
    canvas = out if out is not None else torch.full(
        (th, tw, 3), fill, dtype=torch.uint8, device=frame.device)
    # the quantized crop holds integers in 0..255: the cast is exact
    canvas[:rh, :rw] = resized.to(torch.uint8)
    return canvas, r


def normalize_canvas(canvas: torch.Tensor, mean: torch.Tensor,
                     std: torch.Tensor, to_rgb: bool = True) -> torch.Tensor:
    """uint8 BGR canvas ``[..., 3]`` -> float32 ``(x / 255 - mean) / std``,
    in RGB order (``to_rgb``) or BGR, dividing by 255 as XLA does (times the
    float32 reciprocal).  The canvas holds integers, so this equals the
    reference's normalization of its float canvas."""
    x = canvas.to(torch.float32)
    if to_rgb:
        x = x.flip(-1)
    return (x * INV_255 - mean) / std


def _canvas_state(pre: Optional[torch.Tensor]) -> dict:
    """A feedback detector's previous canvas as a snapshot's host numpy."""
    return {"pre_canvas": None if pre is None else pre.cpu().numpy()}


def _load_canvas(state: dict, device) -> Optional[torch.Tensor]:
    """:func:`_canvas_state`'s canvas back on ``device``."""
    pre = state.get("pre_canvas")
    return None if pre is None else torch.as_tensor(
        np.asarray(pre, np.uint8)).to(device)


@dataclasses.dataclass
class _Upload:
    """A frame on its way to the card: the device tensor, the event its
    copy records, and the pinned host buffer the copy reads."""

    tensor: torch.Tensor
    ready: Optional[torch.cuda.Event]
    pinned: Optional[torch.Tensor]


@dataclasses.dataclass
class _Pending:
    """An enqueued step: the result rows, ``valid`` and the NMS's
    ``converged`` flag (pinned host copies on the card), the event recorded
    after their copies, the device canvas, the scale, and every buffer the
    step or its copies still read.  A batch step's handle has a leading
    frame dimension on each tensor."""

    rows: torch.Tensor
    valid: torch.Tensor
    converged: torch.Tensor
    done: Optional[torch.cuda.Event]
    canvas: torch.Tensor
    scale: float
    pred: torch.Tensor  # the decoded rows, for a frame whose NMS needs more
    held: tuple


@dataclasses.dataclass
class _ShardedPending:
    """A batch step split over the replicas of
    :meth:`YoloxDetector.shard_lockstep`: each replica's handle, and the
    number of frames asked for (the rest are the padding's)."""

    parts: list
    frames: int


class PipelinedFrameIO:
    """The frame loop's host side of a detector step, shared by
    :class:`YoloxDetector` and the exported steps'
    :class:`~busca_tpu_torch.serve.detector.ArtifactDetector`: the pinned
    upload on a copy stream, the non-blocking copies of a step's fixed-size
    results into pinned buffers, and the wait that builds a
    :class:`DetectorOutput`, finishing a frame whose fixed-step NMS had not
    converged with the iterated NMS.  A subclass sets ``device``,
    ``_copy_stream`` (None on the CPU), ``num_classes``, ``conf_thresh``,
    ``nms_thresh``, ``max_outputs``, ``pre_nms_topk`` and
    ``nms_fallbacks``."""

    def put_frame(self, frame_bgr) -> _Upload:
        """Start a uint8 BGR frame's upload: a pinned host copy, then a
        non-blocking copy on the detector's copy stream that records an
        event; :meth:`detect_async` waits on it on the device.  On the CPU
        the frame is wrapped as it is."""
        host = torch.from_numpy(np.ascontiguousarray(frame_bgr))
        if self._copy_stream is None:
            return _Upload(host, None, None)
        pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        pinned.copy_(host)
        with torch.cuda.stream(self._copy_stream):
            dev = pinned.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return _Upload(dev, ready, pinned)

    def _readable(self, frames):
        """Frames (a :meth:`put_frame` upload, host arrays or a tensor on
        the device) as an upload the compute stream may read: a host input
        is uploaded, and the compute stream waits for the upload's event.
        Returns the upload and the compute stream (None on the CPU)."""
        if not isinstance(frames, _Upload):
            if torch.is_tensor(frames) and frames.device == self.device:
                frames = _Upload(frames, None, None)
            else:
                frames = self.put_frame(np.asarray(frames))
        stream = (torch.cuda.current_stream(self.device)
                  if self._copy_stream is not None else None)
        if frames.ready is not None:
            stream.wait_event(frames.ready)
            # the copy stream allocated it; the compute stream reads it
            frames.tensor.record_stream(stream)
        return frames, stream

    @staticmethod
    def _copy_out(stream, results):
        """Non-blocking copies of a step's fixed-size ``results`` into
        pinned host buffers and the event recorded after them; on the CPU
        the results themselves and no event."""
        if stream is None:
            return list(results), None
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in results]
        for h, t in zip(host, results):
            h.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
        return host, done

    def wait(self, handle: _Pending) -> DetectorOutput:
        """Wait for a :meth:`detect_async` handle's copies and build the
        :class:`DetectorOutput`; its ``image`` is the device canvas.  A frame
        whose NMS had not reached its fixed point in the enqueued steps is
        finished here with the iterated NMS (the same fixed point)."""
        if handle.done is not None:
            handle.done.synchronize()
        return self._output(handle.rows, handle.valid, handle.converged,
                            handle.pred, handle.canvas, handle.scale)

    def _output(self, rows, valid, converged, pred, canvas, scale):
        """One frame's host rows as a :class:`DetectorOutput`; a frame whose
        NMS had not converged is finished with the iterated NMS on its
        decoded rows ``pred``."""
        if not bool(converged):
            from busca_tpu_torch.ops.nms import yolox_postprocess

            self.nms_fallbacks += 1
            with torch.no_grad():
                rows, valid = yolox_postprocess(
                    pred, self.num_classes, self.conf_thresh,
                    self.nms_thresh, self.max_outputs, self.pre_nms_topk)
            rows, valid = rows.cpu(), valid.cpu()
        return rows_to_detector_output(rows.numpy(), valid.numpy(), canvas,
                                       scale)

    def detect(self, frame) -> DetectorOutput:
        """One uint8 BGR frame (original resolution), or a
        :meth:`put_frame` upload."""
        with profiling.span("detector.frame"):
            return self.wait(self.detect_async(frame))

    def wait_batch(self, handle: _Pending) -> list:
        """Wait for a :meth:`detect_batch_async` handle's copies and build
        one :class:`DetectorOutput` per frame; frame i's ``image`` is
        ``handle.canvas[i]``, a contiguous view on the device.  Each frame
        whose NMS had not reached its fixed point is finished here on its
        own, as :meth:`wait` does."""
        if handle.done is not None:
            handle.done.synchronize()
        return [self._output(handle.rows[i], handle.valid[i],
                             handle.converged[i], handle.pred[i],
                             handle.canvas[i], handle.scale)
                for i in range(handle.rows.shape[0])]


class YoloxDetector(PipelinedFrameIO):
    """YOLOX wrapped for the per-frame tracking loop.

    Args:
      config: :class:`~busca_tpu_torch.models.yolox.YoloxConfig`
        (``YoloxConfig.size("x", num_classes=1)`` for the ByteTrack MOT
        detector).
      state_dict: the model's weights in the official key layout (an
        official ``.pth``, or ``yolox_state_dict_from_flax``); None = random
        weights from a ``torch.Generator`` seeded with ``seed``.
      test_size: (H, W) detector input; the reference MOT17 uses (800, 1440).
      conf_thresh / nms_thresh: postprocess thresholds (exp.test_conf /
        exp.nmsthre).
      device: ``"cuda"`` (default; raises without CUDA) or ``"cpu"``.
    """

    def __init__(
        self,
        config,
        state_dict=None,
        test_size: Tuple[int, int] = (800, 1440),
        conf_thresh: float = 0.1,
        nms_thresh: float = 0.7,
        max_outputs: int = 256,
        pre_nms_topk: int = 1024,
        device="cuda",
        seed: int = 0,
    ):
        from busca_tpu_torch.models.yolox import YOLOX
        from busca_tpu_torch.utils.device import resolve_device

        self.config = config
        self.device = resolve_device(device)
        model = YOLOX(config)
        if state_dict is None:
            model.init_weights(torch.Generator().manual_seed(seed))
        else:
            load_published_state_dict(model, state_dict, "YOLOX")
        self.model = model.to(self.device).eval()
        self.test_size = tuple(test_size)
        self.conf_thresh = float(conf_thresh)
        self.nms_thresh = float(nms_thresh)
        self.max_outputs = int(max_outputs)
        self.pre_nms_topk = int(pre_nms_topk)
        # frames whose NMS needed more than the step's fixed-point steps
        # (ops/nms.py NMS_STEPS) and was finished in wait()
        self.nms_fallbacks = 0
        self._mean = torch.tensor(IMAGENET_MEAN_RGB, device=self.device)
        self._std = torch.tensor(IMAGENET_STD_RGB, device=self.device)
        self._boxes = {}
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._shards = None

    @property
    def num_classes(self) -> int:
        return self.config.num_classes

    def _replica(self, device) -> "YoloxDetector":
        """This detector with a copy of its model on ``device``."""
        import copy

        device = torch.device(device)
        rep = copy.copy(self)
        rep.device = device
        rep.model = copy.deepcopy(self.model).to(device)
        rep._mean = self._mean.to(device)
        rep._std = self._std.to(device)
        rep._boxes = {}
        rep._copy_stream = (torch.cuda.Stream(device)
                            if device.type == "cuda" else None)
        rep._shards = None
        return rep

    def shard_lockstep(self, devices) -> "YoloxDetector":
        """Split the lockstep batch over ``devices`` (``parallel/mesh.py::
        local_devices``), busca_tpu's dp-sharded lockstep: one replica of
        the detector per device (this detector where a device is its own),
        each frame detected on the device of its slice of the batch (K1
        letterboxes it there), no collective in the step, the outputs
        gathered in :meth:`wait_batch`.  A batch that does not split
        evenly is padded with its last frame, whose outputs are dropped.
        Per frame the numbers are those of the unsplit step.  Returns
        self."""
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("shard_lockstep needs at least one device")
        self._shards = [self if i == 0 and d == self.device
                        else self._replica(d)
                        for i, d in enumerate(devices)]
        return self

    @classmethod
    def build(cls, size: str = "x", ckpt_path: Optional[str] = None,
              num_classes: int = 1, **kw) -> "YoloxDetector":
        """Detector from a size name and an optional checkpoint: an official
        YOLOX ``.pth`` (``{"model": state_dict}``) or a busca_tpu ``.npz``;
        None = random weights."""
        from busca_tpu_torch.models.yolox import YoloxConfig

        config = YoloxConfig.size(size, num_classes=num_classes)
        state = None
        if ckpt_path:
            if ckpt_path.endswith(".npz"):
                from busca_tpu_torch.models.checkpoint import load_params_npz
                from busca_tpu_torch.models.convert import (
                    yolox_state_dict_from_flax,
                )

                state = yolox_state_dict_from_flax(load_params_npz(ckpt_path))
            else:
                state = read_pth_state_dict(ckpt_path)
        return cls(config, state, **kw)

    # ------------------------------------------------------------ device --
    def prep(self, frame: torch.Tensor) -> Tuple[torch.Tensor, float]:
        """uint8 BGR frame ``[H, W, 3]`` on the device -> the uint8 BGR
        letterbox canvas (114 fill) and its scale."""
        return letterbox(frame, self.test_size, PAD_VALUE, self._boxes)

    @torch.no_grad()
    def forward(self, canvas: torch.Tensor) -> torch.Tensor:
        """The canvas -> decoded rows ``[N, 5 + C]``."""
        x = normalize_canvas(canvas, self._mean, self._std)
        return self.model(x.permute(2, 0, 1)[None])[0]

    @torch.no_grad()
    def step(self, canvas: torch.Tensor):
        """The device step, enqueued without a host sync: forward, decode
        and postprocess.  Returns ``(rows [max_outputs, 7], valid,
        converged, pred)``."""
        from busca_tpu_torch.ops.nms import NMS_STEPS, yolox_postprocess

        pred = self.forward(canvas)
        rows, valid, converged = yolox_postprocess(
            pred, self.config.num_classes, self.conf_thresh,
            self.nms_thresh, self.max_outputs, self.pre_nms_topk,
            nms_steps=NMS_STEPS)
        return rows, valid, converged, pred

    def calibrate_random_weights(self, frames_bgr, obj_bias: float,
                                 cls_bias: float,
                                 box_hw: Tuple[float, float]):
        """Calibrate random weights on uint8 BGR frames (smoke runs and
        tests): :meth:`~busca_tpu_torch.models.yolox.YOLOX.
        calibrate_random_weights` on their normalized canvases as one batch;
        ``box_hw`` in canvas pixels."""
        x = torch.stack([normalize_canvas(
            self.prep(torch.as_tensor(np.asarray(f)).to(self.device))[0],
            self._mean, self._std) for f in frames_bgr])
        self.model.calibrate_random_weights(x.permute(0, 3, 1, 2), obj_bias,
                                            cls_bias, box_hw)
        return self

    # --------------------------------------------------------------- api --
    def detect_async(self, frame) -> _Pending:
        """Enqueue the step for one frame (a :meth:`put_frame` upload, a
        host array or a tensor on the device) and the non-blocking copies of
        its result into pinned buffers; returns a handle for :meth:`wait`.
        On the card nothing here waits for the device."""
        frame, stream = self._readable(frame)
        canvas, r = self.prep(frame.tensor)
        rows, valid, converged, pred = self.step(canvas)
        host, done = self._copy_out(stream, (rows, valid, converged))
        return _Pending(*host, done, canvas, r, pred,
                        (frame, rows, valid, converged))

    # ------------------------------------------------------ lockstep --
    @torch.no_grad()
    def batch_step(self, frames: torch.Tensor):
        """The lockstep batch step for uint8 BGR frames ``[B, H, W, 3]`` on
        the device, enqueued without a host sync: each frame letterboxed
        by the crop op (K1 on the card, one call per frame) into its slice
        of one canvas batch, the normalization and the forward over the
        batch, the postprocess per frame.  Returns ``(rows [B, K, 7],
        valid [B, K], converged [B], preds, canvases, r)``."""
        from busca_tpu_torch.ops.nms import NMS_STEPS, yolox_postprocess

        th, tw = self.test_size
        canvases = torch.full((frames.shape[0], th, tw, 3), PAD_VALUE,
                              dtype=torch.uint8, device=frames.device)
        r = None
        for frame, canvas in zip(frames, canvases):
            _, r = letterbox(frame, self.test_size, PAD_VALUE, self._boxes,
                             out=canvas)
        x = normalize_canvas(canvases, self._mean, self._std)
        preds = self.model(x.permute(0, 3, 1, 2))
        outs = [yolox_postprocess(
            pred, self.config.num_classes, self.conf_thresh,
            self.nms_thresh, self.max_outputs, self.pre_nms_topk,
            nms_steps=NMS_STEPS) for pred in preds]
        rows, valid, converged = (torch.stack(t) for t in zip(*outs))
        return rows, valid, converged, preds, canvases, r

    def detect_batch_async(self, frames_bgr) -> _Pending:
        """Enqueue the batch step for one frame of each of B same-resolution
        sequences (a ``[B, H, W, 3]`` array or sequence of frames, a
        :meth:`put_frame` upload of one, or a device tensor) and the
        non-blocking copies of its results into pinned buffers; returns a
        handle for :meth:`wait_batch`.  The frames go up as one pinned
        upload on the copy stream.  On the card nothing here waits for the
        device."""
        if self._shards is not None:
            return self._sharded_batch_async(frames_bgr)
        return self._batch_async(frames_bgr)

    def _batch_async(self, frames_bgr) -> _Pending:
        frames, stream = self._readable(frames_bgr)
        rows, valid, converged, preds, canvases, r = self.batch_step(
            frames.tensor)
        host, done = self._copy_out(stream, (rows, valid, converged))
        return _Pending(*host, done, canvases, r, preds,
                        (frames, rows, valid, converged))

    def _sharded_batch_async(self, frames_bgr) -> _ShardedPending:
        """:meth:`detect_batch_async` over the replicas: the batch padded
        to a multiple of their count with its last frame, each replica's
        slice enqueued on its device (a host slice uploaded there)."""
        if isinstance(frames_bgr, _Upload):
            frames_bgr = frames_bgr.tensor
        frames = (frames_bgr if torch.is_tensor(frames_bgr)
                  else np.asarray(frames_bgr))
        b, n = frames.shape[0], len(self._shards)
        pad = (-b) % n
        if pad:
            last = frames[-1:]
            frames = (torch.cat([frames] + [last] * pad)
                      if torch.is_tensor(frames)
                      else np.concatenate([frames] + [last] * pad))
        k = frames.shape[0] // n
        parts = []
        for i, rep in enumerate(self._shards):
            part = frames[i * k:(i + 1) * k]
            if rep.device.type == "cuda":
                # K1's ctypes launch runs on the thread's current device
                with torch.cuda.device(rep.device):
                    parts.append(rep._batch_async(part))
            else:
                parts.append(rep._batch_async(part))
        return _ShardedPending(parts, b)

    def wait_batch(self, handle) -> list:
        """:meth:`PipelinedFrameIO.wait_batch`, and for a sharded handle
        every replica's outputs in batch order, the padding's dropped."""
        if not isinstance(handle, _ShardedPending):
            return super().wait_batch(handle)
        outs = []
        for rep, part in zip(self._shards, handle.parts):
            outs.extend(PipelinedFrameIO.wait_batch(rep, part))
            if rep is not self:
                self.nms_fallbacks += rep.nms_fallbacks
                rep.nms_fallbacks = 0
        return outs[:handle.frames]

    def detect_batch(self, frames_bgr) -> list:
        """One frame of each of B same-resolution sequences in one device
        step (one per replica after :meth:`shard_lockstep`); one
        :class:`DetectorOutput` per frame."""
        with profiling.span("detector.batch"):
            return self.wait_batch(self.detect_batch_async(frames_bgr))


def read_pth_state_dict(path: str) -> dict:
    """A ``.pth`` checkpoint's state dict: the training envelopes
    (``model_state_dict``, CenterNet's ``state_dict``, YOLOX's ``model``)
    unwrapped and DataParallel's ``module.`` prefixes stripped."""
    state = torch.load(path, map_location="cpu", weights_only=False)
    for envelope in ("model_state_dict", "state_dict", "model"):
        if isinstance(state.get(envelope), dict):
            state = state[envelope]
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state.items()}


def load_published_state_dict(model: torch.nn.Module, state_dict,
                              name: str):
    """Copy a state dict in a detector's published key layout (YOLOX's
    official one, CenterTrack's DLASeg) into ``model``.  Every parameter and
    running statistic must be present (``num_batches_tracked`` may be
    absent: busca_tpu's variables have none); unknown keys raise, naming
    the detector."""
    state_dict = {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v)
                  else v for k, v in state_dict.items()}
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"{name} checkpoint mismatch: missing {missing}, "
                       f"unexpected {unexpected}")
    return model


def build_yolox_detector(size: str = "x", ckpt=None,
                         test_size=(800, 1440), conf_thresh=0.01,
                         nms_thresh=0.7, device="cuda",
                         seed: int = 0) -> YoloxDetector:
    """A YOLOX detector of ``size`` (tiny, s, m, l, x) with one class, the
    ByteTrack MOT detector, for the eval CLI: ``YoloxDetector.build``."""
    return YoloxDetector.build(
        size=size, ckpt_path=ckpt, num_classes=1, test_size=test_size,
        conf_thresh=conf_thresh, nms_thresh=nms_thresh, device=device,
        seed=seed)


class TransCenterDetector:
    """Stateful TransCenter detector for the per-frame tracking loop.

    Mirrors the reference wrapper's statefulness and IO contract
    (adapters/TransCenter/models/transcenter.py:75-203): keeps the previous
    frame's canvas (``pre_sample``), consumes the tracker's current positions
    as ``pre_cts`` center priors, resets per video, and emits score-filtered
    person detections.

    Args:
      config: :class:`~busca_tpu_torch.models.transcenter.TransCenterConfig`;
        None = ``for_dataset("mot17")`` (PVTv2-b2, 6 decoder layers).
      state_dict: the model's weights (e.g. from
        ``transcenter_state_dict_from_flax``); None = random weights from a
        ``torch.Generator`` seeded with ``seed``.
      device: ``"cuda"`` (default; raises without CUDA) or ``"cpu"``.
    """

    uses_feedback = True  # the loop passes tracker.get_detector_positions()

    def __init__(
        self,
        config=None,
        state_dict=None,
        test_size: Tuple[int, int] = (640, 1088),
        out_thresh: float = 0.1,
        device="cuda",
        seed: int = 0,
    ):
        from busca_tpu_torch.models.transcenter import (
            TransCenterConfig,
            TransCenterDETR,
        )
        from busca_tpu_torch.utils.device import resolve_device

        self.config = config or TransCenterConfig.for_dataset("mot17")
        self.device = resolve_device(device)
        model = TransCenterDETR(self.config)
        if state_dict is None:
            model.init_weights(torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        self.test_size = tuple(test_size)
        self.out_thresh = float(out_thresh)
        self._mean = torch.tensor(IMAGENET_MEAN_RGB, device=self.device)
        self._std = torch.tensor(IMAGENET_STD_RGB, device=self.device)
        self._boxes = {}
        self.reset()

    def reset(self):
        """Per-video state reset (transcenter.py:197-203)."""
        self._pre_canvas = None

    def state_dict(self) -> dict:
        """Cross-frame detector state as plain numpy: the previous frame's
        canvas (the reference's ``pre_sample``).  Restoring it makes the next
        frame equal to the unbroken stream's; a plain ``reset()`` would
        re-prime ``pre_sample`` from the next frame instead."""
        return _canvas_state(self._pre_canvas)

    def load_state_dict(self, state: dict):
        self._pre_canvas = _load_canvas(state, self.device)

    def prep(self, frame: torch.Tensor) -> Tuple[torch.Tensor, float]:
        """uint8 BGR frame ``[H, W, 3]`` on the device -> the uint8 BGR
        letterbox canvas ``[test_h, test_w, 3]`` (zero fill) and its
        scale."""
        return letterbox(frame, self.test_size, 0, self._boxes)

    @torch.no_grad()
    def step(self, canvas: torch.Tensor, pre_canvas: torch.Tensor,
             pre_hm: torch.Tensor):
        """The device step: forward, decode, score filter and NMS.
        Returns ``(boxes [K, 4], scores [K], valid [K])`` in the input
        plane; invalid rows have ``valid`` False."""
        from busca_tpu_torch.models.transcenter import generic_decode
        from busca_tpu_torch.ops.nms import nms

        cfg = self.config

        def norm(c_u8):
            return normalize_canvas(c_u8, self._mean, self._std)

        out = self.model(norm(canvas)[None], norm(pre_canvas)[None],
                         pre_hm[None])
        # transcenter.py:137-138: hm is not sigmoid'ed in the net
        out["hm"] = torch.clamp(torch.sigmoid(out["hm"]), 1e-4, 1 - 1e-4)
        decoded = generic_decode(out, k=cfg.K)
        boxes = decoded["bboxes"][0] * cfg.down_ratio  # input plane
        scores = decoded["scores"][0]
        # person filter (labels == 1 after +1, transcenter.py:168-172)
        keep = decoded["clses"][0] == 0
        scores = torch.where(keep & (scores >= self.out_thresh), scores,
                             torch.full_like(scores, -torch.inf))
        if cfg.clip:  # mot20 (transcenter.py:173-176)
            th, tw = self.test_size
            hi = torch.tensor([tw - 1, th - 1, tw - 1, th - 1],
                              dtype=boxes.dtype, device=boxes.device)
            boxes = torch.minimum(boxes.clamp(min=0.0), hi)
        # the reference pipes this through the YOLOX postprocess NMS
        # (mot_evaluator.py:160); here too, on the device
        idx, valid = nms(boxes, scores, NMS_IOU, cfg.K)
        safe = idx.clamp(0, boxes.shape[0] - 1).long()
        return boxes[safe], scores[safe], valid

    def detect(
        self, frame_bgr: np.ndarray, current_pos: Optional[np.ndarray] = None
    ) -> DetectorOutput:
        """One uint8 BGR frame (original resolution); ``current_pos`` = the
        tracker's boxes (tlbr, detector coords) from
        ``get_detector_positions``, the stateful feedback loop
        (mot_evaluator.py:158)."""
        from busca_tpu_torch.models.transcenter import render_prior_heatmap
        from busca_tpu_torch.trackers.transcenter import (
            boxes_to_center_priors,
        )

        th, tw = self.test_size
        down = self.config.down_ratio
        # pre_cts: box centers /down_ratio, clamped to the input plane
        # (transcenter.py:104-127; the coords are in the detector plane).
        # Rounding is monotone, so clamping after the division gives the
        # reference's clamp-then-divide values.
        pre_cts = boxes_to_center_priors(current_pos, down)
        if pre_cts is not None:
            pre_cts[:, 0] = np.clip(pre_cts[:, 0], 0, (tw - 1) / down)
            pre_cts[:, 1] = np.clip(pre_cts[:, 1], 0, (th - 1) / down)
        pre_hm = render_prior_heatmap(pre_cts, (th // down, tw // down))

        frame = torch.as_tensor(np.asarray(frame_bgr)).to(self.device)
        canvas, r = self.prep(frame)
        if self._pre_canvas is None:
            # first frame: pre_sample = sample (transcenter.py:95-97)
            self._pre_canvas = canvas
        boxes, scores, valid = self.step(
            canvas, self._pre_canvas, torch.from_numpy(pre_hm).to(self.device)
        )
        self._pre_canvas = canvas  # the device copy, for the next frame

        boxes = boxes.cpu().numpy()
        # a bf16 model's scores are bf16 (busca_tpu hands them to numpy as
        # they are); float32 holds them exactly
        scores = scores.to(torch.float32).cpu().numpy()
        valid = valid.cpu().numpy() & np.isfinite(scores)
        return DetectorOutput(
            boxes_tlbr=boxes[valid].astype(np.float64),
            scores=scores[valid].astype(np.float64),
            image=canvas.cpu().numpy(),
            scale=r,
        )


def build_transcenter_detector(dataset="mot17", ckpt=None,
                               test_size=(640, 1088), out_thresh=0.1,
                               device="cuda",
                               seed: int = 0) -> TransCenterDetector:
    """A TransCenter detector for ``dataset``'s preset.

    ``ckpt``: busca_tpu-trained ``.npz`` weights only (the flax parameter
    tree, converted with ``transcenter_state_dict_from_flax``); upstream
    ``.pth`` cannot be converted (the reference's TransCenter submodule is
    empty).  None = random weights from ``seed``.
    """
    from busca_tpu_torch.models.transcenter import TransCenterConfig

    state = None
    if ckpt:
        if not ckpt.endswith(".npz"):
            raise ValueError(
                "transcenter takes busca_tpu-trained .npz weights; "
                "upstream .pth cannot be converted (the reference's "
                "TransCenter submodule is empty)")
        from busca_tpu_torch.models.checkpoint import load_params_npz
        from busca_tpu_torch.models.convert import (
            transcenter_state_dict_from_flax,
        )

        state = transcenter_state_dict_from_flax(load_params_npz(ckpt))
    return TransCenterDetector(
        TransCenterConfig.for_dataset(dataset), state_dict=state,
        test_size=test_size, out_thresh=out_thresh, device=device, seed=seed,
    )


def track_frames_with_detector(
    detector,
    tracker,
    frames,
    name: str = "seq",
    min_box_area: float = 100.0,
    vertical_thresh: Optional[float] = 1.6,
    det_log: Optional[list] = None,
    viz_dir: Optional[str] = None,
):
    """Drive detector + tracker over raw frames (the reference's eval loop,
    mot_evaluator.py:131-235).  ``viz_dir``: each frame's detector canvas
    with the tracks drawn at its scale, written there as a JPEG.

    The tracker gets the detections mapped back to original coordinates plus
    the detector-resolution canvas for BUSCA crops.  A detector with
    ``uses_feedback`` (TransCenter) gets the tracker's current positions each
    frame, when the tracker exports them.  ``det_log``, when given, collects
    ``(frame_id, boxes_tlbr_orig, scores)`` per frame.

    A detector with ``put_frame`` gets frame t+1's upload started before
    frame t is detected; one with ``detect_async`` (and no feedback) is
    pipelined: frame t+1's step is enqueued before the loop waits for frame
    t, so the tracker's host work for frame t runs while the device computes
    frame t+1.  ``detector_s`` is then the time spent waiting.

    Returns a :class:`~busca_tpu_torch.eval.runner.SequenceResult` whose
    ``stage_times`` split the wall time into ``detector_s`` and
    ``tracker_s``.
    """
    from busca_tpu_torch.eval.runner import (
        SequenceResult,
        filter_output_tracks,
        write_viz_frame,
    )

    feedback = getattr(detector, "uses_feedback", False) and hasattr(
        tracker, "get_detector_positions"
    )
    can_prefetch = hasattr(detector, "put_frame")
    # a feedback detector's input for t+1 depends on the tracker after t
    can_pipeline = hasattr(detector, "detect_async") and not feedback
    results = []
    det_s = trk_s = 0.0
    t0 = time.perf_counter()
    it = iter(frames)
    pending = next(it, None)
    if pending is not None and can_prefetch:
        pending = detector.put_frame(pending)
    if pending is not None and can_pipeline:
        pending = detector.detect_async(pending)
    idx = -1
    while pending is not None:
        idx += 1
        frame = pending
        # start the next frame's upload (and step) before this frame's wait
        pending = next(it, None)
        if pending is not None and can_prefetch:
            pending = detector.put_frame(pending)
        if pending is not None and can_pipeline:
            pending = detector.detect_async(pending)
        t_det = time.perf_counter()
        if can_pipeline:
            det = detector.wait(frame)
        elif feedback:
            det = detector.detect(
                frame, current_pos=tracker.get_detector_positions()
            )
        else:
            det = detector.detect(frame)
        t_trk = time.perf_counter()
        det_s += t_trk - t_det
        if det_log is not None:
            det_log.append((idx + 1, np.asarray(det.boxes_tlbr / det.scale),
                            np.asarray(det.scores)))
        online = tracker.update(
            det.boxes_tlbr / det.scale, det.scores, det.scale, det.image
        )
        trk_s += time.perf_counter() - t_trk
        tlwhs, ids, confs = filter_output_tracks(
            online, min_box_area, vertical_thresh
        )
        results.append((idx + 1, tlwhs, ids, confs))
        if viz_dir is not None:
            # the detector-resolution canvas is the frame the loop holds;
            # the tlwh are original coordinates
            write_viz_frame(viz_dir, idx + 1, det.image, tlwhs, ids,
                            scale=det.scale)
    dt = time.perf_counter() - t0
    return SequenceResult(
        name, len(results), results, dt,
        stage_times={"detector_s": det_s, "tracker_s": trk_s},
    )


def track_sequences_lockstep(
    detector,
    trackers,
    frame_iters,
    names=None,
    min_box_area: float = 100.0,
    vertical_thresh: Optional[float] = 1.6,
    viz_dirs=None,
):
    """Track B same-resolution sequences in lockstep, one frame of each per
    detector call (busca_tpu's multi-sequence throughput mode).  ``viz_dirs``:
    None, or one online-visualization directory (or None) per sequence,
    where each of its frames' canvases is written with its tracks.

    The batch of lockstep frame t+1 is enqueued
    (``detector.detect_batch_async``) before frame t's results are read, so
    the trackers' host work runs while the device computes.  A sequence
    that has ended is fed its last frame again, so the batch keeps its
    shape, and its outputs are dropped.  Per frame: phase 0 starts every
    tracker's ECC solve on the shared CMC pool (``cmc_prefetch``); phase 1
    runs every update up to its BUSCA third round (``update_deferred``);
    phase 2 serves the suspended rounds with one grouped association per
    engine (:func:`~busca_tpu_torch.trackers.base.service_deferred_updates`).
    A detector with only ``detect_batch`` runs unpipelined.

    Returns one :class:`~busca_tpu_torch.eval.runner.SequenceResult` per
    sequence, each with its share of the wall time (its frames over all
    frames) and of ``stage_times`` (``detector_s``: waiting for the batch,
    ``tracker_s``: the three phases).
    """
    from busca_tpu_torch.eval.runner import (
        SequenceResult,
        filter_output_tracks,
        write_viz_frame,
    )
    from busca_tpu_torch.trackers.base import service_deferred_updates

    iters = [iter(f) for f in frame_iters]
    b = len(iters)
    names = names or [f"seq{i}" for i in range(b)]
    current = [next(it, None) for it in iters]
    if any(f is None for f in current):
        raise ValueError("every sequence needs at least one frame")
    results = [[] for _ in range(b)]
    frame_ids = [0] * b
    dispatch = getattr(detector, "detect_batch_async", None)
    if dispatch is None:
        def dispatch(f):
            return detector.detect_batch(f)

        def wait(h):
            return h
    else:
        wait = detector.wait_batch
    det_s = trk_s = 0.0
    t0 = time.perf_counter()
    inflight = (dispatch(np.stack([np.asarray(f) for f in current])),
                [True] * b)
    while inflight is not None:
        handle, active = inflight
        # enqueue the next batch before reading this one
        nxt_active = list(active)
        for i in range(b):
            if not nxt_active[i]:
                continue
            nf = next(iters[i], None)
            if nf is None:
                nxt_active[i] = False
            else:
                current[i] = nf
        inflight = None
        if any(nxt_active):
            inflight = (dispatch(np.stack([np.asarray(f) for f in current])),
                        nxt_active)
        t_det = time.perf_counter()
        dets = wait(handle)
        t_trk = time.perf_counter()
        det_s += t_trk - t_det
        # phase 0: every sequence's ECC solve starts on the CMC pool
        for i in range(b):
            if active[i] and hasattr(trackers[i], "cmc_prefetch"):
                trackers[i].cmc_prefetch(dets[i].image)
        # phase 1: each update up to its BUSCA third round
        onlines = [None] * b
        pending = []
        for i in range(b):
            if not active[i]:
                continue
            d = dets[i]
            frame_ids[i] += 1
            args = (d.boxes_tlbr / d.scale, d.scores, d.scale, d.image)
            if hasattr(trackers[i], "update_deferred"):
                gen = trackers[i].update_deferred(*args)
                try:
                    pending.append((i, gen, next(gen)))
                except StopIteration as e:
                    onlines[i] = e.value
            else:
                onlines[i] = trackers[i].update(*args)
        # phase 2: one grouped association serves every third round
        if pending:
            for i, out in service_deferred_updates(pending).items():
                onlines[i] = out
        for i in range(b):
            if active[i]:
                tlwhs, ids, confs = filter_output_tracks(
                    onlines[i], min_box_area, vertical_thresh)
                results[i].append((frame_ids[i], tlwhs, ids, confs))
                if viz_dirs is not None and viz_dirs[i] is not None:
                    write_viz_frame(viz_dirs[i], frame_ids[i],
                                    dets[i].image, tlwhs, ids,
                                    scale=dets[i].scale)
        trk_s += time.perf_counter() - t_trk
    dt = time.perf_counter() - t0
    total = max(sum(len(r) for r in results), 1)
    out = []
    for i in range(b):
        share = len(results[i]) / total
        out.append(SequenceResult(
            names[i], len(results[i]), results[i], dt * share,
            stage_times={"detector_s": det_s * share,
                         "tracker_s": trk_s * share}))
    return out


def gaussian_radius(det_size: Tuple[float, float], min_overlap: float = 0.7):
    """CenterNet's peak radius from a box size ``(h, w)`` (the published
    three-case formula of its heatmap rendering)."""
    h, w = det_size
    a1 = 1
    b1 = h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 - np.sqrt(max(b1**2 - 4 * a1 * c1, 0))) / 2
    a2 = 4
    b2 = 2 * (h + w)
    c2 = (1 - min_overlap) * w * h
    r2 = (b2 - np.sqrt(max(b2**2 - 4 * a2 * c2, 0))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (h + w)
    c3 = (min_overlap - 1) * w * h
    r3 = (b3 + np.sqrt(max(b3**2 - 4 * a3 * c3, 0))) / 2
    return max(0, min(r1, r2, r3))


class CenterTrackDetector:
    """Stateful CenterTrack detector for the per-frame loop.

    Mirrors adapters/CenterTrack/src/lib/detector.py:90-190: keeps the
    previous frame's canvas (``pre_images``) on the device, renders the
    prior heatmap from the tracker's current dict tracks at input resolution
    (``_get_additional_inputs`` with ``pre_hm: true``), resets per video,
    and returns CenterTrack's dict detections for the ByteTrack-based shim
    (utils/tracker.py:40-74, ``trackers/centertrack.py``).

    Args:
      config: :class:`~busca_tpu_torch.models.centertrack.CenterTrackConfig`;
        None = DLA-34 with exact DCNv2.
      state_dict: the model's weights in the published DLASeg key layout (a
        published ``.pth``, or ``centertrack_state_dict_from_flax``); None =
        random weights from a ``torch.Generator`` seeded with ``seed``.
      test_size: (H, W) detector input; CenterTrack's MOT17 is (544, 960).
      device: ``"cuda"`` (default; raises without CUDA) or ``"cpu"``.
    """

    def __init__(
        self,
        config=None,
        state_dict=None,
        test_size: Tuple[int, int] = (544, 960),
        out_thresh: float = 0.1,
        device="cuda",
        seed: int = 0,
    ):
        from busca_tpu_torch.models.centertrack import (
            CenterTrackConfig,
            CenterTrackNet,
        )
        from busca_tpu_torch.utils.device import resolve_device

        self.config = config or CenterTrackConfig()
        self.device = resolve_device(device)
        model = CenterTrackNet(self.config)
        if state_dict is None:
            model.init_weights(torch.Generator().manual_seed(seed))
        else:
            load_published_state_dict(model, state_dict, "CenterTrack")
        self.model = model.to(self.device).eval()
        self.test_size = tuple(test_size)
        self.out_thresh = float(out_thresh)
        self._mean = torch.tensor(CENTERNET_MEAN_BGR, device=self.device)
        self._std = torch.tensor(CENTERNET_STD_BGR, device=self.device)
        self._boxes = {}
        self.reset()

    def reset(self):
        """Per-video reset (detector.py:90-104, 'Initialize tracking!')."""
        self._pre_canvas = None

    def state_dict(self) -> dict:
        """Cross-frame state as plain numpy: the previous frame's canvas
        (the reference's ``pre_images``, detector.py:100-104), for a
        snapshot's bit-equal resume."""
        return _canvas_state(self._pre_canvas)

    def load_state_dict(self, state: dict):
        """Put a :meth:`state_dict`'s canvas back, on the detector's
        device."""
        self._pre_canvas = _load_canvas(state, self.device)

    def prep(self, frame: torch.Tensor) -> Tuple[torch.Tensor, float]:
        """uint8 BGR frame ``[H, W, 3]`` on the device -> the uint8 BGR
        letterbox canvas ``[test_h, test_w, 3]`` (zero fill, the frame at
        the top left) and its scale."""
        return letterbox(frame, self.test_size, 0, self._boxes)

    def _render_pre_hm(self, tracks, r: float) -> np.ndarray:
        """The prior heatmap ``[test_h, test_w, 1]`` at input resolution
        from dict tracks (detector.py:109-110, ``_get_additional_inputs``):
        one CenterNet-radius Gaussian per track, on the host."""
        th, tw = self.test_size
        out = np.zeros((th, tw, 1), np.float32)
        for t in tracks or []:
            x1, y1, x2, y2 = np.asarray(t["bbox"], np.float64) * r
            w, h = x2 - x1, y2 - y1
            if w <= 0 or h <= 0:
                continue
            radius = max(int(gaussian_radius((np.ceil(h), np.ceil(w)))), 0)
            sigma = max((2 * radius + 1) / 6.0, 0.5)
            cx = np.clip((x1 + x2) / 2.0, 0, tw - 1)
            cy = np.clip((y1 + y2) / 2.0, 0, th - 1)
            y0, y1_ = int(max(cy - 2 * radius, 0)), int(
                min(cy + 2 * radius + 1, th))
            x0, x1_ = int(max(cx - 2 * radius, 0)), int(
                min(cx + 2 * radius + 1, tw))
            if y0 >= y1_ or x0 >= x1_:
                continue
            ys, xs = np.mgrid[y0:y1_, x0:x1_]
            g = np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2)
                       / (2.0 * sigma**2)).astype(np.float32)
            out[y0:y1_, x0:x1_, 0] = np.maximum(out[y0:y1_, x0:x1_, 0], g)
        return out

    @torch.no_grad()
    def step(self, canvas: torch.Tensor, pre_canvas: torch.Tensor,
             pre_hm: torch.Tensor):
        """The device step: normalization, forward, sigmoid with clip and
        the peak decode.  ``pre_hm`` is ``[test_h, test_w, 1]``.  Returns
        ``(boxes [K, 4], scores [K], clses [K], tracking [K, 2])`` in the
        input plane."""
        from busca_tpu_torch.models.transcenter import generic_decode

        cfg = self.config

        def norm(c_u8):  # BGR, as the published code
            return normalize_canvas(c_u8, self._mean, self._std,
                                    to_rgb=False).permute(2, 0, 1)[None]

        out = self.model(norm(canvas), norm(pre_canvas),
                         pre_hm.permute(2, 0, 1)[None])
        out = {k: v.permute(0, 2, 3, 1) for k, v in out.items()}
        out["hm"] = torch.clamp(torch.sigmoid(out["hm"]), 1e-4, 1 - 1e-4)
        decoded = generic_decode(out, k=cfg.K)
        down = cfg.down_ratio
        return (decoded["bboxes"][0] * down, decoded["scores"][0],
                decoded["clses"][0], decoded["tracking"][0] * down)

    def detect(self, frame_bgr, tracks=None):
        """One uint8 BGR frame (original resolution; a host array or a
        tensor) -> ``(results, canvas, scale)``: CenterTrack dict
        detections in original coordinates, the uint8 BGR canvas on the
        device (the tracker's BUSCA crops read it there) and its scale.
        ``tracks``: the adapter's current dict tracks (``adapter.tracks``),
        rendered into the prior heatmap."""
        frame = torch.as_tensor(np.asarray(frame_bgr)).to(self.device)
        canvas, r = self.prep(frame)
        if self._pre_canvas is None:
            self._pre_canvas = canvas
        pre_hm = torch.from_numpy(self._render_pre_hm(tracks, r)).to(
            self.device)
        decoded = self.step(canvas, self._pre_canvas, pre_hm)
        self._pre_canvas = canvas
        return self.results(decoded, r), canvas, r

    def results(self, decoded, r: float):
        """:meth:`step`'s outputs -> CenterTrack dict detections above
        ``out_thresh`` in original coordinates (``/ r``).  The four outputs
        come to the host in one copy: float32 holds each exactly (a bf16
        model's scores and displacements, the class indices)."""
        packed = torch.cat([v.to(torch.float32).reshape(len(v), -1)
                            for v in decoded], dim=1).cpu().numpy()
        boxes = packed[:, :4] / r  # back to original coordinates
        scores, clses = packed[:, 4], packed[:, 5]
        tracking = packed[:, 6:8] / r
        results = []
        for b, s, c, tr in zip(boxes, scores, clses, tracking):
            if s < self.out_thresh:
                continue
            results.append({
                "bbox": b.astype(np.float64),
                "score": float(s),
                "class": int(c) + 1,
                "tracking": tr.astype(np.float64),
                "ct": [(b[0] + b[2]) / 2.0, (b[1] + b[3]) / 2.0],
            })
        return results


def build_centertrack_detector(arch="dla34", sampling="deformable",
                               ckpt=None, test_size=(544, 960),
                               out_thresh=0.1, device="cuda",
                               seed: int = 0) -> CenterTrackDetector:
    """A CenterTrack detector of ``arch`` (``dla34``, ``mobilenet`` or
    ``tiny``) with the decoder's DCN in ``sampling``.

    ``ckpt``: busca_tpu ``.npz`` weights (any sampling; converted with
    ``centertrack_state_dict_from_flax``) or a published DLA-34 ``.pth``,
    which loads as it is (the port's keys are the published ones) and needs
    the free-form offsets of ``deformable`` or ``windowed``.  None = random
    weights from ``seed``.  Raises ``ValueError`` on a ``.pth`` with
    ``sampling="local"`` (the CLI maps it to ``parser.error``).
    """
    from busca_tpu_torch.models.centertrack import CenterTrackConfig

    state = None
    if ckpt:
        if ckpt.endswith(".npz"):
            from busca_tpu_torch.models.checkpoint import load_params_npz
            from busca_tpu_torch.models.convert import (
                centertrack_state_dict_from_flax,
            )

            state = centertrack_state_dict_from_flax(load_params_npz(ckpt))
        else:
            if sampling == "local":
                raise ValueError(
                    "converted CenterTrack .pth checkpoints carry "
                    "free-form DCN offsets; use sampling 'deformable' "
                    "(exact) or 'windowed' (gather-free, exact within "
                    "the +-dcn_window clamp)")
            state = read_pth_state_dict(ckpt)
    if arch == "tiny":
        cfg = CenterTrackConfig.tiny(sampling=sampling)
    elif arch == "mobilenet":
        cfg = CenterTrackConfig(backbone="mobilenet", sampling=sampling)
    else:
        cfg = CenterTrackConfig(sampling=sampling)
    return CenterTrackDetector(cfg, state, test_size=test_size,
                               out_thresh=out_thresh, device=device,
                               seed=seed)


class CenterTrackRunnerDetector:
    """:class:`DetectorOutput` view of the dict-IO :class:`CenterTrackDetector`
    for the tracking server (``busca_tpu.eval.detector.
    CenterTrackRunnerDetector``): the tracker's current dict tracks
    (``CenterTrackShim.get_detector_positions``) render the prior heatmap,
    and the dict detections flatten to arrays, which loses nothing the
    adapter reads (bbox, score, class; the reference shim,
    utils/tracker.py:40-74, drops the rest the same way)."""

    uses_feedback = True

    def __init__(self, det: CenterTrackDetector):
        self.det = det

    def reset(self):
        self.det.reset()

    def state_dict(self) -> dict:
        return self.det.state_dict()

    def load_state_dict(self, state: dict):
        self.det.load_state_dict(state)

    def detect(self, frame_bgr, current_pos=None) -> DetectorOutput:
        from busca_tpu_torch.trackers.centertrack import dicts_to_arrays

        results, canvas, r = self.det.detect(frame_bgr,
                                             tracks=current_pos or [])
        boxes, scores = dicts_to_arrays(results)
        # the dict boxes are in original coordinates; the protocol carries
        # detector coordinates (the caller divides by the scale)
        return DetectorOutput(boxes_tlbr=boxes * r, scores=scores,
                              image=canvas, scale=r)


def track_frames_centertrack(detector: CenterTrackDetector, adapter, frames,
                             name: str = "seq",
                             viz_dir: Optional[str] = None):
    """CenterTrack's per-frame loop: detector dicts -> ``adapter.step`` with
    the device canvas for BUSCA crops (detector.py:143-156), the prior
    heatmap from the adapter's current tracks.  ``viz_dir``: each frame
    with its tracks written there as a JPEG.  Returns a
    :class:`~busca_tpu_torch.eval.runner.SequenceResult` whose
    ``stage_times`` split the wall time into ``detector_s`` and
    ``tracker_s``."""
    from busca_tpu_torch.eval.runner import SequenceResult, write_viz_frame

    results = []
    det_s = trk_s = 0.0
    t0 = time.perf_counter()
    for idx, frame in enumerate(frames):
        t_det = time.perf_counter()
        dets, det_image, r = detector.detect(frame, tracks=adapter.tracks)
        t_trk = time.perf_counter()
        online = adapter.step(dets, det_image, scale=r)
        trk_s += time.perf_counter() - t_trk
        det_s += t_trk - t_det
        tlwhs, ids, confs = [], [], []
        for d in online:
            b = d["bbox"]
            tlwhs.append(np.array([b[0], b[1], b[2] - b[0], b[3] - b[1]]))
            ids.append(d["tracking_id"])
            confs.append(d["score"])
        results.append((idx + 1, tlwhs, ids, confs))
        if viz_dir is not None:
            write_viz_frame(viz_dir, idx + 1, frame, tlwhs, ids)
    dt = time.perf_counter() - t0
    return SequenceResult(name, len(results), results, dt,
                          stage_times={"detector_s": det_s,
                                       "tracker_s": trk_s})
