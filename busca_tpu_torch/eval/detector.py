"""Live detector-in-the-loop evaluation: frame -> detector -> NMS -> tracker
(port of the TransCenter part of ``busca_tpu.eval.detector``).

Per frame:

1. preproc: aspect-preserving letterbox resize onto a zero canvas of the test
   size through the crop op (kernel K1 on the card), BGR -> RGB, ImageNet
   normalization;
2. the TransCenter forward over the current and the previous canvas with the
   tracker's positions as a prior heatmap (kernel K2 in every decoder
   attention on the card), ``generic_decode``;
3. score filter and static-size NMS on the device;
4. the uint8 BGR canvas handed to the tracker for BUSCA crops (the
   reference's ``bboxes /= scale`` + crops at ``bboxes * scale`` scheme).

YOLOX (``YoloxDetector``, the ``put_frame``/``detect_async`` pipelining) and
CenterTrack are not ported yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

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


@dataclasses.dataclass
class DetectorOutput:
    """One frame's detections, in detector (resized) coordinates."""

    boxes_tlbr: np.ndarray  # [N, 4] detector coords
    scores: np.ndarray  # [N]
    image: np.ndarray  # [test_h, test_w, 3] uint8 BGR canvas, on the host
    scale: float  # detector coords = original coords * scale


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
        self.reset()

    def reset(self):
        """Per-video state reset (transcenter.py:197-203)."""
        self._pre_canvas = None

    def state_dict(self) -> dict:
        """Cross-frame detector state as plain numpy: the previous frame's
        canvas (the reference's ``pre_sample``).  Restoring it makes the next
        frame equal to the unbroken stream's; a plain ``reset()`` would
        re-prime ``pre_sample`` from the next frame instead."""
        pre = self._pre_canvas
        return {"pre_canvas": None if pre is None else pre.cpu().numpy()}

    def load_state_dict(self, state: dict):
        pre = state.get("pre_canvas")
        self._pre_canvas = None if pre is None else torch.as_tensor(
            np.asarray(pre, np.uint8)).to(self.device)

    def prep(self, frame: torch.Tensor) -> Tuple[torch.Tensor, float]:
        """uint8 BGR frame ``[H, W, 3]`` on the device -> the uint8 BGR
        letterbox canvas ``[test_h, test_w, 3]`` and its scale."""
        from busca_tpu_torch.ops.crop import crop_resize_normalize

        fh, fw = int(frame.shape[0]), int(frame.shape[1])
        th, tw = self.test_size
        r = min(th / fh, tw / fw)
        rh, rw = int(fh * r), int(fw * r)
        box = torch.tensor([[0.0, 0.0, float(fw), float(fh)]],
                           device=frame.device)
        resized = crop_resize_normalize(
            frame, box, out_hw=(rh, rw), normalize=False, bgr_input=True,
            rgb_output=False, quantize_uint8=True,
        )[0]
        canvas = torch.zeros((th, tw, 3), dtype=torch.uint8,
                             device=frame.device)
        # the quantized crop holds integers in 0..255: the cast is exact
        canvas[:rh, :rw] = resized.to(torch.uint8)
        return canvas, r

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
            x = c_u8.to(torch.float32).flip(-1) * INV_255
            return (x - self._mean) / self._std

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
        scores = scores.cpu().numpy()
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
):
    """Drive detector + tracker over raw frames (the reference's eval loop,
    mot_evaluator.py:131-235).

    The tracker gets the detections mapped back to original coordinates plus
    the detector-resolution canvas for BUSCA crops.  A detector with
    ``uses_feedback`` (TransCenter) gets the tracker's current positions each
    frame, when the tracker exports them.  ``det_log``, when given, collects
    ``(frame_id, boxes_tlbr_orig, scores)`` per frame.

    Returns a :class:`~busca_tpu_torch.eval.runner.SequenceResult` whose
    ``stage_times`` split the wall time into ``detector_s`` and
    ``tracker_s``.
    """
    from busca_tpu_torch.eval.runner import (
        SequenceResult,
        filter_output_tracks,
    )

    feedback = getattr(detector, "uses_feedback", False) and hasattr(
        tracker, "get_detector_positions"
    )
    results = []
    det_s = trk_s = 0.0
    t0 = time.perf_counter()
    for idx, frame in enumerate(frames):
        t_det = time.perf_counter()
        if feedback:
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
    dt = time.perf_counter() - t0
    return SequenceResult(
        name, len(results), results, dt,
        stage_times={"detector_s": det_s, "tracker_s": trk_s},
    )
