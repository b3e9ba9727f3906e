"""The reference YOLOX detector: the plain letterbox (``benchref.crop``), the
reference YOLOX forward (float32 convolutions through cuDNN with TF32 off,
not the program's im2col GEMM) and the postprocess with the NMS iterated to
its fixed point.  One frame at a time, as the reference runs."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from benchref.crop import (
    IMAGENET_MEAN_RGB,
    IMAGENET_STD_RGB,
    PAD_VALUE,
    letterbox,
    normalize_canvas,
)
from benchref.nms import yolox_postprocess


class RefYolox:
    def __init__(self, model, test_size: Tuple[int, int], conf_thresh: float,
                 nms_thresh: float, max_outputs: int = 256,
                 pre_nms_topk: int = 1024):
        self.model = model
        self.device = next(model.parameters()).device
        self.test_size = tuple(test_size)
        self.conf_thresh = float(conf_thresh)
        self.nms_thresh = float(nms_thresh)
        self.max_outputs = int(max_outputs)
        self.pre_nms_topk = int(pre_nms_topk)
        self._mean = torch.tensor(IMAGENET_MEAN_RGB, device=self.device)
        self._std = torch.tensor(IMAGENET_STD_RGB, device=self.device)
        self._boxes = {}

    def canvas(self, frame) -> Tuple[torch.Tensor, float]:
        f = torch.as_tensor(np.asarray(frame)).to(self.device)
        return letterbox(f, self.test_size, PAD_VALUE, self._boxes)

    def _x(self, canvas):
        return normalize_canvas(canvas, self._mean, self._std).permute(
            2, 0, 1)

    @torch.no_grad()
    def detect(self, frame):
        """``(boxes_tlbr [N, 4] in frame pixels, scores [N])``, float64."""
        canvas, r = self.canvas(frame)
        pred = self.model(self._x(canvas)[None])[0]
        rows, valid = yolox_postprocess(
            pred, self.model.config.num_classes, self.conf_thresh,
            self.nms_thresh, self.max_outputs, self.pre_nms_topk)
        rows = rows.cpu().numpy()[valid.cpu().numpy()]
        return (rows[:, :4].astype(np.float64) / r,
                (rows[:, 4] * rows[:, 5]).astype(np.float64))

    @torch.no_grad()
    def calibrate_random_weights(self, frames, obj_bias: float,
                                 cls_bias: float, box_hw):
        """The model's ``calibrate_random_weights`` on the frames'
        normalized canvases as one batch (``box_hw`` in canvas pixels)."""
        x = torch.stack([self._x(self.canvas(f)[0]) for f in frames])
        self.model.calibrate_random_weights(x, obj_bias, cls_bias, box_hw)
        return self
