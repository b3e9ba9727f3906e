"""Per-detection ReID feature extraction for the live tracking paths (port
of ``busca_tpu.eval.features``).

GHOST computes ReID features for every detection of every frame
(adapters/GHOST/src/base_tracker.py:116 ``get_features``), and GHOST's
BUSCA Kalman candidates get *fresh* features computed on their crops
(src/tracker.py:684-708).  StrongSORT reads precomputed features from
``.npy`` artifacts, or the same encoder on the live path.

uint8 BGR crops -> GHOST normalization -> the ReID ResNet-50 with batch-stat
BatchNorm (GHOST's domain adaptation) -> L2-normalized 512-d features, on
one device.  Batch-stat BN makes the batch part of the function: busca_tpu
pads each chunk to a bucket and masks the padded lanes out of the
statistics, and splits a batch above the largest bucket into chunks of
that size, each with its own statistics.  The port runs each chunk at its
exact size (the masked padded batch and the exact batch are the same
function) and chunks at the same boundaries.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from busca_tpu_torch.utils import profiling

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


class ReidFeatureExtractor:
    """``crops [N, H, W, 3] (BGR, uint8 values) -> features [N, D]``.

    Plugs into ``GhostTracker(feature_extractor=...)`` and the runner's
    ``FeatureShim``.  The crops are a host array (or a sequence of ``[H, W,
    3]`` arrays) or a tensor, such as the crop op's output on the device,
    which then goes into the network without a host round trip.  Weights
    come from a state dict under the reference's key names (``model_feats
    .pth``, or busca_tpu's variables through
    :func:`~busca_tpu_torch.models.convert.resnet_state_dict_from_flax`);
    without one they are random, drawn from ``seed``.

    ``calls`` counts the network's calls.
    """

    def __init__(
        self,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        layers: Sequence[int] = (3, 4, 6, 3),
        num_classes: int = 299,
        crop_hw: Tuple[int, int] = (384, 128),
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        dtype: str = "float32",
        output_option: str = "plain",
        device="cuda",
        seed: int = 0,
    ):
        from busca_tpu_torch.models.busca import (
            INPUT_PIXEL_MEAN_BGR,
            INPUT_PIXEL_STD_BGR,
            seeded_init,
        )
        from busca_tpu_torch.models.precision import compute_dtype
        from busca_tpu_torch.models.reid import ReIDResNet
        from busca_tpu_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        self.crop_hw = tuple(crop_hw)
        self.buckets = tuple(sorted(buckets))
        self.output_option = output_option
        model = ReIDResNet(layers=tuple(layers), num_classes=num_classes,
                           dtype=compute_dtype(dtype))
        if state_dict is None:
            seeded_init(model, torch.Generator().manual_seed(seed))
        else:
            load_reid_state(model, state_dict)
        self.model = model.to(self.device).eval()
        self.feature_dim = model.fc.weight.shape[1]
        self._mean = torch.tensor(INPUT_PIXEL_MEAN_BGR.tolist(),
                                  device=self.device)
        self._std = torch.tensor(INPUT_PIXEL_STD_BGR.tolist(),
                                 device=self.device)
        self._255 = torch.full((), 255.0, device=self.device)
        self.calls = 0

    @torch.inference_mode()
    def features(self, crops: torch.Tensor) -> torch.Tensor:
        """Device features ``[N, D]`` of crops already on the device."""
        n = crops.shape[0]
        if n == 0:
            return torch.zeros((0, self.feature_dim), device=self.device)
        x = crops.to(self.device, torch.float32)
        # a device tensor, not a Python scalar: torch on CUDA divides by a
        # scalar as a multiplication by its reciprocal
        x = ((x / self._255 - self._mean) / self._std).flip(-1)
        step = self.buckets[-1]
        out = []
        for start in range(0, n, step):
            _, feats = self.model(x[start:start + step],
                                  output_option=self.output_option)
            out.append(feats)
            self.calls += 1
        return torch.cat(out) if len(out) > 1 else out[0]

    def __call__(self, crops) -> np.ndarray:
        with profiling.span("reid.extract"):
            if not torch.is_tensor(crops):
                crops = np.asarray(crops) if len(crops) else np.zeros(
                    (0,) + self.crop_hw + (3,), np.uint8)
                crops = torch.from_numpy(np.ascontiguousarray(crops))
            return self.features(crops).cpu().numpy()

    @classmethod
    def from_checkpoint(cls, path: str, **kw) -> "ReidFeatureExtractor":
        """Build from a ``.npz`` of busca_tpu ReIDResNet variables
        (``save_params_npz``) or a reference ``.pth`` GHOST ReID checkpoint
        (busca/reid/load_trained_net.py semantics)."""
        return cls(state_dict=read_reid_checkpoint(path), **kw)


def read_reid_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A ReID checkpoint as a state dict under the reference's keys."""
    if path.endswith(".npz"):
        from busca_tpu_torch.models.checkpoint import load_params_npz
        from busca_tpu_torch.models.convert import resnet_state_dict_from_flax

        tree = load_params_npz(path)
        if "params" not in tree:
            tree = {"params": tree}
        return resnet_state_dict_from_flax(tree)
    state = torch.load(path, map_location="cpu", weights_only=False)
    for envelope in ("model_state_dict", "state_dict"):
        if envelope in state:
            state = state[envelope]
            break
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state.items()}


def load_reid_state(model: torch.nn.Module,
                    state_dict: Dict[str, torch.Tensor]):
    """Copy a ReID state dict into ``model``.  Every parameter must be
    present; BN running statistics may be absent (batch-stat BN does not
    read them); the person-classifier head ``fc_person`` is ignored.
    Unknown keys raise."""
    state_dict = {k: v if torch.is_tensor(v) else torch.from_numpy(
                      np.asarray(v)) for k, v in state_dict.items()
                  if not k.startswith("fc_person.")}
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    params = {name for name, _ in model.named_parameters()}
    absent = [k for k in missing if k in params]
    unexpected = [k for k in unexpected if not k.endswith(
        "num_batches_tracked")]
    if absent or unexpected:
        raise KeyError(f"ReID checkpoint mismatch: missing {absent}, "
                       f"unexpected {unexpected}")
    return model
