"""The ReID extractor of a feature tracker (a configuration's ``reid``
block): its weights, the program's ``ReidFeatureExtractor``, its recording
wrapper, its number of the check (``feat_rel``) and its operations."""

from __future__ import annotations

import numpy as np
import torch

from bmk.probe import frozen


def reference_model(reid: dict, seed: int, device):
    """The reference ReID ResNet of the configuration, filled."""
    from benchref.precision import compute_dtype
    from benchref.reid import ReIDResNet
    from bmk.weights import fill_

    with torch.device(device):
        model = ReIDResNet(layers=tuple(reid["layers"]),
                           num_classes=int(reid["num_classes"]),
                           dtype=compute_dtype(reid["dtype"]))
    return fill_(model, seed, 3).eval()


def make_weights(run) -> dict:
    from bmk.weights import cpu_state

    return cpu_state(reference_model(run.config["reid"],
                                     int(run.config["weights_seed"]),
                                     run.device))


def build(config: dict, state: dict, device):
    from busca_tpu_torch.eval.features import ReidFeatureExtractor

    r = config["reid"]
    return ReidFeatureExtractor(state_dict=state, layers=tuple(r["layers"]),
                                num_classes=int(r["num_classes"]),
                                crop_hw=tuple(r["crop_hw"]),
                                dtype=r["dtype"], device=device)


class Recording:
    """The extractor, each call spanned and its output kept in call order
    (the reference tracker replays them)."""

    def __init__(self, inner, rec):
        self._inner = inner
        self._rec = rec

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __call__(self, crops):
        with self._rec.span("reid"):
            out = self._inner(crops)
        if self._rec.active:
            self._rec.extractor_outputs.append(frozen(out))
        self._rec.forward("extractor", int(out.shape[0]))
        return out


def wrap(feats, rec):
    return Recording(feats, rec)


def watch(shim, rec):
    """Keep the sampled frames' detection features with the frame and the
    boxes they were cut at."""
    orig = shim._features

    def features(boxes, scale, frame):
        out = orig(boxes, scale, frame)
        if rec.pick("features"):
            rec.feat_calls.append((frame, np.asarray(boxes, np.float64)
                                   * scale, frozen(out)))
        return out

    shim._features = features
    return shim


def gaps(run):
    """``feat_rel``: the sampled frames' detection features against the
    reference ReID on the plain crops of the frame at the detections'
    boxes, relative to the largest reference feature; a sample that
    compared nothing fails."""
    limit = run.config["limits"]["feat_rel"]
    if not run.rec.feat_calls:
        return [("feat_rel", float("inf"), limit)]
    return [("feat_rel", _feat_rel(run), limit)]


@torch.inference_mode()
def _feat_rel(run) -> float:
    from benchref.busca import INPUT_PIXEL_MEAN_BGR, INPUT_PIXEL_STD_BGR
    from benchref.crop import crop_resize_plain

    r = run.config["reid"]
    model = reference_model(r, 0, run.device)
    model.load_state_dict(run.states["extractor"])
    dev = run.device
    mean = torch.tensor(INPUT_PIXEL_MEAN_BGR.tolist(), device=dev)
    std = torch.tensor(INPUT_PIXEL_STD_BGR.tolist(), device=dev)
    c255 = torch.full((), 255.0, device=dev)
    worst = 0.0
    for frame, boxes, out in run.rec.feat_calls:
        f = torch.as_tensor(frame).to(dev)
        crops = crop_resize_plain(
            f, torch.as_tensor(boxes, dtype=torch.float32, device=dev),
            tuple(r["crop_hw"]), quantize_uint8=True)
        x = ((crops / c255 - mean) / std).flip(-1)
        want = model(x, output_option="plain")[1].float().cpu().numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        worst = max(worst, float(np.abs(out - want).max()) / scale)
    return worst


def flops(config: dict, crops: int):
    """One recorded call's operations: the ResNet on ``crops`` crops."""
    from bmk.flops import reid_flops_per_crop

    r = config["reid"]
    return (reid_flops_per_crop(tuple(r["layers"]), int(r["num_classes"]),
                                tuple(r["crop_hw"])) * crops, r["dtype"])
