"""The weight bridge: JAX-package variables -> the port's state dict.

``busca_tpu`` keeps its weights as flax variable trees (``params`` and, for
running-stat BN, ``batch_stats``); ``busca_tpu.models.convert`` maps the
reference torch key layout onto them.  :func:`state_dict_from_flax` is the
inverse of ``convert_busca_state_dict`` / ``convert_resnet_state_dict``:
given the variables as nested dicts of numpy arrays it returns tensors under
the reference torch keys, which are the port's module names.  Convolution
kernels go back from ``[kh, kw, in, out]`` to ``[out, in, kh, kw]``; the
LayerNorm ``scale`` becomes ``weight``.

:func:`load_checkpoint` reads a ``.npz`` of flattened flax variables or a
reference ``.pth`` into a :class:`~busca_tpu_torch.models.busca.BuscaModel`.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_TRANSFORMER_LEAVES = {
    ("self_attn", "in_proj_weight"): "self_attn.in_proj_weight",
    ("self_attn", "in_proj_bias"): "self_attn.in_proj_bias",
    ("self_attn", "out_proj", "weight"): "self_attn.out_proj.weight",
    ("self_attn", "out_proj", "bias"): "self_attn.out_proj.bias",
    ("linear1", "weight"): "linear1.weight",
    ("linear1", "bias"): "linear1.bias",
    ("linear2", "weight"): "linear2.weight",
    ("linear2", "bias"): "linear2.bias",
    ("norm1", "scale"): "norm1.weight",
    ("norm1", "bias"): "norm1.bias",
    ("norm2", "scale"): "norm2.weight",
    ("norm2", "bias"): "norm2.bias",
}


def _leaves(tree: dict, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _resnet_key(path: Tuple[str, ...]) -> Tuple[str, bool]:
    """flax ReIDResNet path -> (torch key, is_conv)."""
    if path == ("conv1", "kernel"):
        return "conv1.weight", True
    if len(path) == 2 and path[0] in ("bn1", "red", "fc", "fc_person"):
        return f"{path[0]}.{path[1]}", False
    m = re.fullmatch(r"layer(\d)_(\d+)", path[0])
    if m and len(path) >= 2:
        block = f"layer{m.group(1)}.{m.group(2)}"
        mod, leaf = path[1], path[-1]
        if mod == "downsample_conv":
            return f"{block}.downsample.0.weight", True
        if mod == "downsample_bn":
            return f"{block}.downsample.1.{leaf}", False
        if mod.startswith("conv"):
            return f"{block}.{mod}.weight", True
        if mod.startswith("bn"):
            return f"{block}.{mod}.{leaf}", False
    raise KeyError(f"unrecognized ReID path: {'/'.join(path)}")


def _busca_key(path: Tuple[str, ...]) -> Tuple[str, bool]:
    """flax BuscaModel path -> (torch key, is_conv)."""
    head = path[0]
    if head == "reid_encoder":
        key, is_conv = _resnet_key(path[1:])
        return "reid_encoder.model." + key, is_conv
    if len(path) == 1 and head.endswith("_token"):
        return head, False
    if head == "encoder":
        return f"encoder.{path[1]}", False
    if head == "decoder_norm":
        return "decoder.0." + ("weight" if path[1] == "scale" else "bias"), \
            False
    if head == "decoder_linear":
        return f"decoder.1.{path[1]}", False
    if head == "transformer_encoder":
        i = re.fullmatch(r"layers_(\d+)", path[1]).group(1)
        return f"transformer_encoder.layers.{i}." + \
            _TRANSFORMER_LEAVES[path[2:]], False
    raise KeyError(f"unrecognized BUSCA path: {'/'.join(path)}")


def _convert(variables: dict, key_fn) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(coll, {})):
            key, is_conv = key_fn(path)
            if is_conv:
                value = value.transpose(3, 2, 0, 1)
            out[key] = torch.from_numpy(np.array(value, copy=True))
    return out


def state_dict_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """BuscaModel flax variables (``{'params': ..., 'batch_stats': ...}``)
    -> the port's (= the reference's) torch state dict."""
    return _convert(variables, _busca_key)


def resnet_state_dict_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """ReIDResNet flax variables -> the bare GHOST ResNet torch state dict
    (the inverse of ``convert_resnet_state_dict``)."""
    return _convert(variables, _resnet_key)


def load_into(model: torch.nn.Module, state_dict: Dict[str, torch.Tensor]):
    """Copy ``state_dict`` into ``model``.  Every parameter except the ReID
    classifier head must be present (the head is unused at inference and
    ``ignore_reid_fc`` checkpoints omit it); BN running statistics and
    bookkeeping buffers may be absent.  Unknown keys raise."""
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    params = {name for name, _ in model.named_parameters()}
    absent = [k for k in missing if k in params and ".fc." not in k]
    unexpected = [k for k in unexpected
                  if not k.endswith(("num_batches_tracked", "pad_token"))
                  and ".fc_person." not in k]
    if absent or unexpected:
        raise KeyError(f"checkpoint mismatch: missing {absent}, "
                       f"unexpected {unexpected}")
    return model


def load_checkpoint(model: torch.nn.Module, path: str):
    """Load ``.npz`` (flattened flax variables, ``/``-joined keys, as
    ``busca_tpu.models.checkpoint.save_params_npz`` writes them) or a
    reference ``.pth`` into ``model``."""
    if path.endswith(".npz"):
        tree: dict = {}
        with np.load(path) as data:
            for k in data.files:
                node = tree
                parts = k.split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = data[k]
        if "params" not in tree:
            tree = {"params": tree}
        sd = state_dict_from_flax(tree)
    else:
        state = torch.load(path, map_location="cpu", weights_only=False)
        if "model_state_dict" in state:
            state = state["model_state_dict"]
        sd = {(k[len("module."):] if k.startswith("module.") else k): v
              for k, v in state.items()}
    return load_into(model, sd)
