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
:func:`transcenter_state_dict_from_flax` does the same for TransCenter,
whose port keeps the flax module names, and
:func:`yolox_state_dict_from_flax` for YOLOX (the inverse of
``busca_tpu.models.yolox.convert_yolox_state_dict``: the official YOLOX key
layout), :func:`aflink_state_dict_from_flax` for the AFLink link model, and
:func:`centertrack_state_dict_from_flax` for CenterTrack (the inverse of
``convert_centertrack_state_dict``: the published DLASeg key layout).
:func:`adamw_state_dict_from_optax` carries a BUSCA run's optax AdamW
state into the port's optimizer, so a JAX run continues in the port.
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


def adamw_state_dict_from_optax(count, mu: dict, nu: dict,
                                model: torch.nn.Module,
                                optimizer: torch.optim.Optimizer) -> dict:
    """optax ``adamw`` state of a BUSCA run (its ``ScaleByAdamState``:
    ``count`` and the ``mu``/``nu`` trees of flax parameter paths, as
    numpy) -> a state dict for ``optimizer``
    (:class:`~busca_tpu_torch.train.trainer.AdamW` over ``model``'s
    parameters), keyed through :func:`state_dict_from_flax`'s mapping; load
    it with ``optimizer.load_state_dict``.  With a schedule, optax's
    ``ScaleByScheduleState`` count equals ``count``."""
    moments = {name: state_dict_from_flax({"params": tree})
               for name, tree in (("mu", mu), ("nu", nu))}
    index = {id(p): n for n, p in model.named_parameters()}
    sd = optimizer.state_dict()
    state = {}
    for group, saved in zip(optimizer.param_groups, sd["param_groups"]):
        saved["count"] = int(count)
        for p, i in zip(group["params"], saved["params"]):
            name = index[id(p)]
            state[i] = {k: moments[k][name] for k in ("mu", "nu")}
    sd["state"] = state
    return sd


def resnet_state_dict_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """ReIDResNet flax variables -> the bare GHOST ResNet torch state dict
    (the inverse of ``convert_resnet_state_dict``)."""
    return _convert(variables, _resnet_key)


def aflink_state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """busca_tpu ``AFLinkModel`` flax parameters (``{'params': ...}`` or the
    bare tree, as numpy) -> the port's
    :class:`~busca_tpu_torch.models.aflink.AFLinkModel` state dict (the
    inverse of busca_tpu's ``convert_aflink_state_dict``): the mapping of
    :func:`transcenter_state_dict_from_flax` (kernels to torch layouts,
    ``scale`` to ``weight``), with ``temporal_{i}`` as ``temporal.{i}``."""
    return {re.sub(r"^temporal_(\d+)\.", r"temporal.\1.", k): v
            for k, v in transcenter_state_dict_from_flax(params).items()}


def transcenter_state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """TransCenterDETR flax parameters (``{'params': ...}`` or the bare
    tree, as numpy) -> the port's
    :class:`~busca_tpu_torch.models.transcenter.TransCenterDETR` state dict.

    The port keeps the flax module names, so a path maps to its ``.``-joined
    key: a Dense kernel ``[in, out]`` becomes a Linear weight ``[out, in]``,
    a convolution kernel HWIO becomes OIHW (a depthwise ``[3, 3, 1, C]``
    becomes ``[C, 1, 3, 3]``), and a LayerNorm ``scale`` becomes ``weight``.
    Either sampling's tree loads: the local modes' ``value_{l}`` Dense
    layers, or the deformable mode's four ``level_embed_{l}`` vectors (kept
    as they are) and each decoder layer's ``cross_cur``/``cross_pre``
    ``value``, ``offsets``, ``weights`` and ``proj``.
    """
    params = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(params):
        leaf = path[-1]
        if leaf == "kernel":
            value = value.T if value.ndim == 2 else value.transpose(3, 2, 0, 1)
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        key = ".".join(path[:-1] + (leaf,))
        out[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    return out


# The ReID classifier heads: unused at inference, and sized by the ReID
# training set, so a reference checkpoint's may not match the config's
# ``reid_num_classes``.  busca_tpu drops them (``convert_busca_state_dict(...,
# ignore_reid_fc=True)``, busca/network.py:445-448).
_REID_HEADS = ("reid_encoder.model.fc.", "reid_encoder.model.fc_person.")
# The learned tokens: a checkpoint that lacks one leaves it at its initial
# value (busca_tpu's ``merge_params`` overlay, busca/network.py:465-467).
_TOKENS = ("cls_token", "sep_token", "non_token", "bad_token")


_YOLOX_SEGMENTS = (
    (r"dark(\d)_conv", r"dark\1.0"),
    (r"dark5_spp", "dark5.1"),
    (r"dark5_csp", "dark5.2"),
    (r"dark(\d)_csp", r"dark\1.1"),
    (r"m_(\d+)", r"m.\1"),
    (r"stem_(\d)", r"stems.\1"),
    (r"(cls|reg)_conv_(\d)_(\d)", r"\1_convs.\2.\3"),
    (r"(cls|reg|obj)_pred_(\d)", r"\1_preds.\2"),
)


def _yolox_segment(seg: str) -> str:
    for pattern, repl in _YOLOX_SEGMENTS:
        if re.fullmatch(pattern, seg):
            return re.sub(pattern, repl, seg)
    return seg


def yolox_state_dict_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """busca_tpu YOLOX variables (``{'params': ..., 'batch_stats': ...}``
    as numpy) -> the port's (= the official YOLOX) state dict; the inverse
    of ``busca_tpu.models.yolox.convert_yolox_state_dict``.  Convolution
    kernels go from HWIO to OIHW."""
    out: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(coll, {})):
            leaf = path[-1]
            if leaf == "kernel":
                value, leaf = value.transpose(3, 2, 0, 1), "weight"
            key = ".".join([_yolox_segment(s) for s in path[:-1]] + [leaf])
            out[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    return out


# flax leaf names -> torch parameter and buffer names (BN: scale, mean, var)
_CT_LEAVES = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
              "var": "running_var"}
# DLABase's conv + BN + ReLU layers: the published nn.Sequential indices
_DLA_STEMS = ("base_layer", "pre_img_layer", "pre_hm_layer", "level0",
              "level1")
_DCN_BLOCK = re.compile(r"(proj|node)_\d+")


def _centertrack_key(path: Tuple[str, ...]) -> str:
    """A busca_tpu CenterTrackNet variable path -> the published DLASeg key
    (the MobileNetV2 backbone keeps busca_tpu's module names)."""
    *mods, leaf = path
    out = []
    for i, m in enumerate(mods):
        if i == 2 and mods[0] == "base" and mods[1] in _DLA_STEMS:
            m = {"conv": "0", "bn": "1"}[m]
        elif (mods[0] == "base" and re.fullmatch(r"level[2-5]", mods[1])
              and m in ("project_conv", "project_bn")):
            m = "project." + ("0" if m == "project_conv" else "1")
        elif i and _DCN_BLOCK.fullmatch(mods[i - 1]):
            m = "actf.0" if m == "bn" else "conv." + m
        elif i == 0 and re.fullmatch(r"(hm|reg|wh|tracking)_(conv|out)", m):
            head, part = m.rsplit("_", 1)
            m = f"{head}.{'0' if part == 'conv' else '2'}"
        out.append(m)
    if _DCN_BLOCK.fullmatch(mods[-1]):
        out.append("conv")  # the DCN's own weight and bias
    return ".".join(out + [_CT_LEAVES.get(leaf, leaf)])


def centertrack_state_dict_from_flax(variables: dict
                                     ) -> Dict[str, torch.Tensor]:
    """busca_tpu CenterTrackNet variables (``{'params': ...,
    'batch_stats': ...}`` as numpy) -> the port's
    :class:`~busca_tpu_torch.models.centertrack.CenterTrackNet` state dict,
    whose DLA keys are the published DLASeg's (the inverse of
    ``busca_tpu.models.convert.convert_centertrack_state_dict``).
    Convolution kernels go from HWIO to OIHW (a depthwise ``[3, 3, 1, C]``
    to ``[C, 1, 3, 3]``); an ``up_i`` kernel, which busca_tpu stores
    spatially flipped as the equivalent lhs-dilated depthwise convolution,
    is flipped back into the ``ConvTranspose2d`` weight ``[o, 1, 2f, 2f]``;
    BN ``scale``/``mean``/``var`` become ``weight``/``running_mean``/
    ``running_var``."""
    out: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(coll, {})):
            if value.ndim == 4:  # every convolution kernel, HWIO
                value = value.transpose(3, 2, 0, 1)
                if re.fullmatch(r"up_\d+", path[-2]):
                    value = value[:, :, ::-1, ::-1]
            out[_centertrack_key(path)] = torch.from_numpy(
                np.array(value, dtype=np.float32))
    return out


def load_into(model: torch.nn.Module, state_dict: Dict[str, torch.Tensor]):
    """Copy ``state_dict`` into ``model`` as busca_tpu overlays a checkpoint
    on its initial variables (``eval/run.py::build_engine``).  The ReID
    classifier heads are dropped, whatever their size, and keep their
    initial values; so do the learned tokens when the checkpoint lacks them.
    Every other parameter must be present; BN running statistics and
    bookkeeping buffers may be absent.  Unknown keys raise."""
    state_dict = {k: v for k, v in state_dict.items()
                  if not k.startswith(_REID_HEADS)}
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    params = {name for name, _ in model.named_parameters()}
    absent = [k for k in missing if k in params
              and not k.startswith(_REID_HEADS) and k not in _TOKENS]
    unexpected = [k for k in unexpected
                  if not k.endswith(("num_batches_tracked", "pad_token"))]
    if absent or unexpected:
        raise KeyError(f"checkpoint mismatch: missing {absent}, "
                       f"unexpected {unexpected}")
    return model


def load_checkpoint(model: torch.nn.Module, path: str):
    """Load ``.npz`` (flattened flax variables, ``/``-joined keys, as
    ``busca_tpu.models.checkpoint.save_params_npz`` writes them) or a
    reference ``.pth`` into ``model``."""
    if path.endswith(".npz"):
        from busca_tpu_torch.models.checkpoint import load_params_npz

        tree = load_params_npz(path)
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
