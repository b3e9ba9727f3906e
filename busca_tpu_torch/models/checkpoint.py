"""Checkpoints: train-state files, and portable parameter files.

- ``save_checkpoint`` / ``restore_checkpoint``: the train state
  ``{"params", "opt_state", "step"}`` (:func:`train_state`: the model's and
  the optimizer's state dicts) under ``<directory>/step_%08d``, the latest
  step found by name, as ``busca_tpu.models.checkpoint`` lays out its orbax
  checkpoints.  The file is the port's own: one ``torch.save``, read back
  with ``torch.load(..., weights_only=True)`` (tensors, numbers and
  containers only).
- ``save_params_npz`` / ``load_params_npz``: the port's copy of busca_tpu's
  flat-key ``.npz`` of a nested parameter tree (numpy only): the keys are
  the tree's path joined with ``/``, so a file written by either package
  reads in the other.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def _flatten(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}" if not prefix else f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_params_npz(path: str, params: dict):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **_flatten(params))


def load_params_npz(path: str) -> dict:
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})


def train_state(model, optimizer, step: int) -> dict:
    """``{"params", "opt_state", "step"}`` of a training run."""
    return {"params": model.state_dict(), "opt_state": optimizer.state_dict(),
            "step": int(step)}


def save_checkpoint(directory: str, state: dict, step: int = 0) -> str:
    """Write ``state`` to ``<directory>/step_%08d`` (through a temporary
    file and a rename, so a checkpoint is whole or absent); returns the
    path."""
    import torch

    os.makedirs(directory, exist_ok=True)
    path = os.path.abspath(os.path.join(directory, f"step_{step:08d}"))
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(directory: str, step: Optional[int] = None) -> dict:
    """Read the given (or the latest) step's checkpoint from ``directory``
    onto the CPU (``load_state_dict`` copies it to the parameters' device)."""
    import torch

    if step is None:
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        step = steps[-1]
    path = os.path.abspath(os.path.join(directory, f"step_{step:08d}"))
    return torch.load(path, map_location="cpu", weights_only=True)
