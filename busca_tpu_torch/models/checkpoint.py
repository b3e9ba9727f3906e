"""Portable parameter files: flat-key ``.npz`` of a nested parameter tree.

The port's copy of ``save_params_npz`` / ``load_params_npz`` from
``busca_tpu.models.checkpoint`` (numpy only, no orbax): the keys are the
tree's path joined with ``/``, so a file written by either package reads in
the other.
"""

from __future__ import annotations

import os
from typing import Dict

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
