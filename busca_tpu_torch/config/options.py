"""Config system: reference-YAML compatible loading + CLI override merge
(port of ``busca_tpu.config.options``; PyYAML is imported where a YAML is
read).

Drop-in semantics of ``busca/option.py``: a YAML with four sections
(``transformer`` / ``tracker`` / ``trainer`` / ``dataset``) is parsed into
namespaces, with the transformer namespace spliced into the tracker and
trainer namespaces (option.py:6-20); explicit CLI values override YAML values
(``merge_args``, option.py:23-39).  The reference's shipped YAMLs under
``config/*/*/*.yml`` load unchanged.

``load_tracker_bundle`` additionally materializes the typed configs of this
framework (BuscaConfig + ByteTrackerConfig) from the same YAML.
"""

from __future__ import annotations

import copy
import types
from typing import Optional, Tuple

from busca_tpu_torch.models.busca import BuscaConfig


def load_args_from_config(config_file: str):
    """YAML -> (tracker_args, trainer_args) SimpleNamespaces
    (= busca/option.py:6-20)."""
    import yaml

    with open(config_file, "r") as stream:
        args = yaml.safe_load(stream)

    tracker_args = types.SimpleNamespace(**args.get("tracker", {}))
    trainer_args = types.SimpleNamespace(**args.get("trainer", {}))
    transformer_args = types.SimpleNamespace(**args.get("transformer", {}))
    dataset_args = types.SimpleNamespace(**args.get("dataset", {}))

    tracker_args.transformer = transformer_args
    trainer_args.transformer = transformer_args
    trainer_args.dataset = dataset_args
    return tracker_args, trainer_args


def merge_args(base_args, new_args, verbose: bool = False):
    """Override base namespace fields with non-None new fields
    (= busca/option.py:23-39)."""
    base_args = copy.deepcopy(base_args)
    for key, value in vars(new_args).items():
        if key in vars(base_args) and value is not None:
            if verbose:
                print(f"Overriding {key} from {getattr(base_args, key)} to {value}")
            setattr(base_args, key, value)
        elif key not in vars(base_args):
            setattr(base_args, key, value)
            if verbose:
                print(f"Setting {key} to {value}")
    return base_args


def busca_config_from_transformer_args(t) -> BuscaConfig:
    """Map the YAML transformer section onto :class:`BuscaConfig`."""
    d = dict(vars(t)) if not isinstance(t, dict) else dict(t)
    d.pop("reid_weights_file", None)
    d.pop("transformer", None)
    return BuscaConfig.from_dict(d)


def load_tracker_bundle(config_file: str, overrides: Optional[dict] = None):
    """Load a reference YAML into this framework's typed configs.

    Returns (tracker_args namespace, BuscaConfig, tracker_kwargs dict) where
    tracker_kwargs holds the knobs consumed by the tracker strategies
    (ByteTrackerConfig fields and friends).
    """
    tracker_args, _ = load_args_from_config(config_file)
    if overrides:
        tracker_args = merge_args(
            tracker_args, types.SimpleNamespace(**overrides)
        )
    busca_cfg = busca_config_from_transformer_args(tracker_args.transformer)

    tracker_keys = {
        "track_thresh",
        "track_buffer",
        "match_thresh",
        "mot20",
        "use_busca",
        "busca_thresh",
        "seq_len",
        "num_candidates",
        "use_broader_memory",
        "select_highest_candidate",
        "highest_candidate_minimum_thresh",
        "transformer_update_mems_only_first_round",
        "reliable_thresh",
        "use_camera_motion_compensation",
    }
    tracker_kwargs = {
        k: v for k, v in vars(tracker_args).items() if k in tracker_keys
    }
    return tracker_args, busca_cfg, tracker_kwargs
