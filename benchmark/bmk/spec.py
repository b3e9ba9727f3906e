"""Find a cell's configuration, traffic mix and metric readers by name.

Everything that belongs to one configuration, mix or per-layer metric sits
in a file of its own (a configuration's models too: ``bmk/parts.py``), so a later change adds a cell by adding files and
entries, never by editing one that is there.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from typing import Callable, Dict, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # benchmark/


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(path: str = "BENCHMARK.json") -> dict:
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path} not found: run from the checkout's "
                                "root")
    return load_json(path)


def config_file(bench: dict, name: str) -> str:
    for c in bench["configs"]:
        if c["name"] == name:
            return c["file"]
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def mix_file(traffic: str) -> str:
    return os.path.join(HERE, "mixes", f"{traffic}.json")


def resolve_cell(bench: dict, workload: str):
    """``(cell, config, mix)`` of the workload named ``workload``: the cell's
    entry, the configuration's file and the mix's file, read."""
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            config = load_json(config_file(bench, cell["config"]))
            mix = load_json(mix_file(cell["traffic"]))
            return cell, config, mix
    raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")


def metrics_for(bench: dict, workload: str, kind: str):
    """The metric entries of ``kind`` (``end_to_end`` or ``per_layer``) that
    this cell reports: those without ``workloads`` and those that list it."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def load_file(path: str, prefix: str, name: str):
    """The module of the file ``path``, executed under a name made of
    ``prefix`` and ``name`` (registered, so dataclasses find it)."""
    mod_name = prefix + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> Callable:
    """``read(run)`` of ``benchmark/metrics/<name>.py``."""
    return load_file(os.path.join(HERE, "metrics", f"{name}.py"),
                     "bench_metric_", name).read


def read_per_layer(bench: dict, workload: str, run) -> Dict[str, dict]:
    """Each per-layer metric of the cell that its reader finds: a reader
    that finds nothing returns None and the metric stays out."""
    out = {}
    for m in metrics_for(bench, workload, "per_layer"):
        value: Optional[float] = metric_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
