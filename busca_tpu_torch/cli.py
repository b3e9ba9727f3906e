"""The port's console scripts (``pyproject.toml`` ``[project.scripts]``).

An installed console script runs ``sys.exit(target())``.  The CLIs'
``main`` functions return their results to Python callers (the eval CLI
its per-sequence metrics, the exporter its manifest), which ``sys.exit``
would print to stderr and turn into exit status 1; so each script here runs
its CLI's ``main`` and returns 0.  A failing CLI still exits non-zero
(argparse's ``SystemExit(2)``, an uncaught exception).  ``python -m
<module>`` runs the same ``main``.

Each module is imported when its script runs: ``busca-torch-sample-files
--help`` imports no torch.
"""

from __future__ import annotations

import importlib
from typing import Optional, Sequence


def _run(module: str, argv: Optional[Sequence[str]]) -> int:
    importlib.import_module(module).main(argv)
    return 0


def track(argv: Optional[Sequence[str]] = None) -> int:
    """``busca-torch-track``: :func:`busca_tpu_torch.eval.run.main`."""
    return _run("busca_tpu_torch.eval.run", argv)


def serve(argv: Optional[Sequence[str]] = None) -> int:
    """``busca-torch-serve``: :func:`busca_tpu_torch.serve.server.main`."""
    return _run("busca_tpu_torch.serve.server", argv)


def export(argv: Optional[Sequence[str]] = None) -> int:
    """``busca-torch-export``: :func:`busca_tpu_torch.serve.export.main`."""
    return _run("busca_tpu_torch.serve.export", argv)


def golden(argv: Optional[Sequence[str]] = None) -> int:
    """``busca-torch-golden``: :func:`busca_tpu_torch.eval.golden.main`."""
    return _run("busca_tpu_torch.eval.golden", argv)


def sample_files(argv: Optional[Sequence[str]] = None) -> int:
    """``busca-torch-sample-files``:
    :func:`busca_tpu_torch.utils.sample_files.main`."""
    return _run("busca_tpu_torch.utils.sample_files", argv)
