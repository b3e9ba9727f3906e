"""Linear assignment on the host: native C++ LAPJV with a scipy fallback
(port of ``busca_tpu.ops.lap``).

- ``linear_assignment`` = ByteTrack's ``matching.linear_assignment``
  (``lap.lapjv`` with ``extend_cost=True, cost_limit=thresh``): rectangular
  problems are embedded in an ``(n+m)`` square matrix whose dummy entries
  cost ``cost_limit / 2``, dummy-dummy pairs cost 0.
- ``solve_dense`` = ``lapsolver.solve_dense``: rectangular min-cost matching
  that matches the most pairs first; non-finite entries are forbidden pairs.

The native solver is compiled with g++ from the package's own
``csrc/lapjv.cc`` (a copy of busca_tpu's ``native/lapjv.cc``, shipped in the
wheel) into the package's gitignored ``_build/`` directory on first use or by
``python -m busca_tpu_torch.ops.cuda_build``; without a compiler, scipy's
``linear_sum_assignment`` gives the same optima (tie-breaking may differ).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import time
from typing import Optional, Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG_DIR, "csrc", "lapjv.cc")
_LIB_PATH = os.path.join(_PKG_DIR, "_build", "liblapjv.so")

# Large finite stand-in for +inf (the solver requires finite arithmetic).
BIG = 1e15

_lib: Optional[ctypes.CDLL] = None
_lib_attempted = False


def build() -> Tuple[float, str]:
    """g++ the solver into a temporary file, then move it into place (safe
    against concurrent builders); returns the seconds it took and g++'s
    report.  Raises ``RuntimeError`` if g++ fails."""
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_LIB_PATH))
    os.close(fd)
    try:
        proc = subprocess.run(
            ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", _SOURCE,
             "-o", tmp],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"g++ lapjv.cc failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return time.perf_counter() - t0, proc.stderr.strip()


def _load_native() -> Optional[ctypes.CDLL]:
    global _lib, _lib_attempted
    if _lib is not None or _lib_attempted:
        return _lib
    _lib_attempted = True
    try:
        if not os.path.exists(_LIB_PATH):
            if not os.path.exists(_SOURCE):
                return None
            build()
        lib = ctypes.CDLL(_LIB_PATH)
        lib.lapjv_dense.restype = ctypes.c_double
        lib.lapjv_dense.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
    except (OSError, RuntimeError):
        _lib = None
    return _lib


def _solve_square(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray, float]:
    """Solve a square dense LAP. Returns (x, y, total_cost)."""
    n = cost.shape[0]
    if n == 0:
        return np.empty(0, np.int32), np.empty(0, np.int32), 0.0
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    lib = _load_native()
    if lib is not None:
        x = np.empty(n, dtype=np.int32)
        y = np.empty(n, dtype=np.int32)
        total = lib.lapjv_dense(
            cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n,
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return x, y, float(total)
    # scipy fallback — same optimum.
    from scipy.optimize import linear_sum_assignment

    rows, cols = linear_sum_assignment(cost)
    x = np.full(n, -1, dtype=np.int32)
    y = np.full(n, -1, dtype=np.int32)
    x[rows] = cols
    y[cols] = rows
    return x, y, float(cost[rows, cols].sum())


def lapjv(
    cost: np.ndarray,
    extend_cost: bool = True,
    cost_limit: float = np.inf,
) -> Tuple[float, np.ndarray, np.ndarray]:
    """``lap.lapjv``-compatible interface.

    Returns (total_cost, x, y) where ``x[i]`` is the column assigned to row i
    (-1 if unassigned) and ``y[j]`` the row assigned to column j.
    """
    cost = np.asarray(cost, dtype=np.float64)
    n, m = cost.shape
    cost = np.where(np.isfinite(cost), cost, BIG)

    if not np.isfinite(cost_limit):
        if n != m and not extend_cost:
            raise ValueError("rectangular problem requires extend_cost=True")
        size = max(n, m)
        cc = np.zeros((size, size), dtype=np.float64)
        cc[:n, :m] = cost
        x_sq, y_sq, _ = _solve_square(cc)
        x = np.where(x_sq[:n] < m, x_sq[:n], -1).astype(np.int32)
        y = np.where(y_sq[:m] < n, y_sq[:m], -1).astype(np.int32)
        total = float(sum(cost[i, x[i]] for i in range(n) if x[i] >= 0))
        return total, x, y

    # cost_limit embedding (matches lap's cc construction: every dummy pair
    # costs cost_limit/2, dummy-dummy pairs cost 0).
    size = n + m
    cc = np.full((size, size), cost_limit / 2.0, dtype=np.float64)
    cc[:n, :m] = cost
    cc[n:, m:] = 0.0
    x_sq, y_sq, _ = _solve_square(cc)
    x = np.where(x_sq[:n] < m, x_sq[:n], -1).astype(np.int32)
    y = np.where(y_sq[:m] < n, y_sq[:m], -1).astype(np.int32)
    total = float(sum(cost[i, x[i]] for i in range(n) if x[i] >= 0))
    return total, x, y


def linear_assignment(
    cost_matrix: np.ndarray, thresh: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ByteTrack-style thresholded assignment (matching.py:39-50).

    Returns (matches ``[K, 2]``, unmatched_rows, unmatched_cols).
    """
    cost_matrix = np.asarray(cost_matrix)
    if cost_matrix.size == 0:
        return (
            np.empty((0, 2), dtype=int),
            np.arange(cost_matrix.shape[0]),
            np.arange(cost_matrix.shape[1]),
        )
    _, x, y = lapjv(cost_matrix, extend_cost=True, cost_limit=thresh)
    matches = np.array([[i, xi] for i, xi in enumerate(x) if xi >= 0], dtype=int)
    if matches.size == 0:
        matches = np.empty((0, 2), dtype=int)
    unmatched_a = np.where(x < 0)[0]
    unmatched_b = np.where(y < 0)[0]
    return matches, unmatched_a, unmatched_b


def solve_dense(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``lapsolver.solve_dense``-compatible: rectangular min-cost matching.

    Non-finite (inf/nan) entries are forbidden pairs.  Returns (rows, cols).
    """
    cost = np.asarray(cost, dtype=np.float64)
    n, m = cost.shape
    if n == 0 or m == 0:
        return np.empty(0, dtype=int), np.empty(0, dtype=int)
    forbidden = ~np.isfinite(cost)
    size = max(n, m)
    # Expensive-edge values scaled to the data (motmetrics
    # lap.add_expensive_edges style), not a fixed 1e15: at 1e15 the float64
    # ulp is ~0.125, below which equal-cardinality assignments that differ
    # by ~1e-3 in real cost cannot be told apart.  DUMMY > 2*size*C makes
    # cardinality dominate any real-cost rearrangement; FORBID = 2*DUMMY
    # keeps forbidden pairs losing to unmatched lanes.
    c_abs = np.abs(cost[~forbidden]).max() if (~forbidden).any() else 0.0
    dummy = 2.0 * size * float(c_abs) + 1.0
    forbid = 2.0 * dummy
    work = np.where(forbidden, forbid, cost)
    cc = np.full((size, size), dummy, dtype=np.float64)
    cc[:n, :m] = work
    x, _, _ = _solve_square(cc)
    rows, cols = [], []
    for i in range(n):
        j = x[i]
        if 0 <= j < m and not forbidden[i, j]:
            rows.append(i)
            cols.append(j)
    return np.asarray(rows, dtype=int), np.asarray(cols, dtype=int)
