"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each kernel source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, in the package's gitignored ``_build/``
directory, named by the source's content hash; it is loaded with ctypes.
Nothing here runs at import time, so importing a kernel's wrapper needs
neither CUDA nor a compiler.

    python -m busca_tpu_torch.ops.cuda_build

prebuilds every library the port loads (K1, K2 and the LAPJV solver), for
an installed package or an image: no GPU is needed, only nvcc and g++.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Callable, Optional, Sequence, Tuple

# the kernels' builds and the exports' traces, at INFO
# (utils/profiling.py::log_compile_times turns it on)
COMPILE_LOG = logging.getLogger("busca_tpu_torch.compile")
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no contracted multiply-adds: float32 rounding equals the plain version
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # the register and spill report
]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "CUDA host")
    return path


class CudaLibrary:
    """One kernel source and its built library.

    Args:
      source: file name under ``csrc/``.
      declare: sets ``argtypes``/``restype`` of the library's entry points.
      defines: ``NAME=VALUE`` macros passed to nvcc as ``-D`` (variants of
        a kernel built for measurement; the ops use none).
    """

    def __init__(self, source: str, declare: Callable[[ctypes.CDLL], None],
                 defines: Sequence[str] = ()):
        self.source = os.path.join(CSRC_DIR, source)
        self.stem = os.path.splitext(source)[0]
        self.defines = tuple(defines)
        self._declare = declare
        self._lib = None

    def library_path(self) -> str:
        """The built library's path, keyed by the source's content hash and
        the defines."""
        with open(self.source, "rb") as f:
            digest = hashlib.sha1(f.read() + repr(self.defines).encode())
        return os.path.join(BUILD_DIR,
                            f"lib{self.stem}_{digest.hexdigest()[:12]}.so")

    def build(self) -> Tuple[float, str]:
        """Compile the source with one ``nvcc``; returns the seconds it took
        and the ptxas report.  Raises if nvcc fails."""
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in self.defines),
                 "-o", tmp, self.source], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc {os.path.basename(self.source)} "
                                   f"failed ({proc.returncode}):\n"
                                   f"{proc.stderr}")
            os.replace(tmp, self.library_path())
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        seconds = time.perf_counter() - t0
        COMPILE_LOG.info("nvcc %s: %.2f s", os.path.basename(self.source),
                         seconds)
        return seconds, proc.stderr.strip()

    def load(self) -> ctypes.CDLL:
        """The library, built first unless this source already is."""
        if self._lib is None:
            if not os.path.exists(self.library_path()):
                self.build()
            lib = ctypes.CDLL(self.library_path())
            self._declare(lib)
            self._lib = lib
        return self._lib


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Build K1 and K2 (one nvcc each) and the LAPJV solver (g++), all
    started together, into the package's ``_build/``; prints each
    library's path, seconds and compiler report.  Returns 1 if any build
    failed, else 0.  Touches no GPU: nvcc compiles for ``sm_90a`` without
    one."""
    import argparse
    from concurrent.futures import ThreadPoolExecutor

    from busca_tpu_torch.ops import crop_cuda, lap, lma_cuda

    argparse.ArgumentParser(description=main.__doc__).parse_args(argv)
    builds = {"K1": (crop_cuda.LIBRARY.build,
                     crop_cuda.LIBRARY.library_path()),
              "K2": (lma_cuda.LIBRARY.build, lma_cuda.LIBRARY.library_path()),
              "LAPJV": (lap.build, lap._LIB_PATH)}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        futures = {tag: pool.submit(build)
                   for tag, (build, _) in builds.items()}
    failed = 0
    for tag, future in futures.items():
        try:
            seconds, report = future.result()
        except (RuntimeError, OSError) as e:  # a compiler failed or is missing
            print(f"{tag} build failed: {e}", file=sys.stderr)
            failed += 1
            continue
        print(f"{tag} build: {seconds:.2f} s ({builds[tag][1]})")
        if report:
            print(report)
    print(f"builds in parallel: {time.perf_counter() - t0:.2f} s")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
