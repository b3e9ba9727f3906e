"""The port's kernel build helper (busca_tpu_torch/ops/cuda_build.py), with
nvcc stubbed: runs on the CPU."""

import os
import subprocess

from busca_tpu_torch.ops import cuda_build
from busca_tpu_torch.ops.cuda_build import CudaLibrary


def test_defines_reach_nvcc_and_key_the_library(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    commands = []

    def fake_run(cmd, **kwargs):
        commands.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"built")
        return subprocess.CompletedProcess(cmd, 0, "", "ptxas info")

    monkeypatch.setattr(cuda_build.subprocess, "run", fake_run)
    plain = CudaLibrary("crop_resize.cu", lambda lib: None)
    variant = CudaLibrary("crop_resize.cu", lambda lib: None,
                          defines=("K1_NO_READS=1",))
    assert plain.library_path() != variant.library_path()
    for lib in (plain, variant):
        _, report = lib.build()
        assert report == "ptxas info"
        assert os.path.exists(lib.library_path())
    assert not any(arg.startswith("-D") for arg in commands[0])
    assert "-DK1_NO_READS=1" in commands[1]
    assert commands[1][-1] == variant.source
    assert "-fmad=false" in commands[0] and "-fmad=false" in commands[1]
