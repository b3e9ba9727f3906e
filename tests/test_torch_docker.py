"""Structural checks of the port's container recipe (``Dockerfile.cuda``,
``Dockerfile.cuda.dockerignore``, ``docker/build_torch.sh``,
``docker/run_serve_torch.sh``), as ``tests/test_docker.py`` checks the JAX
package's: no image is built here (a build downloads its base image and
wheels), so this pins what can be checked without one.  Every COPY source
exists, the ignore file keeps host-built libraries out, the recipe prebuilds
the kernels from the installed package, its smoke is a CLI run that a test
here runs for real, its entry point is a port console script, its torch pin
is docs/DEPLOY_TORCH.md's and it installs no jax."""

import os
import re
import shlex
import subprocess
import tomllib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(*path):
    with open(os.path.join(REPO, *path)) as f:
        return f.read()


def _runs(df):
    """The RUN instructions, continuation lines joined."""
    return [re.sub(r"\\\n\s*", " ", m.group(1)) for m in re.finditer(
        r"^RUN\s+((?:.*\\\n)*.*)$", df, re.M)]


def _scripts():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


def _smoke_argv():
    """The build smoke's console script and arguments."""
    (smoke,) = [r for r in _runs(_read("Dockerfile.cuda"))
                if r.startswith("busca-torch-track")]
    argv = shlex.split(smoke.split("&&")[0])
    return argv[0], argv[1:]


def test_copy_sources_exist():
    df = _read("Dockerfile.cuda")
    copies = re.findall(r"^COPY\s+(.+?)\s+\S+$", df, re.M)
    assert copies
    for sources in copies:
        for src in sources.split():
            assert os.path.exists(os.path.join(REPO, src)), src


def test_ignore_file_keeps_host_builds_out():
    ignore = _read("Dockerfile.cuda.dockerignore").split()
    for pattern in ("busca_tpu_torch/_build/", "native/*.so", "native/*.o",
                    ".jax_cache/", "chiprun_out/", "scratch_chip/",
                    "__pycache__/"):
        assert pattern in ignore, pattern


def test_recipe_installs_and_prebuilds_the_package():
    runs = _runs(_read("Dockerfile.cuda"))
    install = [r for r in runs
               if "pip install --no-cache-dir --no-deps ." in r]
    assert len(install) == 1
    # the source copy goes, so the prebuild reads the installed package
    assert "rm -rf busca_tpu_torch" in install[0]
    build = runs.index("python -m busca_tpu_torch.ops.cuda_build")
    assert runs.index(install[0]) < build < runs.index(
        next(r for r in runs if r.startswith("busca-torch-track")))


def test_entrypoint_is_a_port_console_script():
    df = _read("Dockerfile.cuda")
    m = re.search(r'^ENTRYPOINT \["([\w-]+)"\]$', df, re.M)
    assert m and m.group(1) == "busca-torch-serve"
    assert _scripts()[m.group(1)].startswith("busca_tpu_torch.")


def test_torch_pin_matches_deploy_doc():
    df = _read("Dockerfile.cuda")
    version = re.search(r"^ARG TORCH_VERSION=([\d.]+)$", df, re.M).group(1)
    index = re.search(r"^ARG TORCH_INDEX_URL=(\S+)$", df, re.M).group(1)
    assert '"torch==${TORCH_VERSION}"' in df
    deploy = _read("docs", "DEPLOY_TORCH.md")
    assert f"torch=={version}" in deploy
    assert index in deploy


def test_no_jax_installed():
    for run in _runs(_read("Dockerfile.cuda")):
        if "pip install" in run:
            words = set(re.findall(r"[\w.\[\]-]+", run))
            assert not words & {"jax", "jaxlib", "flax", "optax",
                                "orbax-checkpoint"}, run
            assert not re.search(r"\bjax\[", run), run


def test_helper_scripts_are_valid_bash():
    for name in ("build_torch.sh", "run_serve_torch.sh"):
        path = os.path.join(REPO, "docker", name)
        assert os.access(path, os.X_OK), f"{name} not executable"
        subprocess.run(["bash", "-n", path], check=True)
    assert "-f Dockerfile.cuda" in _read("docker", "build_torch.sh")
    assert "--gpus all" in _read("docker", "run_serve_torch.sh")


def test_smoke_is_the_tested_cli(tmp_path, capsys):
    """The image's smoke, run here through the same console-script
    function: it must return 0 (a console script exits with it) after
    printing the synthetic A/B's metrics."""
    import importlib
    import json

    import torch

    name, argv = _smoke_argv()
    assert argv == ["--synthetic", "--device", "cpu", "--num-frames", "8",
                    "--output-dir", "/tmp/smoke"]
    module, func = _scripts()[name].split(":")
    entry = getattr(importlib.import_module(module), func)
    out = tmp_path / "smoke"
    argv[argv.index("/tmp/smoke")] = str(out)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert entry(argv) == 0
    finally:
        torch.set_num_threads(threads)
    metrics = json.loads(capsys.readouterr().out)
    assert 0.0 < metrics["base"]["mota"] <= 1.0
