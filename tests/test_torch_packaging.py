"""The port's packaging: the wheel built from ``pyproject.toml`` carries the
kernels' and LAPJV's sources (``busca_tpu_torch/csrc/``) and nothing
host-built (``_build/``); its console scripts are busca_tpu's six, unchanged,
and the port's five; an installed copy outside the repository builds its
native LAPJV from the sources it ships; and each ``busca-torch-*`` script's
``--help`` exits 0 without importing jax.

The wheel is built from a copy of the tree under ``tmp_path``: an in-tree
build writes ``build/`` and ``*.egg-info`` into the repository.  pip runs
with ``--no-index`` and no build isolation, so nothing is downloaded.
"""

import configparser
import json
import os
import shutil
import subprocess
import sys
import tomllib
import zipfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIP = [sys.executable, "-m", "pip", "--disable-pip-version-check",
       "--no-cache-dir"]

JAX_SCRIPTS = {
    "busca-track": "busca_tpu.eval.run:main",
    "busca-convert": "busca_tpu.models.convert:main",
    "busca-export": "busca_tpu.serve.export:main",
    "busca-serve": "busca_tpu.serve.server:main",
    "busca-golden": "busca_tpu.eval.golden:main",
    "busca-sample-files": "busca_tpu.utils.sample_files:main",
}
TORCH_SCRIPTS = {
    "busca-torch-track": "busca_tpu_torch.cli:track",
    "busca-torch-serve": "busca_tpu_torch.cli:serve",
    "busca-torch-export": "busca_tpu_torch.cli:export",
    "busca-torch-golden": "busca_tpu_torch.cli:golden",
    "busca-torch-sample-files": "busca_tpu_torch.cli:sample_files",
}
SOURCES = ("busca_tpu_torch/csrc/crop_resize.cu",
           "busca_tpu_torch/csrc/local_tap_sum.cu",
           "busca_tpu_torch/csrc/lapjv.cc")

# run in a subprocess: the installed entry point named argv[1], as its
# console script calls it, with --help; prints the exit code and whether
# jax was imported
HELP_CHECK = """
import json, sys
from importlib.metadata import entry_points
(ep,) = entry_points(group="console_scripts", name=sys.argv[1])
fn = ep.load()
sys.argv = [sys.argv[1], "--help"]
try:
    rc = fn()
except SystemExit as e:
    rc = e.code
print(json.dumps({"rc": rc, "module": fn.__module__,
                  "jax": "jax" in sys.modules}))
"""


def _env(pythonpath):
    env = dict(os.environ, PYTHONPATH=pythonpath, PIP_NO_INDEX="1")
    env.pop("PYTHONSTARTUP", None)
    return env


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    """A wheel of ``pyproject.toml`` and both packages, built from a copy;
    the copy holds a stand-in host-built library under ``_build/``."""
    root = tmp_path_factory.mktemp("packaging")
    src = root / "src"
    src.mkdir()
    shutil.copy(os.path.join(REPO, "pyproject.toml"), src)
    ignore = shutil.ignore_patterns("__pycache__", "*.pyc", "_build")
    for pkg in ("busca_tpu", "busca_tpu_torch"):
        shutil.copytree(os.path.join(REPO, pkg), src / pkg, ignore=ignore)
    built = src / "busca_tpu_torch" / "_build"
    built.mkdir()
    (built / "liblapjv.so").write_bytes(b"host-built")
    out = subprocess.run(
        PIP + ["wheel", "--no-deps", "--no-build-isolation", "--no-index",
               "-w", str(root / "dist"), str(src)],
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    (whl,) = (root / "dist").glob("*.whl")
    return whl


@pytest.fixture(scope="module")
def installed(wheel, tmp_path_factory):
    """The wheel installed (no dependencies) into a directory outside the
    repository: ``(site directory, its bin directory)``."""
    site = tmp_path_factory.mktemp("site")
    out = subprocess.run(
        PIP + ["install", "--no-deps", "--no-index", "--target", str(site),
               str(wheel)],
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    return str(site), str(site / "bin")


def test_wheel_carries_sources_not_builds(wheel):
    names = zipfile.ZipFile(wheel).namelist()
    for path in SOURCES:
        assert path in names, path
    assert not [n for n in names if "/_build/" in n]
    assert not [n for n in names if n.endswith((".so", ".o", ".pyc"))]


def test_wheel_console_scripts(wheel):
    with zipfile.ZipFile(wheel) as z:
        (ep,) = [n for n in z.namelist() if n.endswith("entry_points.txt")]
        parser = configparser.ConfigParser()
        parser.optionxform = str
        parser.read_string(z.read(ep).decode())
    assert dict(parser["console_scripts"]) == {**JAX_SCRIPTS,
                                               **TORCH_SCRIPTS}
    # busca_tpu's six lines stand in pyproject.toml as they were
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        text = f.read()
    for name, target in JAX_SCRIPTS.items():
        assert f'{name} = "{target}"\n' in text
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts == {**JAX_SCRIPTS, **TORCH_SCRIPTS}


def test_lapjv_source_is_busca_tpus():
    with open(os.path.join(REPO, "native", "lapjv.cc"), "rb") as f:
        want = f.read()
    with open(os.path.join(REPO, "busca_tpu_torch", "csrc", "lapjv.cc"),
              "rb") as f:
        assert f.read() == want


def test_installed_copy_builds_native_lapjv(installed):
    """The installed package builds its LAPJV with g++ from the source the
    wheel carries, into its own ``_build/``, and solves with it (not
    scipy's fallback)."""
    site, _ = installed
    code = (
        "import json, numpy as np\n"
        "from busca_tpu_torch.ops import lap\n"
        "lib = lap._load_native()\n"
        "x, y, c = lap.linear_assignment(np.array([[1.0, 9.0], [9.0, 2.0],"
        " [5.0, 5.0]]), 6.0)\n"
        "print(json.dumps({'native': lib is not None, 'lib': lap._LIB_PATH,"
        " 'source': lap._SOURCE, 'matches': np.asarray(x).tolist()}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=site,
                         env=_env(site), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["native"], "the installed copy fell back to scipy"
    for key in ("lib", "source"):
        assert got[key].startswith(site + os.sep), got[key]
    assert os.path.exists(got["lib"])
    assert got["matches"] == [[0, 0], [1, 1]]


def test_console_scripts_help_without_jax(installed):
    """Each installed ``busca-torch-*`` entry point, loaded from the wheel's
    metadata, exits 0 on ``--help`` in its own process, which ends without
    having imported jax; the generated script file runs too."""
    site, bin_dir = installed
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", HELP_CHECK, name], cwd=site, env=_env(site),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in TORCH_SCRIPTS}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=120)
        assert proc.returncode == 0, stderr
        got = json.loads(stdout.strip().splitlines()[-1])
        assert got == {"rc": 0, "module": "busca_tpu_torch.cli",
                       "jax": False}, (name, got)
    out = subprocess.run(
        [os.path.join(bin_dir, "busca-torch-sample-files"), "--help"],
        cwd=site, env=_env(site), capture_output=True, text=True,
        timeout=60)
    assert out.returncode == 0, out.stderr
    assert "--num-files" in out.stdout
