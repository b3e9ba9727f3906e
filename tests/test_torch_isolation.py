"""busca_tpu_torch and chip_smoke.py stand alone: no jax, flax or busca_tpu.

The port installs on a GPU host with torch, numpy and scipy only, so it
keeps its own copies of what it needs from the JAX package, even of modules
there that are numpy-only.
"""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "busca_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "busca_tpu")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_import_with_jax_and_busca_tpu_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None  # any import of it raises\n"
        "import busca_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    busca_tpu_torch.__path__, 'busca_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print(len(mods))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{os.path.relpath(path, REPO)}:{node.lineno} imports {name}"
            )


def test_chip_smoke_refuses_without_cuda_or_package(tmp_path):
    """Without a card it exits non-zero and prints no result; copied alone
    into an empty directory it cannot find the port."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
