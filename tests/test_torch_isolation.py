"""PyTorch port: the package stands alone.  Neither it nor ``chip_smoke.py``
imports ``jax`` or the JAX package, no file of the package names either,
and the entry points take the CUDA card unless the caller asks for the
CPU."""

from __future__ import annotations

import os
import re
import subprocess
import sys

import pytest
import torch

from bikg_graph_explainability_public_tpu_torch.utils.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "bikg_graph_explainability_public_tpu_torch"


def _package_files():
    for dirpath, _, files in os.walk(os.path.join(ROOT, PKG)):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(dirpath, name)


def _modules():
    mods = []
    for path in _package_files():
        if path.endswith(".py"):
            rel = os.path.relpath(path, ROOT)[: -len(".py")].replace(os.sep, ".")
            mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    return sorted(mods)


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('jaxlib') or m == 'bikg_graph_explainability_public_tpu'"
        " or m.startswith('bikg_graph_explainability_public_tpu.'))\n"
        "assert not bad, bad\n"
        "assert 'pandas' not in sys.modules, 'pandas imported at module level'\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


IMPORTS_JAX = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|bikg_graph_explainability_public_tpu)\b", re.M
)
NAMES_JAX_PACKAGE = re.compile(r"bikg_graph_explainability_public_tpu(?!_torch)\b")
#: any import of jax in any form, including ``importlib.import_module("jax")``
#: and ``__import__``
LOADS_JAX = re.compile(r"""(import_module|__import__)\(\s*['"](jax|jaxlib)\b""")


def test_no_file_names_jax_or_the_jax_package():
    imports, names_jax_package = IMPORTS_JAX, NAMES_JAX_PACKAGE
    offenders = []
    for path in _package_files():
        with open(path) as f:
            text = f.read()
        if imports.search(text) or names_jax_package.search(text):
            offenders.append(os.path.relpath(path, ROOT))
    assert not offenders


def test_chip_smoke_imports_no_jax():
    """The card's machine has neither jax nor the JAX package: the script
    must not import them, in any form, at any depth of its functions."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        text = f.read()
    # it may name the JAX package's files (the kernels it replaces), but
    # imports nothing of it
    assert not IMPORTS_JAX.search(text)
    assert not LOADS_JAX.search(text)
    # and running its imports pulls in neither
    code = (
        "import sys, importlib.util\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'bikg_graph_explainability_public_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0 and proc.stdout.startswith("ok"), proc.stdout + proc.stderr


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_cuda_or_checkout(tmp_path, alone):
    """``chip_smoke.py`` exits non-zero and prints no result where there is
    no card, and where it stands without the rest of the repo."""
    if torch.cuda.is_available():
        pytest.skip("with a card the script runs the whole smoke test")
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        with open(script) as f:
            (tmp_path / "chip_smoke.py").write_text(f.read())
        script = str(tmp_path / "chip_smoke.py")
    proc = subprocess.run(
        [sys.executable, script], cwd=os.path.dirname(script),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
