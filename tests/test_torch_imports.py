"""The PyTorch port imports cleanly and stands alone.

Every ``repro_torch`` module imports; after importing all of them no JAX
module and no module of the JAX package ``repro`` is loaded (checked in a
fresh interpreter); and no port file, nor ``chip_smoke.py``, names
``jax`` or ``repro`` in an import statement.
"""

import ast
import importlib
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
SRC = REPO / "src"
PORT = SRC / "repro_torch"


def _port_modules():
    mods = []
    for py in sorted(PORT.rglob("*.py")):
        parts = list(py.relative_to(SRC).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_every_port_package_dir_has_init():
    missing = [str(d.relative_to(SRC)) for d in sorted(PORT.rglob("*"))
               if d.is_dir() and d.name not in ("__pycache__", "csrc",
                                                "_build_out")
               and not (d / "__init__.py").exists()]
    assert not missing, f"packages without __init__.py: {missing}"


@pytest.mark.parametrize("mod", _port_modules())
def test_port_module_imports(mod):
    importlib.import_module(mod)


def test_port_loads_no_jax_and_no_reference_module():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(','.join(bad))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(SRC)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"loaded: {proc.stdout.strip()}"


def _imported_names(path: pathlib.Path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_jax_or_reference_package(path):
    bad = [name for name in _imported_names(path)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"
