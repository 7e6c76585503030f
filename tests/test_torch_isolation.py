"""The port stands alone: nothing in ``nnstreamer_tpu_torch/`` or in
``chip_smoke.py`` imports JAX, flax or the JAX package, and importing the
port (every module of it) loads none of them."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "nnstreamer_tpu_torch"
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "nnstreamer_tpu")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in _FORBIDDEN


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            # lazy registrations and import_module name modules as strings
            # ("pkg.module:attr")
            target = node.value.partition(":")[0]
            if all(p.isidentifier() for p in target.split(".")) and _forbidden(target):
                bad.append(node.value)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import nnstreamer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import nnstreamer_tpu_torch.pipeline as pl\n"
        "pl.parse_pipeline('appsrc ! tensor_filter model=x ! tensor_decoder "
        "mode=image_labeling ! tensor_sink')\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {_FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
