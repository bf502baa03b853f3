"""The port stands alone: no file of ``src/repro_torch/``, and not
``chip_smoke.py``, imports JAX or the reference package ``repro``.

An AST scan covers every import statement (including ``importlib`` calls
with a literal name); a fresh interpreter that imports the port's front
door must end with neither ``jax`` nor ``repro`` in ``sys.modules``.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np  # noqa: F401  (the test files' shared import set)
import pytest
torch = pytest.importorskip("torch")

import jax  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                names.append(node.module)
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            names.append(node.args[0].value)
    return names


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_the_scan_sees_the_whole_port():
    rel = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"chip_smoke.py", "src/repro_torch/cfa.py",
            "src/repro_torch/core/cfa/transform.py",
            "src/repro_torch/kernels/stencil/stencil.py",
            "src/repro_torch/models/lm.py", "src/repro_torch/serve/scheduler.py",
            "src/repro_torch/launch/serve.py", "src/repro_torch/optim/optimizers.py",
            "src/repro_torch/optim/schedule.py", "src/repro_torch/train/steps.py",
            "src/repro_torch/train/loop.py", "src/repro_torch/checkpoint/manager.py",
            "src/repro_torch/data/pipeline.py", "src/repro_torch/launch/train.py"} <= rel
    # and it recognises every spelling of a forbidden import
    probe = ROOT / "src" / "repro_torch" / "cfa.py"
    names = _imported_modules(probe)
    assert "repro_torch.core.cfa" in names and not any(map(_forbidden, names))
    assert _forbidden("repro.core.cfa") and _forbidden("jax.numpy")
    assert not _forbidden("repro_torch.core.cfa")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_file_imports_neither_jax_nor_repro(path):
    bad = [n for n in _imported_modules(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.cfa, repro_torch.interop, repro_torch.kernels.stencil\n"
        "import repro_torch.models.lm, repro_torch.serve.scheduler, repro_torch.launch.serve\n"
        "import repro_torch.optim, repro_torch.train.steps, repro_torch.train.loop\n"
        "import repro_torch.checkpoint, repro_torch.data, repro_torch.launch.train\n"
        "from repro_torch.kernels import _build\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(ROOT))
    assert res.returncode == 0, res.stdout + res.stderr
