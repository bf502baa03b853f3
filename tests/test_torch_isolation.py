"""The port stands alone: no file of ``src/repro_torch/``, and not
``chip_smoke.py``, imports JAX or the reference package ``repro``.

An AST scan covers every import statement (including ``importlib`` calls
with a literal name); a fresh interpreter that imports the port's front
door must end with neither ``jax`` nor ``repro`` in ``sys.modules``.

The port's layers point one way: the training and serving stack
(``models``, ``train``, ``optim``, ``data``, ``checkpoint``, ``serve``,
``distributed``, ``launch``, the LM kernels and their examples) never
imports the stencil compiler ``repro_torch.core``, and no kernel imports
``models``, ``train`` or ``serve``.  What they share (the device check, the
clock, the recorder hub; ``rms_norm`` and ``silu``) has one definition, in
``repro_torch.runtime`` and ``repro_torch.kernels.elementwise``.
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


# --------------------------------------------------------------------------
# the layers point one way
# --------------------------------------------------------------------------

PORT = ROOT / "src" / "repro_torch"
LM_STACK = sorted(
    [f for d in ("models", "train", "optim", "data", "checkpoint", "serve", "distributed",
                 "launch", "kernels/ssd", "kernels/block_attention", "kernels/mamba_gate")
     for f in (PORT / d).rglob("*.py")]
    + [PORT / "runtime.py", PORT / "kernels" / "elementwise.py"]
    + [PORT / "examples" / f"{n}.py" for n in ("train_lm", "serve_decode", "pipeline_parallel")])
KERNEL_FILES = sorted((PORT / "kernels").rglob("*.py"))


def _absolute_imports(path: Path) -> set[str]:
    """Every module a file imports, by its absolute name: relative imports
    resolved against the file's package, and ``from a import b`` counted as
    both ``a`` and ``a.b``."""
    package = ".".join(path.relative_to(ROOT / "src").with_suffix("").parts[:-1])
    names = set(_imported_modules(path))
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parent = package.split(".")[:len(package.split(".")) - node.level + 1]
                base = ".".join(parent + ([node.module] if node.module else []))
            names.add(base)
            names |= {f"{base}.{a.name}" for a in node.names}
    return names


def _under(name: str, package: str) -> bool:
    return name == package or name.startswith(package + ".")


def test_the_layer_scan_resolves_every_spelling():
    mods = _absolute_imports(PORT / "models" / "moe.py")
    assert {"repro_torch.runtime", "repro_torch.models.layers",
            "repro_torch.models.config.ArchConfig"} <= mods
    assert "repro_torch.kernels.elementwise" in _absolute_imports(
        PORT / "kernels" / "mamba_gate" / "ref.py")
    assert "repro_torch.kernels.ssd.ops" in _absolute_imports(
        PORT / "kernels" / "ssd" / "__init__.py")
    assert any(_under(n, "repro_torch.core") for n in _absolute_imports(PORT / "cfa.py"))
    assert {PORT / "models" / "lm.py", PORT / "train" / "loop.py",
            PORT / "kernels" / "mamba_gate" / "ref.py"} <= set(LM_STACK)


@pytest.mark.parametrize("path", LM_STACK, ids=lambda p: p.relative_to(PORT).as_posix())
def test_the_lm_stack_does_not_import_the_stencil_compiler(path):
    bad = sorted(n for n in _absolute_imports(path) if _under(n, "repro_torch.core"))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", KERNEL_FILES, ids=lambda p: p.relative_to(PORT).as_posix())
def test_no_kernel_imports_a_model_the_trainer_or_the_server(path):
    bad = sorted(n for n in _absolute_imports(path)
                 if any(_under(n, f"repro_torch.{p}") for p in ("models", "train", "serve")))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_runtime_imports_only_torch_and_the_standard_library():
    tops = {n.split(".")[0] for n in _absolute_imports(PORT / "runtime.py")}
    assert tops <= {"__future__", "contextlib", "time", "torch"}, tops


def test_the_training_and_serving_stack_loads_no_stencil_compiler_module():
    code = (
        "import sys\n"
        "import repro_torch.train.loop, repro_torch.serve.scheduler, repro_torch.launch.train\n"
        "print(sorted(m for m in sys.modules if m.split('.')[:2] == ['repro_torch', 'core']))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]", res.stdout


@pytest.mark.parametrize("where, name, home", [
    ("repro_torch.core.cfa.obs", "active", "repro_torch.runtime"),
    ("repro_torch.core.cfa.obs", "train_span", "repro_torch.runtime"),
    ("repro_torch.core.cfa.obs", "NO_SPAN", "repro_torch.runtime"),
    ("repro_torch.core.cfa.obs", "now", "repro_torch.runtime"),
    ("repro_torch.core.cfa.api", "resolve_device", "repro_torch.runtime"),
    ("repro_torch.models.layers", "rms_norm", "repro_torch.kernels.elementwise"),
    ("repro_torch.models.layers", "silu", "repro_torch.kernels.elementwise"),
])
def test_a_shared_name_is_one_object_wherever_it_is_named(where, name, home):
    import importlib

    assert getattr(importlib.import_module(where), name) is \
        getattr(importlib.import_module(home), name)
    assert name in importlib.import_module(where).__all__


def _definitions(path: Path, name: str) -> int:
    """Module-level ``def name`` / ``name = ...`` statements of a file."""
    n = 0
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and node.name == name:
            n += 1
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            n += any(isinstance(t, ast.Name) and t.id == name for t in targets)
    return n


@pytest.mark.parametrize("name", ["resolve_device", "now", "install", "active", "train_span",
                                  "NO_SPAN", "rms_norm", "silu", "_ssd_bound"])
def test_a_shared_name_has_one_definition(name):
    where = [p.relative_to(ROOT).as_posix() for p in PORT_FILES
             for _ in range(_definitions(p, name))]
    assert len(where) == 1, where
