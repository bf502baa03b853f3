"""The port's doc guard (``python -m repro_torch.tools.check_doc_symbols``)
over the README's ``## PyTorch / H100 port`` section, and the reference
guard ``tools/check_doc_symbols.py`` over its docs.

* The port's guard exits 0 on the tree, in-process and as a module.
* On a copy of the tree, each fault makes it exit 1 and name the fault: the
  section naming a symbol no source has, the section naming a path nothing
  matches, and a name added to ``repro_torch.cfa.__all__`` that the section
  does not list.
* The reference guard, run unchanged in a subprocess, exits 0: the port's
  section stays within what it accepts.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np  # noqa: F401  (the test files' shared import set)
import pytest
torch = pytest.importorskip("torch")

from repro_torch.tools import check_doc_symbols

ROOT = Path(__file__).resolve().parents[1]
#: what the copy of the tree leaves out: nothing the guard reads
SKIP = shutil.ignore_patterns(".git", "build", "chiprun_out", "benchmarks", "__pycache__",
                              ".hypothesis", ".pytest_cache")
SECTION = "## PyTorch / H100 port\n"
#: a name no source holds (built here, so that this file does not hold it either)
MISSING = "no_such_" + "symbol_anywhere"


def _guard(root: Path) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.tools.check_doc_symbols"],
                          capture_output=True, text=True, timeout=300, env=env, cwd=str(root))


def test_the_port_guard_passes_on_the_tree(capsys):
    assert check_doc_symbols.main([]) == 0, capsys.readouterr().out
    assert "doc symbols OK" in capsys.readouterr().out
    res = _guard(ROOT)
    assert res.returncode == 0, res.stdout + res.stderr


def test_the_section_lists_the_front_door():
    section = check_doc_symbols.port_section((ROOT / "README.md").read_text())
    assert section.startswith(SECTION) and "\n## " not in section
    names = check_doc_symbols.api_symbols()
    assert {"compile", "CompiledStencil", "H100_HBM3", "estimate_facet_bytes"} <= set(names)
    assert not check_doc_symbols.check_api_coverage(section, "the section")


def _add_to_section(text: str, line: str) -> str:
    return text.replace(SECTION, SECTION + "\n" + line + "\n", 1)


def _add_to_all(text: str, name: str) -> str:
    return text.replace('__all__ = [\n', f'__all__ = [\n    "{name}",\n', 1)


@pytest.mark.parametrize("path,edit,fault", [
    ("README.md", lambda t: _add_to_section(t, f"Call `{MISSING}()`."),
     f"symbol `{MISSING}()` not found in sources"),
    ("README.md", lambda t: _add_to_section(t, "See `src/repro_torch/no_such_module.py`."),
     "path `src/repro_torch/no_such_module.py` matches nothing"),
    ("src/repro_torch/cfa.py", lambda t: _add_to_all(t, "undocumented_front_door_name"),
     "public API symbol `undocumented_front_door_name` (repro_torch.cfa.__all__) is not "
     "mentioned"),
], ids=["missing-symbol", "missing-path", "undocumented-export"])
def test_the_port_guard_fails_on_a_fault(path, edit, fault, tmp_path):
    root = tmp_path / "repo"
    shutil.copytree(ROOT, root, ignore=SKIP)
    target = root / path
    before = target.read_text()
    target.write_text(edit(before))
    assert target.read_text() != before
    res = _guard(root)
    assert res.returncode == 1, res.stdout + res.stderr
    assert fault in res.stdout
    assert "1 stale doc reference(s)" in res.stdout


def test_the_reference_guard_passes():
    res = subprocess.run([sys.executable, str(ROOT / "tools" / "check_doc_symbols.py")],
                         capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert res.returncode == 0, res.stdout + res.stderr
