"""Doc guard of the port: every code symbol or path the README's port
section names must still exist, and the port's front door must be listed
there.

Scans the inline-backtick tokens of the ``## PyTorch / H100 port`` section
of ``README.md`` (up to the next ``## `` heading) — fenced code blocks are
shell/transcript examples and are skipped — and checks each against the
repository:

* tokens containing ``/`` or ending in a file suffix are treated as paths
  (globs and ``{tag}`` placeholders allowed) and must match at least one
  file or directory of the repository (nothing under ``benchmarks/``);
* identifier-shaped tokens (``snake_case``, ``CamelCase``, dotted
  ``pkg.mod.attr``, optional trailing ``()``) must appear, word-bounded, in
  at least one source file: the ``.py`` files of ``src/``, ``tests/``,
  ``tools/`` and ``examples/``, ``chip_smoke.py``, and the port's CUDA
  sources (``src/repro_torch/**/csrc/*.cu``).

The check also runs in reverse for the port's front door: every name in
``repro_torch.cfa.__all__`` (parsed statically from
``src/repro_torch/cfa.py``; nothing is imported) must be mentioned,
word-bounded, in the section.

Exit status: 0 clean, 1 with a listing of stale references.

    python -m repro_torch.tools.check_doc_symbols            # the README's port section
    python -m repro_torch.tools.check_doc_symbols docs/x.md  # whole files, no reverse check
"""
from __future__ import annotations

import ast
import glob
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]

#: the port's public front door, checked in reverse (the section must cover it)
API_MODULE = ROOT / "src" / "repro_torch" / "cfa.py"

README = ROOT / "README.md"
SECTION = "## PyTorch / H100 port"

#: the symbol corpus: (directory or file, glob) pairs under ROOT
CODE = (("src", "**/*.py"), ("tests", "**/*.py"), ("tools", "**/*.py"),
        ("examples", "**/*.py"), (".", "chip_smoke.py"),
        ("src/repro_torch", "**/csrc/*.cu"))

#: top-level directories whose files no doc path may name
UNREAD = (".git", "benchmarks")

PATH_SUFFIXES = (".py", ".md", ".json", ".txt", ".toml", ".yml", ".yaml", ".csv", ".cu")

# doc-prose words that look like identifiers but are not repo symbols
ALLOWLIST = {"null", "true", "false", "None"}

_IDENT = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*(\.[A-Za-z_][A-Za-z0-9_]*)*(\(\))?$")
_FENCE = re.compile(r"```.*?```", re.S)
_TICK = re.compile(r"`([^`\n]+)`")


def port_section(text: str) -> str:
    """The README's port section: from its heading to the next ``## ``."""
    start = text.find(f"\n{SECTION}\n")
    if start < 0:
        raise ValueError(f"README.md has no {SECTION!r} section")
    rest = text[start + 1:]
    end = rest.find("\n## ", len(SECTION))
    return rest if end < 0 else rest[:end]


def _corpus() -> str:
    parts = []
    for base, pattern in CODE:
        for f in sorted((ROOT / base).glob(pattern)):
            if "__pycache__" not in f.parts:
                parts.append(f.read_text(errors="replace"))
    return "\n".join(parts)


def _repo_paths() -> list[str]:
    """The repository's paths (files and dirs), '/'-normalised, for suffix
    matching of relative mentions like ``lm.py`` or ``kernels/ssd/``."""
    out = []
    for p in ROOT.rglob("*"):
        rel = p.relative_to(ROOT).as_posix()
        if rel.split("/")[0] in UNREAD or "__pycache__" in rel:
            continue
        out.append(rel + ("/" if p.is_dir() else ""))
    return out


def _tokens(text: str) -> list[str]:
    return _TICK.findall(_FENCE.sub("", text))


def _is_path_token(tok: str) -> bool:
    return "/" in tok or tok.endswith(PATH_SUFFIXES)


def api_symbols() -> list[str]:
    """``repro_torch.cfa.__all__``, parsed statically."""
    tree = ast.parse(API_MODULE.read_text())
    for node in tree.body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign) else [])
        if any(isinstance(t, ast.Name) and t.id == "__all__" for t in targets):
            return [str(name) for name in ast.literal_eval(node.value)]
    raise ValueError(f"{API_MODULE.relative_to(ROOT)} has no __all__")


def check_api_coverage(text: str, where: str) -> list[str]:
    """Every name of the front door must be mentioned in ``text``."""
    return [f"public API symbol `{name}` (repro_torch.cfa.__all__) is not mentioned in {where}"
            for name in api_symbols() if not re.search(rf"\b{re.escape(name)}\b", text)]


def check(docs: list[tuple[str, str]]) -> list[str]:
    """Stale references in ``docs``, a list of (label, text)."""
    corpus = _corpus()
    repo_paths = _repo_paths()
    words: dict[str, bool] = {}

    def word_exists(name: str) -> bool:
        if name not in words:
            words[name] = bool(re.search(rf"\b{re.escape(name)}\b", corpus))
        return words[name]

    def path_exists(tok: str) -> bool:
        pattern = re.sub(r"\{[^}]*\}", "*", tok).rstrip("/")
        if pattern.split("/")[0] in UNREAD:
            return False
        if glob.glob(str(ROOT / pattern)):
            return True
        if any("*" in part for part in pattern.split("/")):
            return False
        return any(p.rstrip("/") == pattern or p.rstrip("/").endswith("/" + pattern)
                   for p in repo_paths)

    stale = []
    for label, text in docs:
        for tok in _tokens(text):
            tok = tok.strip()
            if not tok or " " in tok or tok.startswith(("-", "$", "#", "~")) or not tok.isascii():
                continue
            if _is_path_token(tok):
                if not path_exists(tok):
                    stale.append(f"{label}: path `{tok}` matches nothing")
                continue
            if not _IDENT.match(tok) or tok in ALLOWLIST:
                continue
            # a dotted reference names its last component
            leaf = tok.removesuffix("()").rsplit(".", 1)[-1]
            if not word_exists(leaf):
                stale.append(f"{label}: symbol `{tok}` not found in sources")
    return stale


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    if args:
        files = [Path(a) if Path(a).is_absolute() else ROOT / a for a in args]
        missing = [str(f) for f in files if not f.is_file()]
        if missing:
            print(f"no such doc file(s): {', '.join(missing)}")
            return 1
        stale = check([(f.name, f.read_text(errors="replace")) for f in files])
    else:
        label = f"README.md ({SECTION[3:]})"
        section = port_section(README.read_text(errors="replace"))
        stale = check([(label, section)]) + check_api_coverage(section, label)
    for s in stale:
        print(s)
    if stale:
        print(f"\n{len(stale)} stale doc reference(s); update the docs or the code.")
        return 1
    print(f"doc symbols OK ({len(args) or 1} doc(s) checked)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
