"""Build the port's CUDA kernels with ``nvcc`` and load them through ``ctypes``.

Every ``csrc/*.cu`` file under ``repro_torch/kernels/`` is one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds, not minutes).  A library is built at first use into
``build/repro_torch/`` at the root of the checkout (``$REPRO_TORCH_BUILD_DIR``
overrides), named by a content hash of its source directory's ``.cu``/``.cuh``
files and the compiler flags — an edited source builds anew, an unchanged one
loads the existing library.  :func:`build_all` starts one ``nvcc`` per source,
all at once.  A failed build raises with ``nvcc``'s output; nothing falls
back.

``nvcc`` is found through ``$CUDA_HOME/bin``, then ``PATH``, then
``/usr/local/cuda/bin``.  ``-Xptxas -v`` is always on: each kernel's
register, shared-memory and spill line is kept in :data:`BUILD_LOG`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["FLAGS", "BUILD_LOG", "BUILD_SECONDS", "sources", "build_dir", "find_nvcc",
           "build_all", "library"]

KERNELS_DIR = Path(__file__).resolve().parent

#: nvcc flags for every library: Hopper with its arch-specific features,
#: no FMA contraction and no fast math (the kernels are held bit-exact
#: against their plain PyTorch versions)
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: source name -> nvcc's output for the build this process ran or loaded
#: ("" when the library was already built)
BUILD_LOG: dict[str, str] = {}
#: source name -> seconds the build took in this process (0.0 when loaded)
BUILD_SECONDS: dict[str, float] = {}

_LIBS: dict[str, ctypes.CDLL] = {}


def sources() -> dict[str, Path]:
    """Every kernel source, by name (the file stem)."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("**/csrc/*.cu"))}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return KERNELS_DIR.parents[2] / "build" / "repro_torch"


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = []
    if cuda_home:
        candidates.append(Path(cuda_home) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found ($CUDA_HOME/bin, PATH, /usr/local/cuda/bin); the "
        "CUDA kernels of repro_torch are built from source at first use"
    )


def _library_path(name: str) -> Path:
    src = sources()[name]
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(src.parent.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start nvcc for one source (None when its library already exists)."""
    lib = _library_path(name)
    if lib.exists():
        return None
    nvcc = find_nvcc()
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=lib.parent, prefix=f".{name}-", suffix=".so")
    os.close(fd)
    cmd = [nvcc, *FLAGS, "-o", tmp, str(sources()[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, Path(tmp), lib


def _finish(name: str, job, t0: float) -> None:
    proc, tmp, lib = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {sources()[name]} (exit {proc.returncode}):\n{log}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    BUILD_LOG[name] = log
    BUILD_SECONDS[name] = time.perf_counter() - t0


def build_all() -> dict[str, float]:
    """Build every kernel library that is not built yet, one ``nvcc`` per
    source, all started together; returns the build seconds by name."""
    t0 = time.perf_counter()
    jobs = {name: _start(name) for name in sources()}
    for name, job in jobs.items():
        if job is None:
            BUILD_LOG.setdefault(name, "")
            BUILD_SECONDS.setdefault(name, 0.0)
        else:
            _finish(name, job, t0)
    return {name: BUILD_SECONDS[name] for name in jobs}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    if name not in sources():
        raise KeyError(f"no kernel source {name!r}; have {sorted(sources())}")
    job = _start(name)
    if job is not None:
        _finish(name, job, time.perf_counter())
    lib = ctypes.CDLL(str(_library_path(name)))
    _LIBS[name] = lib
    return lib
