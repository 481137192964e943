"""Build and load the port's CUDA sources at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``latentrag_torch/_build/`` (listed in ``.gitignore``)
under a name keyed by a hash of the flags and of the source with every
file it includes from ``csrc/``, so an edited source or header rebuilds
and an unchanged one loads at once. Nothing is built when a module is
imported: only the first kernel launch on a CUDA tensor calls
``load_library``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# seconds spent in nvcc per library, for the record of a run
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin); the port's CUDA "
        "kernels are built from source at first use"
    )


def sources(name: str) -> list[str]:
    """``csrc/<name>.cu`` and every file it includes from ``csrc/`` with
    ``#include "..."``, transitively, as paths relative to ``csrc/``."""
    seen: list[str] = []
    todo = [f"{name}.cu"]
    while todo:
        rel = todo.pop()
        if rel in seen:
            continue
        seen.append(rel)
        with open(os.path.join(CSRC, rel), encoding="utf-8") as f:
            text = f.read()
        todo += [inc for inc in _INCLUDE.findall(text)
                 if os.path.isfile(os.path.join(CSRC, inc))]
    return sorted(seen)


def library_path(name: str) -> str:
    """The library's path, keyed by a hash of the flags and of every
    source it is built from, so an edited header rebuilds too."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for rel in sources(name):
        digest.update(rel.encode())
        with open(os.path.join(CSRC, rel), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists; returns
    the library path. The output is written under a temporary name and
    renamed, so a build cut short never leaves a library that loads."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds[name] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stderr[-4000:]}"
        )
    os.replace(tmp, out)
    return out


def load_library(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _loaded[name] = lib
        return lib
