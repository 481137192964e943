"""Build and load the port's CUDA sources at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``; a source
may be compiled into several libraries, one for each set of ``-D``
defines (``fused_topk.cu``: with and without the row-mask instances).
``load_libraries`` starts every missing build at once, one ``nvcc`` a
library, so their wall time is the longest one's. A library lands in
``latentrag_torch/_build/`` (listed in ``.gitignore``) under a name keyed
by a hash of the flags, the defines and the source with every file it
includes from ``csrc/``, so an edited source or header rebuilds and an
unchanged one loads at once. Nothing is built when a module is imported:
only the first kernel launch on a CUDA tensor loads the libraries.
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


def _flags(defines) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def _key(name: str, defines) -> str:
    return name + "".join(f"[{d}]" for d in defines)


def library_path(name: str, defines: tuple = ()) -> str:
    """The library's path, keyed by a hash of the flags, the defines and
    every source it is built from, so an edited header rebuilds too."""
    digest = hashlib.sha1(" ".join(_flags(defines)).encode())
    for rel in sources(name):
        digest.update(rel.encode())
        with open(os.path.join(CSRC, rel), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def build_all(specs) -> list[str]:
    """Compile each ``(name, defines)`` of ``specs`` whose hashed library
    does not exist yet, every ``nvcc`` started at once; returns the
    libraries' paths. Each output is written under a temporary name and
    renamed, so a build cut short never leaves a library that loads; a
    failed build raises once every started one has ended."""
    started = []
    for name, defines in specs:
        out = library_path(name, defines)
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *_flags(defines), "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        started.append((_key(name, defines), out, tmp, proc,
                        time.perf_counter()))
    errors = []
    for key, out, tmp, proc, t0 in started:
        _, err = proc.communicate()
        build_seconds[key] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {key} (exit {proc.returncode}):"
                          f"\n{err[-4000:]}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [library_path(name, defines) for name, defines in specs]


def load_libraries(specs) -> list[ctypes.CDLL]:
    """The libraries of ``specs`` (``(name, defines)`` pairs), built
    together where missing, loaded once per process."""
    with _lock:
        missing = [s for s in specs if _key(*s) not in _loaded]
        for spec, path in zip(missing, build_all(missing)):
            _loaded[_key(*spec)] = ctypes.CDLL(path)
        return [_loaded[_key(*s)] for s in specs]


def load_library(name: str, defines: tuple = ()) -> ctypes.CDLL:
    return load_libraries([(name, tuple(defines))])[0]
