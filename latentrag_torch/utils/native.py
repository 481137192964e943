"""Build and load the C++ host library at first use.

The port shares one C++ source with the JAX package,
``native/latentrag_native.cpp`` (the WordPiece fast path ``wp_*``, and the
ANN tiers a later slice binds). It compiles with ``g++`` and the flags of
``native/Makefile`` into a shared library in ``latentrag_torch/_build/``
(listed in ``.gitignore``), named by a hash of the compiler flags and the
source, so an edited source rebuilds and an unchanged one loads at once.
Nothing is written into ``native/``, whose own Makefile builds the JAX
package's copy there.

The build runs at the first call of ``load_library``, never at import. A
file lock lets one process compile while the others wait for it, and the
library is written under a temporary name and renamed, so no process ever
loads a half-written file. A failed build, a failed load or a library of
another ABI raises: there is no fallback here.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "latentrag_native.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX = "g++"
# native/Makefile's CXXFLAGS without its warnings, plus -shared
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-fno-math-errno",
            "-shared")
ABI_VERSION = 7  # latentrag_abi_version() of the source this port binds

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path(build_dir: str | None = None) -> str:
    """The library's path in ``build_dir`` (default ``BUILD_DIR``), keyed
    by a hash of the flags and the source."""
    digest = hashlib.sha1(" ".join(CXXFLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(build_dir or BUILD_DIR,
                        f"latentrag_native-{digest.hexdigest()[:12]}.so")


def build(build_dir: str | None = None) -> str:
    """Compile the source unless its hashed library exists; returns the
    library's path. Safe for several processes at once."""
    build_dir = build_dir or BUILD_DIR
    out = library_path(build_dir)
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "latentrag_native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if os.path.exists(out):  # another process built it meanwhile
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        try:
            proc = subprocess.run([CXX, *CXXFLAGS, "-o", tmp, SOURCE],
                                  capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run the C++ compiler {CXX!r}: {e}") from e
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(
                f"{CXX} failed for {SOURCE} (exit {proc.returncode}):\n"
                f"{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The built library, loaded once a process, its ABI checked."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            lib = ctypes.CDLL(path)
            lib.latentrag_abi_version.restype = ctypes.c_int
            abi = int(lib.latentrag_abi_version())
            if abi != ABI_VERSION:
                raise RuntimeError(
                    f"{path} has ABI {abi}; this port binds ABI {ABI_VERSION}")
            _lib = lib
        return _lib
