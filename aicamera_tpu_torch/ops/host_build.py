"""Build a C++ source of ``native/`` into a shared library with the host's
``c++``.

The host-side counterpart of ``ops/cuda_build.py``, through its
``compile_library``: ``c++`` from ``PATH`` with ``-O3 -std=c++17 -fPIC
-shared -pthread``, the library in the same git-ignored ``_build/``
directory, named by a hash of the source and the flags, renamed into place
atomically. Loaded with ``ctypes.CDLL``, which releases the GIL for the
length of each call. A missing compiler or a failed build raises with the
compiler's output.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import shutil
from pathlib import Path

from . import cuda_build

NATIVE_DIR = cuda_build.PACKAGE_DIR / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")


def cxx_path() -> str:
    found = shutil.which("c++") or shutil.which("g++")
    if not found:
        raise RuntimeError("no C++ compiler (c++) on PATH: the port's host "
                           "library (JPEG, MJPEG, lapjv, letterbox) needs one")
    return found


def build(source: Path):
    """Build ``source`` unless it is built already; returns ``(library
    path, compiler output)``."""
    return cuda_build.compile_library(source, cxx_path, CXX_FLAGS)


def load_library(source: Path) -> ctypes.CDLL:
    """Build (if needed) and load one source's shared library."""
    lib, _ = build(source)
    return ctypes.CDLL(str(lib))
