"""Build a CUDA source of ``csrc/`` into a shared library with ``nvcc``.

Each source has a plain C interface and is loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Libraries go to ``aicamera_tpu_torch/
_build/`` (git-ignored; :func:`set_build_dir` moves it, see
``runtime.engine.enable_persistent_cache``), named by a hash of the source
and the flags, so a changed source is rebuilt and an unchanged one is
reused. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")  # -v: registers, shared memory, spills


def set_build_dir(path) -> None:
    """Build and look up the kernel libraries in ``path`` from now on."""
    global BUILD_DIR
    BUILD_DIR = Path(path)


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = [Path(CUDA_HOME) / "bin" / "nvcc"] if CUDA_HOME else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    for c in candidates:
        if c.exists():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def build(source: Path):
    """Build ``source`` unless it is built already; returns ``(library
    path, compiler output)`` (empty output when the library was reused)."""
    return compile_library(source, nvcc_path, NVCC_FLAGS)


def compile_library(source: Path, compiler, flags):
    """``compiler() *flags -o lib source`` into ``BUILD_DIR`` unless the
    library of this source and these flags exists; ``compiler`` is called
    only when a build is needed."""
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(flags).encode())
    lib = BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cc = compiler()
    proc = subprocess.run([cc, *flags, "-o", str(tmp), str(source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(cc).name} failed for {lib.name}:\n"
                           f"{proc.stdout}")
    os.replace(tmp, lib)  # atomic: a concurrent builder sees all or nothing
    return lib, proc.stdout


def load_library(source: Path) -> ctypes.CDLL:
    """Build (if needed) and load one source's shared library."""
    lib, _ = build(source)
    return ctypes.CDLL(str(lib))
