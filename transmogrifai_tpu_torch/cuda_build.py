"""Build and load the package's hand-written CUDA kernels.

A kernel source ``csrc/<name>.cu`` exposes a plain C interface and is
compiled on first use with ``nvcc`` for ``sm_90a`` (Hopper) into a shared
library under ``transmogrifai_tpu_torch/_build/`` (listed in .gitignore),
then loaded with ``ctypes``.  The library's file name carries a hash of the
source and flags, so an edited source is rebuilt and an unchanged one is
reused.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List, Tuple

__all__ = ["NVCC_FLAGS", "build", "load_library", "nvcc_path"]

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS: List[str] = ["-gencode", "arch=compute_90a,code=sm_90a",
                         "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                         "-Xptxas=-v"]

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def _lib_path(name: str) -> str:
    with open(os.path.join(SRC_DIR, f"{name}.cu"), "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")


def build(name: str) -> Tuple[str, str]:
    """Compile ``csrc/<name>.cu`` unless an up-to-date build exists; returns
    (library path, nvcc's output — its ptxas register, shared-memory and
    spill report — kept beside the library, so a reused build returns the
    report of the build that made it).  Safe to call from several
    processes at once: each compiles to its own temporary files and renames
    them into place."""
    path = _lib_path(name)
    log_path = path[:-3] + ".log"
    if os.path.exists(path) and os.path.exists(log_path):
        with open(log_path) as fh:
            return path, fh.read()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
             os.path.join(SRC_DIR, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
        with open(tmp + ".log", "w") as fh:
            fh.write(proc.stdout)
        os.replace(tmp + ".log", log_path)
        os.replace(tmp, path)
    finally:
        for f in (tmp, tmp + ".log"):
            if os.path.exists(f):
                os.remove(f)
    return path, proc.stdout


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name)[0])
            _loaded[name] = lib
        return lib
