"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exports plain C functions and may include the
shared ``csrc/*.cuh`` headers.  ``library(name)`` compiles it with nvcc for
Hopper (``sm_90a``) into ``rpg_ramnet_tpu_torch/_build/`` (listed in
.gitignore) on first use, under a name that carries a hash of the sources
and flags, and loads it with ctypes.  ``build(names)`` runs one nvcc per
source, all at once.  Nothing is built at import, and a failed build
raises: there is no fallback to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# per library built in this process: nvcc's stderr, whose ptxas lines
# report registers and spills per kernel
build_log: Dict[str, str] = {}

_locks: Dict[str, threading.Lock] = {}
_locks_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def _lock(name: str) -> threading.Lock:
    with _locks_lock:
        return _locks.setdefault(name, threading.Lock())


def _so_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _build(name: str) -> Path:
    """The built ``csrc/<name>.cu`` (nvcc unless already built)."""
    with _lock(name):
        so = _so_path(name)
        if not so.exists():
            BUILD_DIR.mkdir(exist_ok=True)
            src = CSRC / f"{name}.cu"
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name} ({proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, so)
            build_log[name] = proc.stderr
        return so


def build(names: Sequence[str]) -> None:
    """Build the named sources concurrently, one nvcc each."""
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build, names))


def library(name: str,
            signatures: Dict[str, Tuple[object, Tuple[object, ...]]]
            ) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu``, built on first use.  signatures maps
    each exported function to (restype, argtypes), set on load."""
    with _lock(name):
        if name in _libs:
            return _libs[name]
    so = _build(name)
    with _lock(name):
        if name not in _libs:
            lib = ctypes.CDLL(str(so))
            for fn_name, (restype, argtypes) in signatures.items():
                fn = getattr(lib, fn_name)
                fn.restype = restype
                fn.argtypes = list(argtypes)
            _libs[name] = lib
        return _libs[name]
