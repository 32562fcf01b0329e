"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exports plain C functions and may include the
shared ``csrc/*.cuh`` headers.  ``library(name)`` compiles it with nvcc for
Hopper (``sm_90a``) into ``rpg_ramnet_tpu_torch/_build/`` (listed in
.gitignore) on first use, under a name that carries a hash of the sources
and flags, and loads it with ctypes; ``defines`` build a variant of a
source with preprocessor macros set (e.g. a kernel's IEEE gates).
``build(names)`` runs one nvcc per source (or (source, defines) pair),
all at once.  Nothing is built at import, and a failed build
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

# per library built or loaded in this process: nvcc's stderr (kept beside
# the built library), whose ptxas lines report registers and spills per
# kernel; a variant's key is its name and defines joined by '+'
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


def _key(name: str, defines: Sequence[str]) -> str:
    return "+".join((name, *defines))


def _so_path(name: str, defines: Sequence[str] = ()) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join((*NVCC_FLAGS, *defines)).encode())
    return BUILD_DIR / f"lib{_key(name, defines)}-{h.hexdigest()[:16]}.so"


def _build(name: str, defines: Sequence[str] = ()) -> Path:
    """The built ``csrc/<name>.cu`` with ``-D`` of each of ``defines``
    (nvcc unless already built)."""
    key = _key(name, defines)
    with _lock(key):
        so = _so_path(name, defines)
        if not so.exists():
            BUILD_DIR.mkdir(exist_ok=True)
            src = CSRC / f"{name}.cu"
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o",
                 str(tmp), str(src)],
                capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name} ({proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}")
            so.with_suffix(".log").write_text(proc.stderr)
            os.replace(tmp, so)
        if key not in build_log and so.with_suffix(".log").exists():
            build_log[key] = so.with_suffix(".log").read_text()
        return so


def build(names: Sequence) -> None:
    """Build the named sources concurrently, one nvcc each; a name may be
    a (name, defines) pair."""
    jobs = [(n, ()) if isinstance(n, str) else (n[0], tuple(n[1]))
            for n in names]
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: _build(*job), jobs))


def library(name: str,
            signatures: Dict[str, Tuple[object, Tuple[object, ...]]],
            defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu`` (with ``-D`` of each of ``defines``),
    built on first use.  signatures maps each exported function to
    (restype, argtypes), set on load."""
    defines = tuple(defines)
    key = _key(name, defines)
    with _lock(key):
        if key in _libs:
            return _libs[key]
    so = _build(name, defines)
    with _lock(key):
        if key not in _libs:
            lib = ctypes.CDLL(str(so))
            for fn_name, (restype, argtypes) in signatures.items():
                fn = getattr(lib, fn_name)
                fn.restype = restype
                fn.argtypes = list(argtypes)
            _libs[key] = lib
        return _libs[key]
