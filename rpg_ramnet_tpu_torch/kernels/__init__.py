"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exports plain C functions.  ``library(name)`` compiles
it with nvcc for Hopper (``sm_90a``) into ``rpg_ramnet_tpu_torch/_build/``
(listed in .gitignore) on first use, under a name that carries a hash of the
source and flags, and loads it with ctypes.  Nothing is built at import, and
a failed build raises: there is no fallback to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# per library built in this process: nvcc's stderr, whose ptxas lines
# report registers and spills per kernel
build_log: Dict[str, str] = {}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def library(name: str,
            signatures: Dict[str, Tuple[object, Tuple[object, ...]]]
            ) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu``, built on first use.  signatures maps
    each exported function to (restype, argtypes), set on load."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        so = BUILD_DIR / f"lib{name}-{digest}.so"
        if not so.exists():
            BUILD_DIR.mkdir(exist_ok=True)
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
        lib = ctypes.CDLL(str(so))
        for fn_name, (restype, argtypes) in signatures.items():
            fn = getattr(lib, fn_name)
            fn.restype = restype
            fn.argtypes = list(argtypes)
        _libs[name] = lib
        return lib
