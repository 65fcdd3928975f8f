"""Build a kernel source under csrc/ with nvcc and load it with ctypes.

Each source is compiled on first use into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so csrc/<name>.cu

The library lands in `build/` at the root of the checkout, named by a hash of
the sources and flags, so an edited source builds anew and an unchanged one
loads from disk. A missing nvcc or a failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> loaded library, and name -> ptxas report of the build (registers,
# shared memory, spills) when this process built it
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc not found: building the CUDA kernels needs the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + src.read_bytes()).hexdigest()[:16]
    return BUILD / f"lib{name}-{digest}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Build csrc/<name>.cu if its library is not in build/ yet, and load it."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    so = library_path(name)
    if not so.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name}.cu:\n{proc.stderr}")
        BUILD_LOG[name] = proc.stderr
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _LIBS[name] = lib
    return lib
