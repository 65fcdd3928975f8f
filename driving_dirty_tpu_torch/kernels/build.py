"""Build a kernel source under csrc/ with nvcc and load it with ctypes.

Each source is compiled on first use into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so csrc/<name>.cu

The library lands in `build/` at the root of the checkout, named by a hash of
the source, the headers of csrc/ and the flags, so an edited source builds anew and an unchanged one
loads from disk. `load_libraries` starts one nvcc per source at once. A
missing nvcc or a failed build raises; nothing falls back. Ranks of one
host that build at once (parallel/launch.py) are safe: each compiles into
a temporary named by its pid and `os.replace`s it onto the library's
name, an atomic rename, so a rank loads either no file or a whole one.

`host_library` builds the port's C++ host helpers (the libjpeg decoder of
data/native/, the IoU loop of metrics/native/) the same way with g++; their
callers turn its error into an ImportError and decode or score in Python.

The wrappers that launch these libraries register their kernels as
torch.library ops in one namespace, OP_NAMESPACE (kernels/ops.py imports
them all), so that torch.export can trace a model through them.
"""
from __future__ import annotations

import ctypes
import functools
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

OP_NAMESPACE = "driving_dirty"  # torch.ops.driving_dirty.<op>
HOST_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc not found: building the CUDA kernels needs the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """build/lib<name>-<hash>.so, the hash over the flags, the source and
    every header of csrc/ (a source may include any of them)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + (CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def load_libraries(names) -> dict[str, ctypes.CDLL]:
    """Build every csrc/<name>.cu whose library is not in build/ yet, with one
    nvcc process per source, all started together, and load them all."""
    names = list(names)
    builds = {}
    for name in names:
        so = library_path(name)
        if name in _LIBS or so.exists() or name in builds:
            continue
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        builds[name] = (so, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (so, tmp, proc) in builds.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{err}")
            continue
        BUILD_LOG[name] = err
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed to build " + "\n".join(failed))
    for name in names:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return {name: _LIBS[name] for name in names}


def load_library(name: str) -> ctypes.CDLL:
    """Build csrc/<name>.cu if its library is not in build/ yet, and load it."""
    return load_libraries([name])[name]


@functools.cache
def _host_target() -> bytes:
    """What -march=native selects on this machine (g++'s resolved target
    options), so that a library built for one CPU is never loaded on
    another from a shared build/."""
    out = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True, check=True).stdout
    return out.encode()


def host_library(name: str, source: Path, libs=()) -> ctypes.CDLL:
    """Build the C++ source `source` with g++ (HOST_FLAGS, linked with
    `libs`) into build/lib<name>-<hash>.so unless it is there, and load it.
    The hash covers the source, the flags, the libraries and the CPU that
    -march=native targets. A missing compiler, a missing header or library,
    a failed build and a failed load raise RuntimeError with the message."""
    if name in _LIBS:
        return _LIBS[name]
    cmd_flags = (*HOST_FLAGS, *(f"-l{lib}" for lib in libs))
    try:
        target = _host_target()
    except (OSError, subprocess.CalledProcessError) as e:
        raise RuntimeError(f"g++ is not usable: {e}") from e
    h = hashlib.sha256(" ".join(cmd_flags).encode() + target + Path(source).read_bytes())
    so = BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = ["g++", *HOST_FLAGS, str(source), "-o", str(tmp), *(f"-l{lib}" for lib in libs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed to build {Path(source).name}:\n{proc.stderr.strip()}")
        os.replace(tmp, so)
    try:
        _LIBS[name] = ctypes.CDLL(str(so))
    except OSError as e:
        raise RuntimeError(f"cannot load {so.name}: {e}") from e
    return _LIBS[name]
