"""Build the port's native sources at first use and load them.

Each ``csrc/*.cu`` file is compiled on its own (one ``nvcc`` process per
source, all started together) into a shared library with a plain C
interface, loaded with ``ctypes``. Builds land in ``_build/`` beside this
file (listed in ``.gitignore``), named by a hash of every ``csrc/`` file so
that an edited source is rebuilt. Only CUDA code paths call into
:func:`load`; the CPU paths never need ``nvcc``.

The host runtime (``runtime/native.cpp``, the GKR verifier's exact u64
work) is built with ``g++`` by :func:`load_host` into the same directory;
it serves CPU and CUDA runs alike.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = {"round_kernel": "round_kernel.cu", "fs_tail": "fs_tail.cu", "phase_tables": "phase_tables.cu"}
HOST_SOURCES = {"native": Path(__file__).resolve().parent / "runtime" / "native.cpp"}
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named libraries (all by default) that are not built yet,
    in parallel. Returns nvcc's output (``-Xptxas -v``: registers, spills)
    per library built; raises if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(exist_ok=True)
    jobs = []
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, out, tmp, proc))
    logs = {}
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {SOURCES[name]}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_library_path(name)))
        _loaded[name] = lib
    return lib


def load_host(name: str) -> ctypes.CDLL:
    """The host library ``name`` (``HOST_SOURCES``), built with ``g++``
    first if needed; raises if the build fails."""
    key = f"host:{name}"
    lib = _loaded.get(key)
    if lib is not None:
        return lib
    src = HOST_SOURCES[name]
    out = BUILD_DIR / f"lib{name}-{hashlib.sha256(src.read_bytes()).hexdigest()[:16]}.so"
    if not out.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"g++ not found: the host runtime {src.name} cannot be built")
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {src.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _loaded[key] = lib
    return lib
