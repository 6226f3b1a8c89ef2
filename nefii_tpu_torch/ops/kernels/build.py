"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each source `csrc/<name>.cu` is compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/<name>-<hash>.so csrc/<name>.cu

into `build/` next to this file (git-ignored). The library name carries a
hash of the source, of every header under `csrc/` and of the flags, so an
edited source is rebuilt and a stale library is never loaded. `build_all`
starts one nvcc per missing library, all at once. A failed build raises with
nvcc's output. Nothing here runs at import time: the CPU tests import every
module of the port.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_DIR = os.path.join(HERE, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("fused_mlp", "fused_trace")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# nvcc's output for each library built in this process (-Xptxas -v: registers,
# shared memory and spills per kernel)
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")
    return path


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [os.path.join(CSRC, f"{name}.cu")] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_all(names: Iterable[str] = SOURCES) -> None:
    """Compile every library of `names` that is not built yet, one nvcc
    process each, all started together."""
    with _LOCK:
        todo = [(n, library_path(n)) for n in names if not os.path.exists(library_path(n))]
        if not todo:
            return
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for name, so in todo:
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
            procs.append((name, so, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for name, so, tmp, cmd, proc in procs:
            out, err = proc.communicate()
            BUILD_LOG[name] = out + err
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) building {name}:\n"
                              f"{' '.join(cmd)}\n{out}\n{err}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """Return the loaded library for csrc/<name>.cu, building it if needed."""
    if name not in _LIBS:
        build_all([name])
        with _LOCK:
            if name not in _LIBS:
                _LIBS[name] = ctypes.CDLL(library_path(name))
    return _LIBS[name]
