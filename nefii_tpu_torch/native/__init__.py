"""ctypes bindings for the port's copy of the native geometry runtime
(counterpart of nefii_tpu/native/__init__.py): BVH signed distance with
pseudonormal signs, area-weighted surface sampling (mesh_sdf.cpp) and
marching tetrahedra (marching.cpp). The two sources are byte-identical to
the JAX package's.

The library is built at first use with

    g++ -O3 -march=native -fopenmp -shared -fPIC -o build/libnefii_native-<hash>.so ...

into `build/` next to this file (git-ignored), never next to the sources.
The name carries a hash of the sources, the flags and the host CPU, so an
edited source or a copy of the directory on another CPU is rebuilt, never
loaded stale. A build writes a temporary file and renames it into place, so
processes that build at once never load a half-written library. Nothing
here runs at import time.

This is host C++ (OpenMP over the query points), not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
import time
from typing import Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(HERE, "build")
SOURCES = ("mesh_sdf.cpp", "marching.cpp")
CXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]

_lib = None
_LOCK = threading.Lock()
# seconds the last build in this process took (0.0: the library was already built)
BUILD_SECONDS = 0.0


def _host_cpu() -> bytes:
    """What -march=native compiles for: the CPU's model and feature flags."""
    keys = ("model name", "flags", "Features", "CPU part")
    try:
        with open("/proc/cpuinfo") as f:
            lines = {ln.split(":", 1)[0].strip(): ln for ln in f if ":" in ln}
        return "".join(lines.get(k, "") for k in keys).encode()
    except OSError:
        return platform.processor().encode()


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + _host_cpu())
    for name in SOURCES:
        with open(os.path.join(HERE, name), "rb") as f:
            h.update(name.encode() + f.read())
    return os.path.join(BUILD_DIR, f"libnefii_native-{h.hexdigest()[:16]}.so")


def _build(so: str) -> None:
    global BUILD_SECONDS
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, *(os.path.join(HERE, s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) building the native runtime:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)
    BUILD_SECONDS = time.perf_counter() - t0


def get_lib() -> ctypes.CDLL:
    """The loaded native library, built first if this host has no build of
    the current sources."""
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            _build(so)
        lib = ctypes.CDLL(so)

        lib.mesh_create.restype = ctypes.c_void_p
        lib.mesh_create.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ]
        lib.mesh_free.restype = None
        lib.mesh_free.argtypes = [ctypes.c_void_p]
        lib.mesh_total_area.restype = ctypes.c_double
        lib.mesh_total_area.argtypes = [ctypes.c_void_p]
        lib.mesh_signed_distance.restype = None
        lib.mesh_signed_distance.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.mesh_sample_surface.restype = None
        lib.mesh_sample_surface.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        lib.marching_tetrahedra.restype = ctypes.c_int64
        lib.marching_tetrahedra.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ]
        _lib = lib
        return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class MeshSDF:
    """BVH signed-distance field + surface sampler over a triangle mesh."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray):
        self._lib = get_lib()
        v = np.ascontiguousarray(vertices, np.float64)
        f = np.ascontiguousarray(faces, np.int32)
        if v.ndim != 2 or v.shape[1] != 3 or f.ndim != 2 or f.shape[1] != 3:
            raise ValueError(f"vertices [V,3] and faces [F,3], got {v.shape} and {f.shape}")
        if len(f) and (f.min() < 0 or f.max() >= len(v)):
            raise ValueError("a face indexes a vertex that does not exist")
        self._handle = self._lib.mesh_create(
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(v),
            f.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(f),
        )
        self.n_vertices = len(v)
        self.n_faces = len(f)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.mesh_free(self._handle)
            self._handle = None

    @property
    def total_area(self) -> float:
        return self._lib.mesh_total_area(self._handle)

    def signed_distance(self, points: np.ndarray) -> np.ndarray:
        """points [P,3] -> signed distances [P] float32 (negative inside).
        The GIL is released while the native loop runs."""
        p = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
        out = np.empty(len(p), np.float32)
        self._lib.mesh_signed_distance(self._handle, _fptr(p), len(p), _fptr(out))
        return out

    def sample_surface(self, n: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """n area-weighted surface points [n,3] and their face normals [n,3],
        from a XorShift stream seeded with `seed`."""
        pts = np.empty((n, 3), np.float32)
        normals = np.empty((n, 3), np.float32)
        self._lib.mesh_sample_surface(self._handle, n, seed, _fptr(pts), _fptr(normals))
        return pts, normals


def marching_tetrahedra(grid: np.ndarray, iso: float = 0.0) -> np.ndarray:
    """Extract the iso-surface of a [nx,ny,nz] grid -> triangles [T,3,3]
    in grid-index coordinates."""
    lib = get_lib()
    g = np.ascontiguousarray(grid, np.float32)
    nx, ny, nz = g.shape
    max_tris = 4 * nx * ny * nz  # generous; one retry if it overflows
    out = np.empty((max_tris, 9), np.float32)
    n = lib.marching_tetrahedra(_fptr(g), nx, ny, nz, iso, _fptr(out), max_tris)
    if n > max_tris:
        out = np.empty((n, 9), np.float32)
        n = lib.marching_tetrahedra(_fptr(g), nx, ny, nz, iso, _fptr(out), n)
    return out[:n].reshape(n, 3, 3)
