"""ctypes binding and on-demand build of the native marching-tetrahedra lib.

Counterpart of ``vdnerf_tpu/mesh/native.py``: the shared
``native/marching_tets.cpp`` is compiled with g++ on first use into the
port's own git-ignored ``vdnerf_tpu_torch/mesh/_build/``, keyed by a hash of
the source, and bound with ctypes. A cached library that does not load on
this machine (built elsewhere with ``-march=native``) is rebuilt.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SRC = _REPO_ROOT / "native" / "marching_tets.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

_lib = None
_lock = threading.Lock()


def _so_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libmarching_tets_{digest}.so"


def _compile(so_path: Path) -> None:
    """g++ into a temporary name, then an atomic rename: two processes
    building at once never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           str(_SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {_SRC}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so_path)


def _get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so_path = _so_path()
        if not so_path.exists():
            _compile(so_path)
        try:
            lib = ctypes.CDLL(str(so_path))
        except OSError:
            # built on another host (missing ISA extensions): rebuild here
            so_path.unlink()
            _compile(so_path)
            lib = ctypes.CDLL(str(so_path))
        lib.mt_run.restype = ctypes.c_longlong
        lib.mt_run.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_float,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_longlong)),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong),
        ]
        lib.mt_free.restype = None
        lib.mt_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def marching_cubes(field: np.ndarray, iso: float = 0.0) -> tuple[np.ndarray, np.ndarray]:
    """Iso-surface of a dense [nx, ny, nz] float field -> (vertices [V, 3]
    float32 in grid-index coordinates, triangles [T, 3] int64), the
    PyMCubes convention the caller rescales to the object bbox."""
    lib = _get_lib()
    field = np.ascontiguousarray(field, dtype=np.float32)
    nx, ny, nz = field.shape

    out_verts = ctypes.POINTER(ctypes.c_float)()
    out_tris = ctypes.POINTER(ctypes.c_longlong)()
    n_verts = ctypes.c_longlong()
    n_tris = ctypes.c_longlong()
    rc = lib.mt_run(
        field.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nx, ny, nz, ctypes.c_float(iso),
        ctypes.byref(out_verts), ctypes.byref(out_tris),
        ctypes.byref(n_verts), ctypes.byref(n_tris),
    )
    if rc != 0:
        raise RuntimeError(f"marching_tets failed with code {rc}")
    try:
        if n_verts.value == 0 or n_tris.value == 0:
            return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
        verts = np.ctypeslib.as_array(out_verts, (n_verts.value, 3)).astype(np.float32)
        tris = np.ctypeslib.as_array(out_tris, (n_tris.value, 3)).astype(np.int64)
    finally:
        lib.mt_free(out_verts)
        lib.mt_free(out_tris)
    return verts, tris
