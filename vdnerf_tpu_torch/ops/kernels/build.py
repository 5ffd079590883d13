"""Build and load the port's CUDA kernels, and count their launches.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. All
sources build in parallel (one ``nvcc`` each, started together) at first use,
into ``_build/`` beside this file; the library's name carries a hash of its
source and flags, so an edited source rebuilds and an unchanged one is
reused. Nothing builds at import time.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a wrapper adds
one where it launches its kernel and nowhere else. The tracing marks of
``csrc/trace_marks.cu`` (``utils/trace.py``) count in none. The compiles run
in the span ``build.nvcc`` (``build.compiles`` counts them), the loads in
``build.load``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from vdnerf_tpu_torch.utils import trace

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE / "_build"
SOURCES = {
    "sdf_fwd": _HERE / "csrc" / "sdf_fwd.cu",
    "fused_mlp": _HERE / "csrc" / "fused_mlp.cu",
    "trace_marks": _HERE / "csrc" / "trace_marks.cu",
    "sdf_block": _HERE / "csrc" / "sdf_block.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
]

LAUNCHES = {"sdf_fwd": 0, "render_fwd": 0, "nerf_fwd": 0, "render_bwd": 0, "nerf_bwd": 0,
            "dw_contract": 0, "render_fwd_f32": 0, "nerf_fwd_f32": 0, "render_bwd_f32": 0,
            "nerf_bwd_f32": 0, "dw_contract_f32": 0, "sdf_block": 0}

_libs: dict[str, ctypes.CDLL] = {}
# reentrant: a trace mark inside the build's own spans loads the marks' library
_lock = threading.RLock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "sdf_fwd_launch": [_P, _P, _I, _P, _P, _P, ctypes.c_float, _P],
    "render_fwd_launch": [_P] * 5 + [_I] + [_P] * 4 + [_I, _I, _I, _P],
    "nerf_fwd_launch": [_P] * 5 + [_I] + [_P] * 5 + [_I, _P],
    "render_bwd_launch": [_P] * 9 + [_I] + [_P] * 7,
    "nerf_bwd_launch": [_P] * 7 + [_I] + [_P] * 4 + [_I] + [_P] * 4,
    "dw_finish_launch": [_P, _I] + [_P] * 4 + [_I, _I] + [_P] * 3,
    "split_mm_launch": [_P, _I, _I, _I, _P],
    "split_wmm_launch": [_P, _I, _I, _I, _P],
    "split_image_launch": [_P, _I, _P],
    "split_embed_launch": [_P, ctypes.c_longlong, _I, _I, _I, _P, ctypes.c_longlong, _I, _P],
    "split_embed_vjp_launch": [_P, _I, _P, _I, _I, _I, _P, _P],
    "split_reduce_launch": [_P, _I, ctypes.c_longlong, _P, _P],
    "sdfb_act_launch": [_P, _I, _P, _I, _I, _I, _F, _P, _I, _I, _F, _P],
    "sdfb_tangent_launch": [_P, _I, _P, _F, _P, _I, _P, _I, _I, _I, _P],
    "sdfb_up_launch": [_P, _I, _P, _I, _P, _F, _P, _I, _P, _I, _P, _I, _P, _I, _I, _P, _I, _I, _F,
                       _P],
    "sdfb_down_launch": [_P, _I, _F, _P, _I, _P, _I, _P, _I, _P, _I, _I, _P],
    "sdfb_embed_grad_launch": [_P, _I, _P, _F, _P, _I, _P, _P, _I, _I, _F, _P],
    "sdfb_embed_cot_launch": [_P, _P, _I, _P, _I, _I, _I, _F, _P],
    "sdfb_embed_vjp_launch": [_P, _I, _P, _F, _P, _P, _P, _I, _P, _I, _I, _F, _P],
    "vdn_mark_launch": [_I, _I, _P],
    "vdn_mark_prepare": [],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source that has no up-to-date library, in parallel.

    Returns {name: library path}. Raises with the compiler's output on any
    failure. ``_build/<name>.log`` keeps each compiler's output (the
    ``-Xptxas -v`` register and shared-memory report).
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in SOURCES}
    missing = [name for name, target in targets.items() if not target.exists()]
    if not missing:
        return targets
    failures = []
    with trace.span("build.nvcc"):
        procs = {}
        for name in missing:
            tmp = targets[name].with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ), tmp)
        trace.count("build.compiles", len(procs))
        for name, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            (BUILD_DIR / f"{name}.log").write_text(log)
            if proc.returncode != 0:
                failures.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
                continue
            os.replace(tmp, targets[name])
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library for source ``name``, building all sources first."""
    with _lock:
        if name not in _libs:
            paths = build_all()
            with trace.span("build.load"):
                for lib_name, path in paths.items():
                    if lib_name in _libs:
                        continue
                    lib = ctypes.CDLL(str(path))
                    for fn, argtypes in _SIGNATURES.items():
                        if hasattr(lib, fn):
                            getattr(lib, fn).argtypes = argtypes
                            getattr(lib, fn).restype = ctypes.c_int
                    _libs[lib_name] = lib
        return _libs[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err}")


def int64_array(values) -> ctypes.Array:
    """A host int64 array for a launcher's ``meta`` argument, made once per
    distinct list (the launchers only read it)."""
    return _int64_array(tuple(int(v) for v in values))


@functools.lru_cache(maxsize=64)
def _int64_array(values: tuple) -> ctypes.Array:
    return (ctypes.c_longlong * len(values))(*values)


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
