"""SDF grid evaluation on the device, surface extraction and PLY I/O.

Counterpart of ``vdnerf_tpu/mesh/extract.py``:

- :func:`grid_values` / :func:`extract_fields`: a dense ``resolution``^3 grid
  of one query function, evaluated in chunks of 64^3 points that are built on
  the device in the JAX package's x-major order from the same ``np.linspace``
  axes. On the card the runner's query is ``SDFNetwork.sdf_value`` (K1), which
  takes ragged rows, so the last chunk is not padded. The field stays on the
  device until one copy to the host.
- :func:`extract_geometry`: the iso-surface at ``threshold`` through the
  native marching-tetrahedra extractor, vertices rescaled to the bbox.
- :func:`save_ply` / :func:`load_ply`: binary little-endian PLY, byte for
  byte the JAX writer's, written and read without a per-triangle loop.
"""

from __future__ import annotations

import os
import time
from typing import Callable

import numpy as np
import torch

from vdnerf_tpu_torch.mesh.native import marching_cubes
from vdnerf_tpu_torch.utils.device import resolve_device

QueryFn = Callable[[torch.Tensor], torch.Tensor]

# one face record: a uchar vertex count and three little-endian int32 indices
_FACE = np.dtype([("n", "u1"), ("idx", "<i4", (3,))])


def grid_values(bound_min, bound_max, resolution: int, query_fn: QueryFn,
                chunk: int = 64**3, device=None) -> torch.Tensor:
    """``query_fn`` ([N, 3] -> [N] or [N, 1]) on the grid -> [r, r, r] f32 on
    ``device`` (the card unless the caller passes ``"cpu"``)."""
    device = resolve_device(device)
    bound_min = np.asarray(bound_min, dtype=np.float32)
    bound_max = np.asarray(bound_max, dtype=np.float32)
    axes = [torch.from_numpy(np.linspace(bound_min[i], bound_max[i], resolution,
                                         dtype=np.float32)).to(device) for i in range(3)]
    r = resolution
    total = r**3
    out = torch.empty(total, dtype=torch.float32, device=device)
    for start in range(0, total, chunk):
        idx = torch.arange(start, min(start + chunk, total), device=device)
        pts = torch.stack([axes[0][idx // (r * r)], axes[1][(idx // r) % r], axes[2][idx % r]],
                          dim=-1)
        out[start:start + len(idx)] = query_fn(pts).reshape(-1)
    return out.reshape(r, r, r)


def extract_fields(bound_min, bound_max, resolution: int, query_fn: QueryFn,
                   chunk: int = 64**3, device=None) -> np.ndarray:
    """:func:`grid_values` copied to the host -> [r, r, r] float32."""
    return grid_values(bound_min, bound_max, resolution, query_fn, chunk, device).cpu().numpy()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def extract_geometry(bound_min, bound_max, resolution: int, threshold: float,
                     query_fn: QueryFn, device=None,
                     timings: dict | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Iso-surface of ``query_fn`` (e.g. -sdf) at ``threshold`` -> (vertices
    [V, 3] in bbox coordinates, triangles [T, 3]). ``timings``, when given,
    receives the seconds of each part: ``grid`` (the queries, synchronised),
    ``to_host`` and ``marching``."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    u = grid_values(bound_min, bound_max, resolution, query_fn, device=device)
    _sync(device)
    t1 = time.perf_counter()
    u = u.cpu().numpy()
    t2 = time.perf_counter()
    vertices, triangles = marching_cubes(u, float(threshold))
    b_min = np.asarray(bound_min, dtype=np.float32)
    b_max = np.asarray(bound_max, dtype=np.float32)
    if len(vertices):
        vertices = vertices / (resolution - 1.0) * (b_max - b_min)[None, :] + b_min[None, :]
    if timings is not None:
        timings.update(grid=t1 - t0, to_host=t2 - t1, marching=time.perf_counter() - t2)
    return vertices, triangles


def save_ply(path: str, vertices: np.ndarray, triangles: np.ndarray) -> None:
    """Binary little-endian PLY, the bytes of the JAX package's writer."""
    vertices = np.asarray(vertices, dtype="<f4")
    faces = np.empty(len(triangles), dtype=_FACE)
    faces["n"] = 3
    faces["idx"] = np.asarray(triangles, dtype="<i4").reshape(-1, 3)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {len(vertices)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(vertices.tobytes())
        f.write(faces.tobytes())


def load_ply(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read back a triangle mesh written by :func:`save_ply` -> (vertices
    [V, 3] float32, triangles [T, 3] int64)."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    n_v = n_f = 0
    for line in data[:header_end].decode("ascii").splitlines():
        if line.startswith("element vertex"):
            n_v = int(line.split()[-1])
        elif line.startswith("element face"):
            n_f = int(line.split()[-1])
    verts = np.frombuffer(data, dtype="<f4", count=n_v * 3, offset=header_end).reshape(n_v, 3)
    faces = np.frombuffer(data, dtype=_FACE, count=n_f, offset=header_end + n_v * 12)
    if (faces["n"] != 3).any():
        raise ValueError(f"{path}: only triangle faces are supported")
    return verts.copy(), faces["idx"].astype(np.int64)
