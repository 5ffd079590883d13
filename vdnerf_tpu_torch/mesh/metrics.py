"""Mesh quality metrics: area-weighted surface sampling and symmetric Chamfer
distance (counterpart of ``vdnerf_tpu/mesh/metrics.py``; numpy and scipy).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def sample_surface(
    vertices: np.ndarray, triangles: np.ndarray, n_points: int,
    seed: int = 0,
) -> np.ndarray:
    """Area-weighted uniform sampling of points on a triangle mesh."""
    v0 = vertices[triangles[:, 0]]
    v1 = vertices[triangles[:, 1]]
    v2 = vertices[triangles[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    total = areas.sum()
    if total <= 0:
        raise ValueError("degenerate mesh: zero total area")
    rng = np.random.default_rng(seed)
    tri_idx = rng.choice(len(triangles), size=n_points, p=areas / total)
    # uniform barycentric coordinates
    u = rng.random(n_points)
    v = rng.random(n_points)
    flip = u + v > 1
    u[flip] = 1 - u[flip]
    v[flip] = 1 - v[flip]
    w = 1 - u - v
    return (
        v0[tri_idx] * w[:, None]
        + v1[tri_idx] * u[:, None]
        + v2[tri_idx] * v[:, None]
    )


def chamfer_distance(
    pts_a: np.ndarray, pts_b: np.ndarray
) -> dict[str, float]:
    """Symmetric Chamfer: mean nearest-neighbor distance in both directions.
    The queries run on every host core (exact, as on one): far-apart point
    sets make each nearest-neighbour search long."""
    d_ab = cKDTree(pts_b).query(pts_a, workers=-1)[0]
    d_ba = cKDTree(pts_a).query(pts_b, workers=-1)[0]
    return {
        "chamfer": float(d_ab.mean() + d_ba.mean()),
        "accuracy": float(d_ab.mean()),
        "completeness": float(d_ba.mean()),
        "hausdorff": float(max(d_ab.max(), d_ba.max())),
    }


def mesh_chamfer(
    verts_a: np.ndarray, tris_a: np.ndarray,
    verts_b: np.ndarray, tris_b: np.ndarray,
    n_points: int = 100_000, seed: int = 0,
) -> dict[str, float]:
    pa = sample_surface(verts_a, tris_a, n_points, seed)
    pb = sample_surface(verts_b, tris_b, n_points, seed + 1)
    return chamfer_distance(pa, pb)
