"""Visual-hull mesh cleaning for mask-free (womsk) reconstructions.

Counterpart of ``vdnerf_tpu/mesh/clean.py`` (numpy, scipy and cv2): connected
components over the triangle graph, per-vertex hull membership by projecting
into every view with the dataset's ``world_mat`` (= K @ world-to-camera), and
a per-triangle cull followed by a drop of small leftover islands.
"""

from __future__ import annotations

import numpy as np
from scipy import sparse
from scipy.sparse.csgraph import connected_components as _cc


def mesh_components(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Label each vertex with its connected component id. [V] int32."""
    if len(tris) == 0:
        return np.zeros(len(verts), np.int32)
    e = np.concatenate(
        [tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]], axis=0
    )
    adj = sparse.coo_matrix(
        (np.ones(len(e), np.int8), (e[:, 0], e[:, 1])),
        shape=(len(verts), len(verts)),
    )
    _, labels = _cc(adj, directed=False)
    return labels.astype(np.int32)


def hull_membership(
    verts: np.ndarray,
    masks: np.ndarray,
    world_mats: np.ndarray,
    dilate: int = 8,
    scale_mats: np.ndarray | None = None,
) -> np.ndarray:
    """Fraction of views in which each vertex projects inside the mask.

    verts: [V, 3]; masks: [n, H, W] in {0,1}; world_mats: [n, 4, 4]
    P = K @ w2c (the dataset npz convention, which projects WORLD-frame
    points). ``dilate`` grows the masks (pixels) so boundary vertices
    aren't culled.

    Frame requirement: ``extract_geometry`` verts live in the NORMALIZED
    object frame (the unit sphere the SDF is trained in). world_mat alone
    projects world-frame points, so for real captures — where scale_mat is
    not the identity (reference dataset.py:87-92) — pass ``scale_mats``
    ([n, 4, 4]) and the projection used is P @ scale_mat, which maps
    object-frame verts correctly. On synthetic scenes scale_mat is the
    identity and the argument may be omitted.
    """
    import cv2 as cv

    if scale_mats is not None:
        world_mats = np.matmul(world_mats, scale_mats)
    n, H, W = masks.shape
    if dilate > 0:
        k = np.ones((dilate, dilate), np.uint8)
        masks = np.stack(
            [cv.dilate(m.astype(np.uint8), k) for m in masks]
        )
    vh = np.concatenate(
        [verts, np.ones((len(verts), 1), verts.dtype)], axis=1
    )
    inside = np.zeros(len(verts), np.float64)
    for i in range(n):
        p = vh @ world_mats[i].T  # [V, 4]
        z = p[:, 2]
        ok = z > 1e-6
        # floor, not truncation: astype() rounds toward zero, which would
        # fold projections in (-1, 0) onto column/row 0 inside the image
        px = np.floor(
            np.clip(p[:, 0] / np.where(ok, z, 1.0), -1, W)
        ).astype(np.int64)
        py = np.floor(
            np.clip(p[:, 1] / np.where(ok, z, 1.0), -1, H)
        ).astype(np.int64)
        valid = ok & (px >= 0) & (px < W) & (py >= 0) & (py < H)
        hit = np.zeros(len(verts), bool)
        hit[valid] = masks[i][py[valid], px[valid]] > 0
        inside += hit
    return inside / n


def _compact(verts, tris, keep_vert):
    remap = -np.ones(len(verts), np.int64)
    remap[keep_vert] = np.arange(int(keep_vert.sum()))
    tri_keep = np.all(keep_vert[tris], axis=1)
    return verts[keep_vert], remap[tris[tri_keep]]


def clean_mesh(
    verts: np.ndarray,
    tris: np.ndarray,
    masks: np.ndarray,
    world_mats: np.ndarray,
    min_views_frac: float = 0.9,
    min_component_frac: float = 0.01,
    dilate: int = 8,
    scale_mats: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, dict]:
    """Hull-clip the mesh, then drop small leftover islands.

    ``verts`` are expected in the normalized object frame (what
    ``extract_geometry`` returns); pass ``scale_mats`` on real captures
    where scale_mat differs from the identity — see
    :func:`hull_membership` for the frame contract.

    The spurious womsk shells grow out of the true surface (one connected
    component — measured on a 512^3 flagship extraction), so culling must
    be per-triangle: keep triangles whose vertices all project inside the
    (dilated) mask in at least ``min_views_frac`` of the views, then drop
    connected components smaller than ``min_component_frac`` of the kept
    vertices (shell remnants that sit inside the hull cone). The cut can
    open boundary edges where shells attached to the surface — report the
    boundary-edge count honestly rather than claiming watertightness.

    Returns (verts, tris, stats).
    """
    member = hull_membership(
        verts, masks, world_mats, dilate=dilate, scale_mats=scale_mats
    )
    v1, t1 = _compact(verts, tris, member >= min_views_frac)

    stats = {
        "hull_kept_verts": int(len(v1)),
        "hull_culled_verts": int(len(verts) - len(v1)),
    }
    if len(t1):
        labels = mesh_components(v1, t1)
        sizes = np.bincount(labels)
        keep_comp = sizes >= max(min_component_frac * len(v1), 3)
        v1, t1 = _compact(v1, t1, keep_comp[labels])
        stats["n_components"] = int(len(sizes))
        stats["kept_components"] = int(keep_comp.sum())
    stats["kept_verts"] = int(len(v1))
    stats["kept_tris"] = int(len(t1))
    return v1, t1, stats


def edge_stats(tris: np.ndarray) -> dict:
    """Boundary/nonmanifold edge counts (closed 2-manifold: all edges 2x)."""
    if len(tris) == 0:
        return {"n_edges": 0, "boundary_edges": 0, "nonmanifold_edges": 0,
                "watertight": False}
    e = np.sort(
        np.concatenate(
            [tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]], axis=0
        ),
        axis=1,
    )
    _, counts = np.unique(e, axis=0, return_counts=True)
    return {
        "n_edges": int(len(counts)),
        "boundary_edges": int((counts == 1).sum()),
        "nonmanifold_edges": int((counts > 2).sum()),
        "watertight": bool((counts == 2).all()),
    }
