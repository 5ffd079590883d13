"""Shared geometry-QC sequence: extract -> visual-hull clean -> Chamfer.

Counterpart of ``vdnerf_tpu/mesh/qc.py``: the SDF iso-surface at
``resolution``^3 through the native extractor, visual-hull cleaning against
the object masks, then Chamfer/Hausdorff against the analytic ground-truth
surface extracted at the same resolution. Non-finite distances become
``None`` so the report stays strict-RFC JSON.
"""

from __future__ import annotations

import time

import numpy as np

from vdnerf_tpu_torch.mesh.clean import clean_mesh, edge_stats
from vdnerf_tpu_torch.mesh.extract import extract_geometry, save_ply
from vdnerf_tpu_torch.mesh.metrics import mesh_chamfer

_CHAMFER_KEYS = ("chamfer", "accuracy", "completeness", "hausdorff")


def _none_chamfer() -> dict:
    return {k: None for k in _CHAMFER_KEYS}


def _sanitize(ch: dict) -> dict:
    return {
        k: (round(float(v), 6) if np.isfinite(v) else None)
        for k, v in ch.items()
    }


def geometry_qc(
    neg_sdf_fn,
    gt_neg_sdf_fn,
    bbox_min,
    bbox_max,
    resolution: int,
    eval_masks: np.ndarray,
    world_mats: np.ndarray,
    scale_mats: np.ndarray | None = None,
    n_points: int = 100_000,
    ply_prefix: str | None = None,
    log=None,
    device=None,
) -> dict:
    """Run the full QC sequence; returns a nested, JSON-safe report.

    Args:
      neg_sdf_fn / gt_neg_sdf_fn: ``pts [N,3] -> -sdf`` query functions on
        torch tensors for the reconstruction and the analytic ground truth.
      eval_masks: [n_views, H, W] uint8/bool object masks.
      world_mats: [n_views, 4, 4] projection mats (K @ w2c) in the SAME
        frame as the extracted vertices; pass ``scale_mats`` when the mesh
        frame is the normalized object frame of a real capture (see
        :func:`vdnerf_tpu_torch.mesh.clean.hull_membership`).
      ply_prefix: when set, writes ``<prefix>.ply`` and
        ``<prefix>_clean.ply``.
      device: where both grids are evaluated (the card unless ``"cpu"``).

    Returns ``{"mesh_res", "raw": {n_verts, n_tris, extract_wall_s,
    edge stats}, "clean": {n_verts, n_tris, hull/component stats,
    edge stats} | None, "chamfer": {chamfer, accuracy, completeness,
    hausdorff} (None-valued when unavailable), "wall_s"}``.
    """
    t0 = time.time()
    verts, tris = extract_geometry(
        bbox_min, bbox_max, resolution, 0.0, neg_sdf_fn, device=device
    )
    raw = {
        "n_verts": int(len(verts)),
        "n_tris": int(len(tris)),
        "extract_wall_s": round(time.time() - t0, 1),
        **edge_stats(tris),
    }
    if log:
        log(f"mesh: {len(verts)} verts {len(tris)} tris at "
            f"{resolution}^3 in {raw['extract_wall_s']}s")
    if not len(verts):
        return {
            "mesh_res": resolution, "raw": raw, "clean": None,
            "chamfer": _none_chamfer(),
            "wall_s": round(time.time() - t0, 1),
        }
    if ply_prefix:
        save_ply(f"{ply_prefix}.ply", verts, tris)

    cverts, ctris, clean_stats = clean_mesh(
        verts, tris, np.asarray(eval_masks), np.asarray(world_mats),
        scale_mats=scale_mats,
    )
    clean = {
        "n_verts": int(len(cverts)),
        "n_tris": int(len(ctris)),
        **clean_stats,
        **edge_stats(ctris),
    }
    if log:
        log(f"cleaned: {clean_stats}")
    if ply_prefix:
        save_ply(f"{ply_prefix}_clean.ply", cverts, ctris)

    v_gt, t_gt = extract_geometry(
        bbox_min, bbox_max, resolution, 0.0, gt_neg_sdf_fn, device=device
    )
    if len(cverts) and len(ctris) and len(v_gt) and len(t_gt):
        chamfer = _sanitize(
            mesh_chamfer(cverts, ctris, v_gt, t_gt, n_points=n_points)
        )
    else:
        chamfer = _none_chamfer()
    if log:
        log(f"chamfer vs analytic surface: {chamfer}")
    return {
        "mesh_res": resolution,
        "raw": raw,
        "clean": clean,
        "chamfer": chamfer,
        "wall_s": round(time.time() - t0, 1),
    }
