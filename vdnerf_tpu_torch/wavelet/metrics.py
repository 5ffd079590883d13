"""Depth-evaluation metrics (parity with ``wavelet/utils.py:24-419``).

A copy of ``vdnerf_tpu/wavelet/metrics.py`` (numpy and cv2).

- :func:`compute_errors_nyu` (:85): abs_rel, rmse, log10, delta<1.25^n.
- :func:`compute_errors_kitti`: the KITTI variant (adds sq_rel, rmse_log).
- :func:`compute_depth_boundary_error` (:122): precision/recall/chamfer of
  depth edges via edge detection + distance transforms (cv2 replaces the
  reference's skimage/scipy pair).
- :func:`colorize`, :class:`AverageMeter`, :func:`evaluate` harness (:275).
"""

from __future__ import annotations

import numpy as np

try:
    import cv2 as cv
except ImportError:  # pragma: no cover
    cv = None


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def depth_norm(depth: np.ndarray, max_depth: float = 1000.0) -> np.ndarray:
    """DepthNorm (reference utils.py): maxDepth / depth."""
    return max_depth / np.maximum(depth, 1e-9)


def compute_errors_nyu(gt: np.ndarray, pred: np.ndarray) -> dict:
    gt = np.asarray(gt, np.float64)
    pred = np.asarray(pred, np.float64)
    valid = gt > 0
    gt, pred = gt[valid], np.maximum(pred[valid], 1e-9)

    thresh = np.maximum(gt / pred, pred / gt)
    d1 = (thresh < 1.25).mean()
    d2 = (thresh < 1.25**2).mean()
    d3 = (thresh < 1.25**3).mean()
    abs_rel = np.mean(np.abs(gt - pred) / gt)
    rmse = np.sqrt(np.mean((gt - pred) ** 2))
    log10 = np.mean(np.abs(np.log10(gt) - np.log10(pred)))
    return {
        "abs_rel": abs_rel, "rmse": rmse, "log10": log10,
        "d1": d1, "d2": d2, "d3": d3,
    }


def compute_errors_kitti(gt: np.ndarray, pred: np.ndarray) -> dict:
    out = compute_errors_nyu(gt, pred)
    valid = np.asarray(gt) > 0
    g = np.asarray(gt, np.float64)[valid]
    p = np.maximum(np.asarray(pred, np.float64)[valid], 1e-9)
    out["sq_rel"] = np.mean((g - p) ** 2 / g)
    out["rmse_log"] = np.sqrt(np.mean((np.log(g) - np.log(p)) ** 2))
    return out


def _depth_edges(depth: np.ndarray, th_low: float = 0.15,
                 th_high: float = 0.3) -> np.ndarray:
    d = depth.astype(np.float32)
    rng = d.max() - d.min()
    norm = ((d - d.min()) / max(rng, 1e-9) * 255).astype(np.uint8)
    return cv.Canny(norm, int(th_low * 255), int(th_high * 255)) > 0


def compute_depth_boundary_error(
    gt_depth: np.ndarray, pred_depth: np.ndarray, max_dist: float = 10.0
) -> dict:
    """Depth-boundary precision/recall via chamfer distances between edge
    maps (reference utils.py:122-169)."""
    e_gt = _depth_edges(gt_depth)
    e_pred = _depth_edges(pred_depth)
    if not e_gt.any() or not e_pred.any():
        return {"dbe_acc": max_dist, "dbe_com": max_dist}
    # distance transform of the COMPLEMENT gives distance-to-nearest-edge
    dt_gt = cv.distanceTransform(
        (~e_gt).astype(np.uint8), cv.DIST_L2, 3
    )
    dt_pred = cv.distanceTransform(
        (~e_pred).astype(np.uint8), cv.DIST_L2, 3
    )
    acc = np.minimum(dt_gt[e_pred], max_dist).mean()  # pred->gt (accuracy)
    com = np.minimum(dt_pred[e_gt], max_dist).mean()  # gt->pred (completeness)
    return {"dbe_acc": float(acc), "dbe_com": float(com)}


def colorize(value: np.ndarray, vmin=None, vmax=None) -> np.ndarray:
    """Grayscale [H,W] -> uint8 color map [H,W,3] (JET via cv2)."""
    vmin = np.min(value) if vmin is None else vmin
    vmax = np.max(value) if vmax is None else vmax
    norm = ((value - vmin) / max(vmax - vmin, 1e-9) * 255).clip(0, 255)
    return cv.applyColorMap(norm.astype(np.uint8), cv.COLORMAP_JET)


def evaluate(
    pred_depths: list[np.ndarray],
    gt_depths: list[np.ndarray],
    with_boundary: bool = False,
) -> dict:
    """Average metrics over an evaluation set (reference utils.py:275-419)."""
    meters: dict[str, AverageMeter] = {}
    for pred, gt in zip(pred_depths, gt_depths):
        m = compute_errors_nyu(gt, pred)
        if with_boundary:
            m.update(compute_depth_boundary_error(gt, pred))
        for k, v in m.items():
            meters.setdefault(k, AverageMeter()).update(v)
    return {k: m.avg for k, m in meters.items()}
