"""Camera-pose visualisation: frustum plots drawn with cv2.

Counterpart of ``vdnerf_tpu/utils/camvis.py``: :func:`frustum_corners` is
the same pinhole geometry, and :func:`plot_cam_poses` draws the same picture
(every pose set's frustums in its own colour, the scene origin, a legend)
headlessly to a PNG. It projects the scene orthographically from one fixed
view with cv2 instead of matplotlib's 3-D axes, so the port needs no plotting
library.
"""

from __future__ import annotations

import os

import cv2 as cv
import numpy as np

# BGR of matplotlib's tab:red, tab:blue and tab:green, the JAX plot's colours of the sets
COLORS = {"learned": (40, 39, 214), "init": (180, 119, 31), "gt": (44, 160, 44)}
EDGE_ORDER = ((0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1))
SIZE = 1080  # 9 inches at 120 dpi, the JAX figure's size


def _view_rotation() -> np.ndarray:
    """World -> view rotation [3, 3] of a viewer at azimuth -60 degrees about
    +z and 30 degrees above the xy plane: rows are the screen's right, its
    up, and the direction towards the viewer."""
    az, el = np.deg2rad(-60.0), np.deg2rad(30.0)
    toward = np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)])
    right = np.cross([0.0, 0.0, 1.0], toward)
    right /= np.linalg.norm(right)
    return np.stack([right, np.cross(toward, right), toward])


def frustum_corners(
    c2w: np.ndarray, H: int, W: int, fx: float, length: float = 0.5
) -> np.ndarray:
    """World-space frustum points for one camera: [apex, tl, tr, br, bl].

    Image-plane half extents (W/2, H/2) / fx at depth ``length`` along +z
    (OpenCV convention), transformed by c2w.
    """
    hw = 0.5 * W / fx * length
    hh = 0.5 * H / fx * length
    pts_cam = np.array(
        [
            [0.0, 0.0, 0.0],
            [-hw, -hh, length],
            [hw, -hh, length],
            [hw, hh, length],
            [-hw, hh, length],
        ],
        dtype=np.float64,
    )
    return pts_cam @ c2w[:3, :3].T + c2w[:3, 3]


def plot_cam_poses(
    path: str,
    pose_sets: dict[str, np.ndarray],
    H: int,
    W: int,
    fx: float,
    length: float = 0.5,
) -> str:
    """Draw every pose set ({label: [N, 4, 4]}, labels ``init``, ``learned``
    and ``gt``) as coloured frustums -> PNG."""
    rot = _view_rotation()
    frusta = {label: [frustum_corners(c2w, H, W, fx, length) for c2w in np.asarray(poses)]
              for label, poses in pose_sets.items()}
    pts = np.concatenate([np.zeros((1, 3))] + [f for fs in frusta.values() for f in fs])
    xy = pts @ rot[:2].T
    lo, hi = xy.min(0), xy.max(0)
    margin = 0.08 * SIZE
    scale = (SIZE - 2 * margin) / max(float((hi - lo).max()), 1e-9)
    center = 0.5 * (lo + hi)

    def to_px(p):
        v = (p @ rot[:2].T - center) * scale
        return np.stack([SIZE / 2 + v[..., 0], SIZE / 2 - v[..., 1]], -1).round().astype(int)

    img = np.full((SIZE, SIZE, 3), 255, np.uint8)
    for row, (label, fs) in enumerate(frusta.items()):
        for corners in fs:
            px = to_px(corners)
            for a, b in EDGE_ORDER:
                cv.line(img, tuple(map(int, px[a])), tuple(map(int, px[b])), COLORS[label], 1,
                        cv.LINE_AA)
        # the legend, one row a set
        y = 36 + 32 * row
        cv.line(img, (SIZE - 210, y), (SIZE - 160, y), COLORS[label], 3, cv.LINE_AA)
        cv.putText(img, label, (SIZE - 150, y + 8), cv.FONT_HERSHEY_SIMPLEX, 0.8, (0, 0, 0), 1,
                   cv.LINE_AA)
    cv.circle(img, tuple(map(int, to_px(np.zeros(3)))), 5, (0, 0, 0), -1, cv.LINE_AA)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if not cv.imwrite(path, img):
        raise RuntimeError(f"cv2 could not write {path}")
    return path
