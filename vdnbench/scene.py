"""The cell's scene, made from the seed and written in the dataset layout the
program reads: ``<dir>/image/<stem>.png`` (RGBA: a shaded sphere over a
transparent background), ``<dir>/image/cameras_sphere.npz`` (``world_mat``
= K w2c, ``scale_mat`` the identity) and, for a conf with a depth head, one
float32 ``[1, c, h, w]`` feature file per view under
``<dir>/image/<depth_dir>/``, the monocular teacher's output layout.

The cameras look at the origin from a ring at the config's distance, their
azimuth phase and elevations drawn from the seed; the sphere's radius and
its shading too. Every seed gives the same sizes.
"""

from __future__ import annotations

import os

import cv2 as cv
import numpy as np


def look_at(eye: np.ndarray) -> np.ndarray:
    """OpenCV-convention c2w (x right, y down, z forward) towards the origin."""
    fwd = -eye / np.linalg.norm(eye)
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
    return c2w


def _render(c2w, K, H, W, radius, tint) -> np.ndarray:
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    d = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float64) @ np.linalg.inv(K[:3, :3]).T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = d @ c2w[:3, :3].T
    o = c2w[:3, 3]
    b = 2.0 * d @ o
    c = o @ o - radius**2
    disc = b**2 - 4 * c
    t = (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0
    hit = (disc > 0) & (t > 0)
    normal = (o + d * t[..., None]) / radius
    color = np.clip(0.5 + 0.5 * normal * tint, 0.0, 1.0)
    rgba = np.zeros((H, W, 4), np.uint8)
    rgba[..., :3] = np.where(hit[..., None], color * 255, 255).astype(np.uint8)
    rgba[..., 3] = hit * 255
    return rgba


def make(out_dir: str, scene: dict, seed: int, depth: tuple[str, int] | None = None) -> dict:
    """Write the scene of the config's ``scene`` block under ``out_dir``.
    ``depth``: (the conf's ``depth_dir``, the feature channels) for a conf
    with a depth head. -> {"c2w" [n, 4, 4], "K" [4, 4], "images" uint8 [n,
    H, W, 4], "feats" float32 [n, c, h, w] or None}."""
    rng = np.random.default_rng(seed)
    n, H, W = scene["n_images"], scene["H"], scene["W"]
    K = np.eye(4)
    K[0, 0] = K[1, 1] = scene["focal"]
    K[0, 2], K[1, 2] = W / 2.0, H / 2.0
    phase = rng.uniform(0.0, 2.0 * np.pi)
    elev = rng.uniform(-0.5, 0.5, n)
    radius = rng.uniform(0.4, 0.6)
    tint = rng.uniform(0.5, 1.0, 3)
    img_dir = os.path.join(out_dir, "image")
    os.makedirs(img_dir, exist_ok=True)
    cams, c2ws, images = {}, [], []
    for i in range(n):
        theta = phase + 2.0 * np.pi * i / n
        phi = np.pi / 2 + elev[i]
        eye = scene["cam_dist"] * np.array([np.cos(theta) * np.sin(phi),
                                            np.sin(theta) * np.sin(phi), np.cos(phi)])
        c2w = look_at(eye)
        rgba = _render(c2w, K, H, W, radius, tint)
        stem = f"{i:03d}"
        cv.imwrite(os.path.join(img_dir, f"{stem}.png"), rgba)
        cams[f"world_mat_{stem}"] = (K @ np.linalg.inv(c2w)).astype(np.float32)
        cams[f"scale_mat_{stem}"] = np.eye(4, dtype=np.float32)
        c2ws.append(c2w)
        images.append(rgba)
    np.savez(os.path.join(img_dir, "cameras_sphere.npz"), **cams)
    feats = None
    if depth is not None:
        depth_dir, channels = depth
        fh, fw = scene["feature_hw"]
        feats = rng.standard_normal((n, channels, fh, fw), dtype=np.float32)
        os.makedirs(os.path.join(img_dir, depth_dir), exist_ok=True)
        for i in range(n):
            np.save(os.path.join(img_dir, depth_dir, f"{i:03d}.npy"), feats[i][None])
    return {"c2w": np.stack(c2ws), "K": K, "images": np.stack(images), "feats": feats}


def pixel_table(made: dict, feat_hw_to: tuple[int, int] | None = None) -> dict:
    """The per-pixel training data of the scene, worked out from what
    :func:`make` made: colour (white composite, BGR as stored) [n, H, W, 3],
    and for a depth head the features standardised by their global mean and
    std, squashed by a sigmoid, resized bilinearly to the image and rounded
    to float16, [n, H, W, c]."""
    imgs = made["images"] / 255.0
    rgb, a = imgs[..., :3], imgs[..., 3:]
    out = {"color": (rgb * a + (1.0 - a)).astype(np.float32), "feats": None}
    if made["feats"] is not None:
        f = made["feats"]
        m, s = float(np.mean(f)), float(np.std(f))
        f = 1.0 / (1.0 + np.exp(-((f - m) / s)))
        H, W = imgs.shape[1:3]
        up = np.empty(f.shape[:2] + (H, W), np.float32)
        for i in range(f.shape[0]):
            for c in range(f.shape[1]):
                up[i, c] = cv.resize(f[i, c].astype(np.float32), (W, H),
                                     interpolation=cv.INTER_LINEAR)
        out["feats"] = np.transpose(up, (0, 2, 3, 1)).astype(np.float16)
    return out
