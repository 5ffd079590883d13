"""Host-side image/mask store for one scene.

Counterpart of the image part of ``vdnerf_tpu/data/rays.py``:

- RGBA inputs: white composite rgb*a + (1-a); mask = alpha.
- RGB inputs + mask files: composite img*mask + (1-mask).
- Images stay in BGR order (cv.imread / cv.imwrite without conversion).
- :meth:`RayStore.sample_pixels` draws a pixel batch from a numpy
  ``Generator`` exactly as the JAX package does, so one seed gives the same
  batches in both packages.

The depth-feature pipeline (wdepth confs) is not ported yet.
"""

from __future__ import annotations

import cv2 as cv
import numpy as np


class RayStore:
    """Host store for the images and masks of one scene."""

    def __init__(self, images_lis: list[str], masks_lis: list[str] | None):
        self.images_lis = images_lis
        self.n_images = len(images_lis)

        imgs = np.stack([cv.imread(p, -1) for p in images_lis]) / 255.0
        if imgs.shape[-1] == 4:
            rgb, a = imgs[..., :3], imgs[..., 3:]
            self.images_np = rgb * a + (1.0 - a)  # white composite
            self.masks_np = np.repeat(a, 3, axis=-1)
        else:
            masks = np.stack([cv.imread(p) for p in masks_lis]) / 255.0
            self.masks_np = masks
            self.images_np = imgs * masks + (1.0 - masks)
        self.images = self.images_np.astype(np.float32)
        self.masks = self.masks_np.astype(np.float32)
        self.H, self.W = self.images_np.shape[1], self.images_np.shape[2]

    def sample_pixels(self, img_idx: int, batch_size: int,
                      rng: np.random.Generator) -> dict[str, np.ndarray]:
        """Uniform random pixels of one image -> host numpy batch:
        img_idx, pixels_x/y int32 [B], color [B, 3], mask [B, 1]."""
        px = rng.integers(0, self.W, size=batch_size).astype(np.int32)
        py = rng.integers(0, self.H, size=batch_size).astype(np.int32)
        return {
            "img_idx": np.int32(img_idx),
            "pixels_x": px,
            "pixels_y": py,
            "color": self.images[img_idx, py, px],
            "mask": self.masks[img_idx, py, px, :1],
        }

    def image_at(self, idx: int, resolution_level: int = 1) -> np.ndarray:
        img = self.images_np[idx]
        out = cv.resize(img, (self.W // resolution_level, self.H // resolution_level))
        return (out * 255).clip(0, 255)

    def mask_at(self, idx: int, resolution_level: int = 1) -> np.ndarray:
        msk = cv.resize(
            self.masks_np[idx], (self.W // resolution_level, self.H // resolution_level)
        )
        return np.expand_dims(msk, axis=-1) if msk.ndim == 2 else msk[..., :1]
