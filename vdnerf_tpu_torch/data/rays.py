"""Host-side image/mask/depth-feature store for one scene.

Counterpart of ``vdnerf_tpu/data/rays.py``:

- RGBA inputs: white composite rgb*a + (1-a); mask = alpha.
- RGB inputs + mask files: composite img*mask + (1-mask).
- Images stay in BGR order (cv.imread / cv.imwrite without conversion).
- Depth features (wdepth confs): per-image ``.npy`` stacks, squeezed,
  standardised by one global mean and std over all images and channels,
  squashed by a sigmoid, bilinearly resized per channel to the image size,
  and kept on the host as float16 ``[n, H, W, c]``.
- :meth:`RayStore.sample_pixels` draws a pixel batch from a numpy
  ``Generator`` exactly as the JAX package does, so one seed gives the same
  batches in both packages.

Spans (``utils/trace.py``): ``setup.features`` (the feature stack's
standardisation and resize), ``data.sample`` (a batch's draw and its gather)
and, inside it, ``data.gather_feats`` (the depth features' gather).
"""

from __future__ import annotations

import cv2 as cv
import numpy as np

from vdnerf_tpu_torch.utils import trace


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


class RayStore:
    """Host store for the per-pixel training data of one scene."""

    def __init__(self, images_lis: list[str], masks_lis: list[str] | None,
                 depth_lis: list[str] | None = None, with_depth: bool = False):
        self.images_lis = images_lis
        self.n_images = len(images_lis)
        self.with_depth = with_depth

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

        self.feat_dim = 1
        if with_depth:
            with trace.span("setup.features"):
                self._load_features(depth_lis)

    def _load_features(self, depth_lis: list[str]) -> None:
        """The depth features, standardised, squashed and resized to the images."""
        feats = np.stack([np.squeeze(np.load(p)) for p in depth_lis])
        m, s = float(np.mean(feats)), float(np.std(feats))
        feats = _sigmoid((feats - m) / s)
        if feats.ndim == 3:  # [n, h, w] -> [n, 1, h, w]
            feats = feats[:, None]
        n, c, fh, fw = feats.shape
        if (fh, fw) != (self.H, self.W):
            up = np.empty((n, c, self.H, self.W), dtype=np.float32)
            for i in range(n):
                for ch in range(c):
                    up[i, ch] = cv.resize(feats[i, ch].astype(np.float32), (self.W, self.H),
                                          interpolation=cv.INTER_LINEAR)
            feats = up
        self.depth_feats = np.transpose(feats, (0, 2, 3, 1)).astype(np.float16)
        self.feat_dim = self.depth_feats.shape[-1]
        if self.depth_feats.shape[:3] != self.images.shape[:3]:
            raise ValueError(f"depth features {self.depth_feats.shape} do not match the "
                             f"images {self.images.shape}")

    def sample_pixels(self, img_idx: int, batch_size: int,
                      rng: np.random.Generator) -> dict[str, np.ndarray]:
        """Uniform random pixels of one image -> host numpy batch:
        img_idx, pixels_x/y int32 [B], color [B, 3], mask [B, 1] and feats
        [B, feat_dim] f32 (zeros [B, 1] without depth features)."""
        with trace.span("data.sample"):
            px = rng.integers(0, self.W, size=batch_size).astype(np.int32)
            py = rng.integers(0, self.H, size=batch_size).astype(np.int32)
            if self.with_depth:
                with trace.span("data.gather_feats"):
                    feats = self.depth_feats[img_idx, py, px].astype(np.float32)
            else:
                feats = np.zeros((batch_size, 1), dtype=np.float32)
            return {
                "img_idx": np.int32(img_idx),
                "pixels_x": px,
                "pixels_y": py,
                "color": self.images[img_idx, py, px],
                "mask": self.masks[img_idx, py, px, :1],
                "feats": feats,
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
