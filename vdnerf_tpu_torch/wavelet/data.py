"""Host-side data pipeline for the monodepth side-car.

A copy of ``vdnerf_tpu/wavelet/data.py`` (numpy, cv2 and PIL), except that
:class:`BatchLoader` yields NCHW batches. It draws the same shuffles and
augmentations from the same seed. Parity with the reference's ``wavelet/data.py``:

- :class:`NeusDataset` (:300-366): images + ``depth_from_sdf`` pseudo-GT from
  the NeuS ``getfeats`` export. Depth is resized to the training resolution,
  scaled by ``/dpt_max*200`` and clipped to [0, 255]; background (mask < 100)
  is forced to 200. RGBA images are white-composited; otherwise mask files.
- NYU loaders (:84-132): zip archive / csv list of (image, depth) paths.
- Augmentations (:32-80): horizontal flip, channel swap, gamma — numpy-side.
- :func:`to_tensor_pair` (:169-243): resize to (800, 800) images and
  (400, 400) target depths (or 224/112 in the 224 variant).

Everything here is numpy/PIL on the host; batches cross to the device as
NCHW float32 (``train_lib.batch_to_device``).
"""

from __future__ import annotations

import io
import os
import zipfile
from pathlib import Path

import numpy as np

try:
    import cv2 as cv
except ImportError:  # pragma: no cover
    cv = None
try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None


def _imread(path) -> np.ndarray:
    return np.asarray(Image.open(path))


class NeusDataset:
    """(image, pseudo-depth, mask) triples from a NeuS getfeats export."""

    def __init__(
        self,
        data_root: str,
        imgdir: str = "image",
        dpt_max: float = 4.0,
        is_train: bool = False,
        image_size: int = 800,
    ):
        self.dpt_max = dpt_max
        self.is_train = is_train
        self.image_size = image_size
        self.data_root = Path(data_root) / imgdir

        self.image_names = [
            fn
            for fn in sorted(os.listdir(self.data_root))
            if fn.endswith(".png")
            and (self.data_root / "depth_from_sdf" / f"sdf_{fn[:-4]}.npy").exists()
        ]
        if not self.image_names:
            raise FileNotFoundError(
                f"no images with depth_from_sdf exports in {self.data_root}"
            )

        imgs = np.stack([_imread(self.data_root / fn) for fn in self.image_names])
        if imgs.shape[-1] == 4:
            masks = imgs[..., 3]
            a = (masks / 255.0)[..., None]
            imgs = imgs[..., :3] * a + (1.0 - a) * 255
        else:
            masks = np.stack(
                [
                    _imread(Path(data_root) / "mask" / f"{fn[:-4]}.png")
                    for fn in self.image_names
                ]
            )[..., 1]
        self.images_np = imgs.astype(np.float32)
        self.masks = masks

        depths = []
        h, w = imgs.shape[1:3]
        for fn in self.image_names:
            d = np.load(self.data_root / "depth_from_sdf" / f"sdf_{fn[:-4]}.npy")
            d = np.squeeze(d).astype(np.float32)
            if d.shape != (h, w):
                d = cv.resize(d, (w, h))
            depths.append(d)
        self.depths_np = (np.stack(depths) / dpt_max * 200.0).clip(0, 255)
        self.depths_np[self.masks < 100] = 200.0

    def __len__(self) -> int:
        return len(self.image_names)

    def __getitem__(self, idx: int) -> dict:
        img = self.images_np[idx]
        depth = self.depths_np[idx]
        mask = self.masks[idx].astype(np.float32) / 255.0
        return {
            "filename": self.image_names[idx],
            "image": img / 255.0,
            "depth": depth,
            "mask": mask,
        }


# ---------------------------------------------------------------------------
# augmentations (reference data.py:32-80)
# ---------------------------------------------------------------------------


def augment_sample(sample: dict, rng: np.random.Generator) -> dict:
    img, depth, mask = sample["image"], sample["depth"], sample["mask"]
    if rng.random() < 0.5:  # horizontal flip
        img = img[:, ::-1]
        depth = depth[:, ::-1]
        mask = mask[:, ::-1]
    if rng.random() < 0.25:  # channel swap
        img = img[..., rng.permutation(3)]
    if rng.random() < 0.25:  # gamma jitter (reference data.py:32-80)
        gamma = rng.uniform(0.9, 1.1)
        img = np.clip(img, 0.0, 1.0) ** gamma
    return dict(sample, image=img, depth=depth, mask=mask)


def to_tensor_pair(
    sample: dict, image_size: int = 800, depth_size: int = 400
) -> dict:
    """Resize to training resolution; returns HWC float32 arrays
    (reference ToTensor, data.py:169-243: image at S, depth/mask at S/2)."""
    img = cv.resize(np.asarray(sample["image"], np.float32),
                    (image_size, image_size))
    depth = cv.resize(np.asarray(sample["depth"], np.float32),
                      (depth_size, depth_size))
    mask = cv.resize(np.asarray(sample["mask"], np.float32),
                     (depth_size, depth_size))
    return {
        "image": img,
        "depth": depth[..., None],
        "mask": (mask > 0.5).astype(np.float32)[..., None],
        "filename": sample.get("filename", ""),
    }


class BatchLoader:
    """Minimal shuffling batch iterator over an indexable dataset; yields
    ``image`` [N, 3, S, S], ``depth`` and ``mask`` [N, 1, S/2, S/2]."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, image_size: int = 800, depth_size: int = 400,
                 augment: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.image_size = image_size
        self.depth_size = depth_size
        self.augment = augment

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idxs = order[start : start + self.batch_size]
            samples = []
            for i in idxs:
                s = self.dataset[int(i)]
                if self.augment:
                    s = augment_sample(s, self.rng)
                samples.append(
                    to_tensor_pair(s, self.image_size, self.depth_size)
                )
            yield {
                k: np.ascontiguousarray(
                    np.stack([s[k] for s in samples]).transpose(0, 3, 1, 2)
                )
                for k in ("image", "depth", "mask")
            }


# ---------------------------------------------------------------------------
# NYU data (reference data.py:84-132) — optional, used by the pretrainer
# ---------------------------------------------------------------------------


class NYUZipDataset:
    """(image, depth) pairs from the DenseDepth nyu_data.zip layout."""

    def __init__(self, zip_path: str, list_name: str = "data/nyu2_train.csv"):
        self.zf = zipfile.ZipFile(zip_path)
        listing = self.zf.read(list_name).decode("utf-8")
        self.pairs = [
            tuple(row.split(","))
            for row in listing.splitlines()
            if len(row.split(",")) == 2
        ]

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, idx: int) -> dict:
        img_p, depth_p = self.pairs[idx]
        img = np.asarray(
            Image.open(io.BytesIO(self.zf.read(img_p)))
        ).astype(np.float32) / 255.0
        depth = np.asarray(
            Image.open(io.BytesIO(self.zf.read(depth_p)))
        ).astype(np.float32)
        return {
            "filename": img_p,
            "image": img,
            "depth": depth,
            "mask": np.ones(depth.shape[:2], np.float32),
        }


def get_neus_train_test_data(
    data_root: str, imgdir: str = "image", batch_size: int = 4,
    dpt_max: float = 4.0, image_size: int = 800, seed: int = 0,
):
    """Train/test loaders over a NeuS scene (reference data.py:369-375)."""
    train_ds = NeusDataset(data_root, imgdir, dpt_max, is_train=True,
                           image_size=image_size)
    test_ds = NeusDataset(data_root, imgdir, dpt_max, is_train=False,
                          image_size=image_size)
    return (
        BatchLoader(train_ds, batch_size, shuffle=True, seed=seed,
                    image_size=image_size, depth_size=image_size // 2,
                    augment=True),
        BatchLoader(test_ds, batch_size, shuffle=False, seed=seed,
                    image_size=image_size, depth_size=image_size // 2),
    )
