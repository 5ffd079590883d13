"""Training metrics and throughput.

Counterpart of ``vdnerf_tpu/io/logging.py``: ``logs/metrics.jsonl`` with one
record per written step under the same scalar names (``loss``,
``color_loss``, ``eikonal_loss``, ``mask_loss``, ``psnr``, ``s_val``,
``cdf``, ``weight_max``, ``rays_per_sec``). The port writes no TensorBoard
events: where the JAX writer adds an image or a histogram to its event file
(the monodepth side-car's validation logging), this one writes
``images/<tag>/<step:06d>.png`` and a ``histograms.jsonl`` record under the
same tag and step.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


class MetricsWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._hist = None

    def write(self, step: int, metrics: dict) -> None:
        rec = {"step": int(step)}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(rec) + "\n")

    def write_image(self, step: int, tag: str, img) -> None:
        """An HWC image, uint8 or float in [0, 1] (RGB, or one channel)."""
        import cv2 as cv

        arr = np.asarray(img)
        if arr.dtype != np.uint8:
            arr = (arr * 255).clip(0, 255).astype(np.uint8)
        if arr.ndim == 3 and arr.shape[-1] == 3:
            arr = arr[..., ::-1]  # cv2 writes BGR
        path = os.path.join(self.log_dir, "images", tag, f"{int(step):06d}.png")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if not cv.imwrite(path, np.ascontiguousarray(arr)):
            raise OSError(f"could not write {path}")

    def write_histogram(self, step: int, tag: str, values) -> None:
        counts, edges = np.histogram(np.asarray(values, np.float64).ravel(), bins=64)
        if self._hist is None:
            self._hist = open(os.path.join(self.log_dir, "histograms.jsonl"), "a")
        self._hist.write(json.dumps({"step": int(step), "tag": tag, "counts": counts.tolist(),
                                     "edges": edges.tolist()}) + "\n")

    def flush(self) -> None:
        self._jsonl.flush()
        if self._hist is not None:
            self._hist.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._hist is not None:
            self._hist.close()


class Throughput:
    """Rays/s as an EMA over train steps (host clock between ticks)."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self._last = None
        self.rays_per_sec = 0.0

    def tick(self, n_steps: int = 1) -> float:
        now = time.perf_counter()
        if self._last is not None:
            inst = n_steps * self.batch_size / max(now - self._last, 1e-9)
            self.rays_per_sec = (
                inst if self.rays_per_sec == 0.0 else 0.9 * self.rays_per_sec + 0.1 * inst
            )
        self._last = now
        return self.rays_per_sec
