"""Training metrics and throughput.

Counterpart of ``vdnerf_tpu/io/logging.py``: ``logs/metrics.jsonl`` with one
record per written step under the same scalar names (``loss``,
``color_loss``, ``eikonal_loss``, ``mask_loss``, ``psnr``, ``s_val``,
``cdf``, ``weight_max``, ``rays_per_sec``). JSONL only: the port writes no
TensorBoard events.
"""

from __future__ import annotations

import json
import os
import time


class MetricsWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def write(self, step: int, metrics: dict) -> None:
        rec = {"step": int(step)}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(rec) + "\n")

    def flush(self) -> None:
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()


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
