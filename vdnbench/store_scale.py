"""The host's pixel gather against the size of the scene's store.

    python3 vdnbench/store_scale.py [--steps 3000] [--out FILE]

Times the training loop's ``RayStore.sample_pixels`` (512 uniform pixels of
one image a step, the images in the runner's permuted order) on two stores
built in memory with the same layout as the program's: the cells' scene (8
views of 400x300) and a DTU scan's (49 views of 1600x1200), each without
features (womsk) and with 96 float16 channels a pixel (wdepth). Every page
of each store is written before the timing. Prints one JSON line a store:
microseconds a step, the median of 5 passes. The benchmark's own runs run
none of this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORES = {"cell": (8, 300, 400), "dtu": (49, 1200, 1600)}


def build(n: int, H: int, W: int, channels: int, rng: np.random.Generator):
    """A RayStore of n views of H x W, every element written."""
    from vdnerf_tpu_torch.data.rays import RayStore

    s = RayStore.__new__(RayStore)
    s.n_images, s.H, s.W, s.with_depth = n, H, W, channels > 0
    view = rng.random((H, W, 3), dtype=np.float32)
    s.images = np.empty((n, H, W, 3), np.float32)
    s.masks = np.empty((n, H, W, 3), np.float32)
    s.images[:] = view
    s.masks[:] = view
    s.feat_dim = max(channels, 1)
    if channels:
        feats = rng.random((H, W, channels), dtype=np.float32).astype(np.float16)
        s.depth_feats = np.empty((n, H, W, channels), np.float16)
        s.depth_feats[:] = feats
    return s


def time_steps(store, steps: int, seed: int) -> float:
    """Microseconds a ``sample_pixels`` call, over ``steps`` calls."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(store.n_images)
    t0 = time.perf_counter()
    for k in range(steps):
        store.sample_pixels(int(perm[k % store.n_images]), 512, rng)
    return (time.perf_counter() - t0) / steps * 1e6


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--passes", type=int, default=5)
    p.add_argument("--stores", default="cell,dtu")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    rng = np.random.default_rng(0)
    for channels in (0, 96):
        for name in args.stores.split(","):
            n, H, W = STORES[name]
            t0 = time.perf_counter()
            store = build(n, H, W, channels, rng)
            built = time.perf_counter() - t0
            us = sorted(time_steps(store, args.steps, i) for i in range(args.passes))
            size = store.images.nbytes * 2 + (store.depth_feats.nbytes if channels else 0)
            line = json.dumps({"store": name, "views": n, "H": H, "W": W, "channels": channels,
                               "bytes": size, "build_s": built, "us_per_step": us,
                               "us_median": us[len(us) // 2]})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
            del store
    return 0


if __name__ == "__main__":
    sys.exit(main())
