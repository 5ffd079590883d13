"""gen_cameras CLI (counterpart of ``vdnerf_tpu.colmap.gen_cameras_cli``).

Usage:
    python -m vdnerf_tpu_torch.colmap.gen_cameras_cli <work_dir>

Requires ``poses.npy`` (from imgs2poses) and a user-cropped
``sparse_points_interest.ply`` in <work_dir>; writes
``cameras_sphere_colmap.npz``.
"""

from __future__ import annotations

import sys

from vdnerf_tpu_torch.colmap.pipeline import gen_cameras


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        raise SystemExit("usage: gen_cameras_cli <work_dir>")
    gen_cameras(argv[0])


if __name__ == "__main__":
    main()
