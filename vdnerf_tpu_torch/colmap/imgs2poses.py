"""imgs2poses CLI (counterpart of ``vdnerf_tpu.colmap.imgs2poses``, flag for flag).

Usage:
    python -m vdnerf_tpu_torch.colmap.imgs2poses <scenedir> [--match_type ...]
"""

from __future__ import annotations

import argparse

from vdnerf_tpu_torch.colmap.pipeline import gen_poses


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--match_type", type=str, default="exhaustive_matcher",
        choices=["exhaustive_matcher", "sequential_matcher"],
    )
    parser.add_argument("scenedir", type=str)
    args = parser.parse_args(argv)
    gen_poses(args.scenedir, args.match_type)


if __name__ == "__main__":
    main()
