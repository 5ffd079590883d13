from vdnerf_tpu_torch.colmap.pipeline import (
    gen_cameras,
    gen_poses,
    load_colmap_data,
    run_colmap,
    save_poses,
)

__all__ = [
    "gen_cameras",
    "gen_poses",
    "load_colmap_data",
    "run_colmap",
    "save_poses",
]
