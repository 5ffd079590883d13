from vdnerf_tpu_torch.mesh.extract import (
    extract_fields,
    extract_geometry,
    load_ply,
    save_ply,
)
from vdnerf_tpu_torch.mesh.metrics import chamfer_distance, mesh_chamfer, sample_surface
from vdnerf_tpu_torch.mesh.native import marching_cubes

__all__ = [
    "chamfer_distance",
    "mesh_chamfer",
    "sample_surface",
    "extract_fields",
    "extract_geometry",
    "load_ply",
    "save_ply",
    "marching_cubes",
]
