from vdnerf_tpu_torch.data.dataset import SceneData, load_K_Rt_from_P, near_far_from_sphere
from vdnerf_tpu_torch.data.rays import RayStore

__all__ = ["SceneData", "load_K_Rt_from_P", "near_far_from_sphere", "RayStore"]
