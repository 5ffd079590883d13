from vdnerf_tpu_torch.train.builder import build_model, build_networks
from vdnerf_tpu_torch.train.config import TrainConfig

__all__ = ["build_model", "build_networks", "TrainConfig"]
