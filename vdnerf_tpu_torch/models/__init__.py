from vdnerf_tpu_torch.models.fields import (
    NeRF,
    NeRFConfig,
    RenderConfig,
    RenderingNetwork,
    SDFConfig,
    SDFNetwork,
    SingleVarianceNetwork,
)

__all__ = [
    "NeRF",
    "NeRFConfig",
    "RenderConfig",
    "RenderingNetwork",
    "SDFConfig",
    "SDFNetwork",
    "SingleVarianceNetwork",
]
