"""Build network configs and the model from a HOCON model config.

Counterpart of ``vdnerf_tpu/train/builder.py``: maps ``model.{nerf,
sdf_network,rendering_network,neus_renderer}`` onto the config dataclasses,
and builds the :class:`NeuSModel` with a seeded ``torch.Generator``.
"""

from __future__ import annotations

from typing import Any

import torch

from vdnerf_tpu_torch.models.fields import NeRFConfig, RenderConfig, SDFConfig
from vdnerf_tpu_torch.ops.renderer import NeuSModel, NeuSNetworks, RendererConfig
from vdnerf_tpu_torch.utils.hocon import Config


def _kwargs(block: Config, cls) -> dict[str, Any]:
    allowed = {f.name for f in cls.__dataclass_fields__.values()}
    out = {}
    for k in block.keys():
        if k in allowed:
            v = block[k]
            out[k] = tuple(v) if isinstance(v, list) else v
    return out


def build_networks(conf: Config, extract_depth: bool = False) -> NeuSNetworks:
    if extract_depth:
        raise NotImplementedError(
            "the depth-feature head (wdepth confs) is not ported yet"
        )
    return NeuSNetworks(
        sdf=SDFConfig(**_kwargs(conf["model.sdf_network"], SDFConfig)),
        color=RenderConfig(**_kwargs(conf["model.rendering_network"], RenderConfig)),
        nerf=NeRFConfig(**_kwargs(conf["model.nerf"], NeRFConfig)),
        renderer=RendererConfig(**_kwargs(conf["model.neus_renderer"], RendererConfig)),
    )


def build_model(conf: Config, nets: NeuSNetworks, seed: int = 0) -> NeuSModel:
    """A freshly initialised model (geometric-init SDF), on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    return NeuSModel(nets, conf.get_float("model.variance_network.init_val"), gen)
