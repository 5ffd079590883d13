"""Build network configs and the model from a HOCON model config.

Counterpart of ``vdnerf_tpu/train/builder.py``: maps ``model.{nerf,
sdf_network,rendering_network,neus_renderer}`` and, for the wdepth confs
(``extract_depth``), ``model.depth_extract_network`` onto the config
dataclasses, and builds the :class:`NeuSModel` with a seeded
``torch.Generator``.
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
    depth = None
    if extract_depth:
        depth = RenderConfig(**_kwargs(conf["model.depth_extract_network"], RenderConfig))
    return NeuSNetworks(
        sdf=SDFConfig(**_kwargs(conf["model.sdf_network"], SDFConfig)),
        color=RenderConfig(**_kwargs(conf["model.rendering_network"], RenderConfig)),
        nerf=NeRFConfig(**_kwargs(conf["model.nerf"], NeRFConfig)),
        renderer=RendererConfig(**_kwargs(conf["model.neus_renderer"], RendererConfig)),
        depth=depth,
    )


def build_model(conf: Config, nets: NeuSNetworks, seed: int = 0,
                matmul_dtype: torch.dtype | None = None, *, mlp_dtype: torch.dtype) -> NeuSModel:
    """A freshly initialised model (geometric-init SDF), on the CPU, its SDF
    network under the precision policy ``matmul_dtype`` and K2-K5 in the
    operand mode ``mlp_dtype`` (``models/precision.py``). One generator seeded
    with ``seed`` draws the networks' weights in the order nerf, sdf, colour,
    depth head."""
    gen = torch.Generator().manual_seed(seed)
    return NeuSModel(nets, conf.get_float("model.variance_network.init_val"), gen, matmul_dtype,
                     mlp_dtype=mlp_dtype)
