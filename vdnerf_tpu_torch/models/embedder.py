"""NeRF positional encoding.

Counterpart of ``vdnerf_tpu/models/embedder.py``: include_input=True,
frequency bands 2^0 .. 2^(multires-1), ordering
``[x | sin(f0 x) | cos(f0 x) | sin(f1 x) | cos(f1 x) | ...]``. The ordering
matters: the SDF's geometric init zeroes the weight columns that read the
non-xyz part of the embedding.
"""

from __future__ import annotations

import numpy as np
import torch


def freqs(multires: int) -> tuple[float, ...]:
    if multires <= 0:
        return ()
    return tuple(
        float(f)
        for f in 2.0 ** np.linspace(0.0, multires - 1, multires).astype(np.float32)
    )


def embed(x: torch.Tensor, multires: int) -> torch.Tensor:
    """[..., d] -> [..., d * (1 + 2 L)]; identity when multires <= 0."""
    if multires <= 0:
        return x
    parts = [x]
    for f in freqs(multires):
        parts.append(torch.sin(x * f))
        parts.append(torch.cos(x * f))
    return torch.cat(parts, dim=-1)


def embed_dim(multires: int, input_dims: int = 3) -> int:
    if multires <= 0:
        return input_dims
    return input_dims * (1 + 2 * multires)
