"""Pixel -> ray math for fixed cameras.

Counterpart of ``pixels_to_rays`` and ``rays_grid`` in
``vdnerf_tpu/data/cameras.py``. Learned poses and intrinsics come with the
learned-cameras slice.
"""

from __future__ import annotations

import torch


def pixels_to_rays(
    pose: torch.Tensor,
    intrinsic_inv: torch.Tensor,
    pixels_x: torch.Tensor,
    pixels_y: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """pose: [4, 4] c2w; intrinsic_inv: [4, 4] or [3, 3]; pixels: [...].
    Returns (rays_o [..., 3], rays_d [..., 3]) with unit directions."""
    p = torch.stack(
        [pixels_x.float(), pixels_y.float(), torch.ones_like(pixels_x, dtype=torch.float32)],
        dim=-1,
    )
    p = torch.einsum("ij,...j->...i", intrinsic_inv[:3, :3], p)
    rays_v = p / torch.linalg.norm(p, dim=-1, keepdim=True)
    rays_v = torch.einsum("ij,...j->...i", pose[:3, :3], rays_v)
    rays_o = pose[:3, 3].expand(rays_v.shape)
    return rays_o, rays_v


def rays_grid(
    pose: torch.Tensor,
    intrinsic_inv: torch.Tensor,
    H: int,
    W: int,
    resolution_level: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-image ray grid at a resolution level, [H//l, W//l, 3] pair, on
    the pixel grid linspace(0, W-1, W//l) x linspace(0, H-1, H//l)."""
    l = resolution_level
    dev = pose.device
    tx = torch.linspace(0, W - 1, W // l, device=dev)
    ty = torch.linspace(0, H - 1, H // l, device=dev)
    px, py = torch.meshgrid(tx, ty, indexing="xy")
    return pixels_to_rays(pose, intrinsic_inv, px, py)
