"""Plain reference of the novel-view sweep's cameras: a pose between two
cameras (the w2c rotations slerped through quaternions, the w2c translations
lerped, then inverted back) and its ray grid at a resolution level, the
pixel grid ``linspace(0, W - 1, W // l)`` by ``linspace(0, H - 1, H // l)``.
"""

from __future__ import annotations

import math

import torch

from vdnbench.reference.neus import rays_of_pixels


def sweep_ratio(i: int, n_frames: int) -> float:
    """The sine-eased position of frame ``i`` of a sweep of ``n_frames``."""
    return math.sin(((i / n_frames) - 0.5) * math.pi) * 0.5 + 0.5


def mat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """A rotation matrix -> its unit quaternion (w, x, y, z), from the best
    conditioned of Shepperd's four constructions."""
    m = R
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    cases = torch.stack([
        torch.stack([1 + tr, m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]]),
        torch.stack([m[2, 1] - m[1, 2], 1 + m[0, 0] - m[1, 1] - m[2, 2], m[0, 1] + m[1, 0],
                     m[0, 2] + m[2, 0]]),
        torch.stack([m[0, 2] - m[2, 0], m[0, 1] + m[1, 0], 1 - m[0, 0] + m[1, 1] - m[2, 2],
                     m[1, 2] + m[2, 1]]),
        torch.stack([m[1, 0] - m[0, 1], m[0, 2] + m[2, 0], m[1, 2] + m[2, 1],
                     1 - m[0, 0] - m[1, 1] + m[2, 2]]),
    ])
    q = cases[int(torch.argmax(torch.stack([tr, m[0, 0], m[1, 1], m[2, 2]])))]
    return q / q.norm()


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q / q.norm()
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
    ])


def slerp(R0: torch.Tensor, R1: torch.Tensor, t: float) -> torch.Tensor:
    q0, q1 = mat_to_quat(R0), mat_to_quat(R1)
    dot = (q0 * q1).sum()
    if dot < 0:
        q1, dot = -q1, -dot
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    if torch.sin(theta) < 1e-6:
        return quat_to_mat((1.0 - t) * q0 + t * q1)
    s = torch.sin(theta)
    return quat_to_mat(torch.sin((1.0 - t) * theta) / s * q0 + torch.sin(t * theta) / s * q1)


def pose_between(c2w_0: torch.Tensor, c2w_1: torch.Tensor, t: float) -> torch.Tensor:
    inv0, inv1 = torch.linalg.inv(c2w_0), torch.linalg.inv(c2w_1)
    w2c = torch.eye(4, dtype=c2w_0.dtype, device=c2w_0.device)
    w2c[:3, :3] = slerp(inv0[:3, :3], inv1[:3, :3], t)
    w2c[:3, 3] = (1.0 - t) * inv0[:3, 3] + t * inv1[:3, 3]
    return torch.linalg.inv(w2c)


def rays_between(c2w_0, c2w_1, K_inv, t: float, H: int, W: int, level: int):
    """Rays [H // level, W // level, 3] (origins, directions) of the pose at
    ``t`` between two cameras, through ``K_inv``."""
    c2w = pose_between(c2w_0, c2w_1, t)
    dev = c2w.device
    px, py = torch.meshgrid(torch.linspace(0, W - 1, W // level, device=dev),
                            torch.linspace(0, H - 1, H // level, device=dev), indexing="xy")
    return rays_of_pixels(c2w, K_inv, px, py)
