"""Cameras: pixel -> ray math, and the learned poses and focal.

Counterpart of ``vdnerf_tpu/data/cameras.py``:

- :func:`pixels_to_rays`, :func:`rays_grid`: rays of pixels for a c2w pose
  and an inverse intrinsic matrix (fixed or learned cameras alike).
- :func:`interpolate_pose`, :func:`rays_between`: a pose between two cameras
  (rotation slerped, translation lerped, both in the w2c frame) and its ray
  grid, for the novel-view sweep.
- :class:`LearnedCameras`: the learnable confs' cameras (``focal_learnable``,
  the reference's LearnPose / LearnIntrin): per camera an axis-angle ``r``
  and a translation ``t``, composed as a delta on the initial c2w, and one
  focal parameter ``fx`` (focal = fx^2 W at order 2, fx W at order 1) with
  the principal point fixed at (W/2, H/2). K is built differentiably, so the
  focal gets its gradient (the reference detaches it through ``.item()``).
  Everything a training step calls is safe to capture in a CUDA graph: the
  camera is picked by ``index_select`` and K's inverse is its closed form
  (``torch.linalg.inv`` reads its status on the host).
- :func:`perturb_poses`: COLMAP-grade camera noise for pose-refinement runs
  (numpy and scipy).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from vdnerf_tpu_torch.utils.so3 import make_c2w, slerp


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


def interpolate_pose(pose_0: torch.Tensor, pose_1: torch.Tensor, ratio) -> torch.Tensor:
    """c2w [4, 4] between two c2w poses: the w2c rotations slerped and the
    w2c translations lerped at ``ratio``, then inverted back."""
    inv0 = torch.linalg.inv(pose_0)
    inv1 = torch.linalg.inv(pose_1)
    pose = torch.eye(4, dtype=pose_0.dtype, device=pose_0.device)
    pose[:3, :3] = slerp(inv0[:3, :3], inv1[:3, :3], ratio)
    pose[:3, 3] = (1.0 - ratio) * inv0[:3, 3] + ratio * inv1[:3, 3]
    return torch.linalg.inv(pose)


def rays_between(
    pose_0: torch.Tensor,
    pose_1: torch.Tensor,
    intrinsic_inv: torch.Tensor,
    ratio,
    H: int,
    W: int,
    resolution_level: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The ray grid of :func:`rays_grid` from :func:`interpolate_pose`."""
    return rays_grid(interpolate_pose(pose_0, pose_1, ratio), intrinsic_inv, H, W,
                     resolution_level)


# -- learned cameras ----------------------------------------------------------


def init_focal_params(init_focal: float | None, W: int, order: int = 2) -> float:
    """The focal parameter fx of an initial focal length (1.0 without one),
    in f32 as the JAX package computes it."""
    if init_focal is None:
        return 1.0
    if order == 2:
        return float(np.sqrt(np.float32(init_focal / float(W))))
    if order == 1:
        return float(np.float32(init_focal / float(W)))
    raise ValueError("focal order must be 1 or 2")


def learn_intrin_K(fx: torch.Tensor, H: int, W: int, order: int = 2) -> torch.Tensor:
    """Differentiable 4x4 K of the focal parameter ``fx`` (shape [])."""
    f = fx**2 * W if order == 2 else fx * W
    zero, one = torch.zeros_like(f), torch.ones_like(f)
    return torch.stack([
        torch.stack([f, zero, zero + W / 2.0, zero]),
        torch.stack([zero, f, zero + H / 2.0, zero]),
        torch.stack([zero, zero, one, zero]),
        torch.stack([zero, zero, zero, one]),
    ])


def learn_intrin_K_inv(fx: torch.Tensor, H: int, W: int, order: int = 2) -> torch.Tensor:
    """The inverse of :func:`learn_intrin_K` in closed form,
    [[1/f, 0, -W/2f, 0], [0, 1/f, -H/2f, 0], [0, 0, 1, 0], [0, 0, 0, 1]]."""
    f = fx**2 * W if order == 2 else fx * W
    inv_f = 1.0 / f
    zero, one = torch.zeros_like(f), torch.ones_like(f)
    return torch.stack([
        torch.stack([inv_f, zero, -(W / 2.0) * inv_f, zero]),
        torch.stack([zero, inv_f, -(H / 2.0) * inv_f, zero]),
        torch.stack([zero, zero, one, zero]),
        torch.stack([zero, zero, zero, one]),
    ])


def learn_pose_c2w(r: torch.Tensor, t: torch.Tensor, init_c2w: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """c2w [len(idx), 4, 4] of the cameras ``idx`` (an index tensor):
    exp(r), t as a delta on the initial pose."""
    return make_c2w(r.index_select(0, idx), t.index_select(0, idx)) @ \
        init_c2w.index_select(0, idx)


def all_learned_c2w(r: torch.Tensor, t: torch.Tensor, init_c2w: torch.Tensor) -> torch.Tensor:
    """[n, 4, 4] learned poses of every camera."""
    return make_c2w(r, t) @ init_c2w


class LearnedCameras(nn.Module):
    """The learnable confs' cameras: parameters ``r``, ``t`` [n, 3] (zero at
    the start), ``fx`` [] and the buffer ``init_c2w`` [n, 4, 4]; ``order``
    is the conf's ``model.focal.order``. Its state_dict keys are the
    reference's pnf checkpoint keys (``pose_param_net`` r, t, init_c2w;
    ``intrin_net`` fx)."""

    def __init__(self, init_c2w, init_focal: float | None, H: int, W: int, order: int = 2):
        super().__init__()
        init_c2w = torch.as_tensor(np.asarray(init_c2w, np.float32))
        n = init_c2w.shape[0]
        self.H, self.W, self.order = H, W, order
        self.r = nn.Parameter(torch.zeros(n, 3))
        self.t = nn.Parameter(torch.zeros(n, 3))
        self.fx = nn.Parameter(torch.tensor(init_focal_params(init_focal, W, order),
                                            dtype=torch.float32))
        self.register_buffer("init_c2w", init_c2w)

    def pose_params(self) -> list[nn.Parameter]:
        return [self.r, self.t]

    def c2w(self, idx: torch.Tensor) -> torch.Tensor:
        return learn_pose_c2w(self.r, self.t, self.init_c2w, idx)

    def all_c2w(self) -> torch.Tensor:
        return all_learned_c2w(self.r, self.t, self.init_c2w)

    def K_inv(self) -> torch.Tensor:
        return learn_intrin_K_inv(self.fx, self.H, self.W, self.order)


def perturb_poses(poses, rng, rot_scale: float = 0.025, trans_scale: float = 0.02):
    """COLMAP-grade camera noise: left-multiply each rotation by a random
    rotation vector (about 2 degrees of geodesic angle on average at the
    default scale) and jitter the translations; ``rng`` a numpy Generator."""
    from scipy.spatial.transform import Rotation

    out = np.array(poses, copy=True)
    for i in range(out.shape[0]):
        out[i, :3, :3] = (
            Rotation.from_rotvec(rng.normal(scale=rot_scale, size=3)).as_matrix()
            .astype(out.dtype) @ out[i, :3, :3]
        )
        out[i, :3, 3] += rng.normal(scale=trans_scale, size=3)
    return out
