"""Rotation and rigid-transform utilities: batched, differentiable, and safe
to capture in a CUDA graph (no host reads, no host-to-device copies).

Counterpart of ``vdnerf_tpu/utils/so3.py``: Rodrigues ``so3_exp`` and
``make_c2w`` (the reference's ``lie_group_helper.py`` Exp / make_c2w),
quaternion conversions and ``slerp`` (novel-view interpolation), and the
host-side ``umeyama`` similarity fit (numpy) for gauge-aligned pose QC.
"""

from __future__ import annotations

import numpy as np
import torch


def vec2skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] axis vectors -> [..., 3, 3] skew-symmetric matrices."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def so3_exp(r: torch.Tensor) -> torch.Tensor:
    """so(3) axis-angle [..., 3] -> SO(3) matrices [..., 3, 3] (Rodrigues).

    Differentiable at r = 0, where the learned deltas start: |r| is never
    formed there. A double ``where`` keeps the untaken branch finite in the
    backward pass (theta's powers underflow f32 near zero), as the JAX
    function does."""
    skew = vec2skew(r)
    sq = torch.sum(r * r, dim=-1)[..., None, None]
    small = sq < 1e-8
    safe_sq = torch.where(small, torch.ones_like(sq), sq)
    theta = torch.sqrt(safe_sq)
    a = torch.where(small, 1.0 - sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - sq / 24.0, (1.0 - torch.cos(theta)) / safe_sq)
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(skew.shape)
    return eye + a * skew + b * (skew @ skew)


def make_c2w(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] + translation [..., 3] -> [..., 4, 4] c2w."""
    top = torch.cat([so3_exp(r), t[..., :, None]], dim=-1)
    bottom = torch.cat([torch.zeros_like(t), torch.ones_like(t[..., :1])], dim=-1)
    return torch.cat([top, bottom[..., None, :]], dim=-2)


def mat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation matrices -> [..., 4] quaternions (w, x, y, z):
    Shepperd's four constructions, the best-conditioned one picked."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    cases = torch.stack([
        torch.stack([1 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], dim=-1),
    ], dim=-2)
    idx = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    q = torch.gather(cases, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] quaternions (w, x, y, z) -> [..., 3, 3] rotation matrices."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def slerp(R0: torch.Tensor, R1: torch.Tensor, ratio) -> torch.Tensor:
    """Spherical interpolation between two rotation matrices (a linear blend
    of the quaternions where the rotations nearly coincide)."""
    q0, q1 = mat_to_quat(R0), mat_to_quat(R1)
    dot = torch.sum(q0 * q1, dim=-1)
    q1 = torch.where(dot[..., None] < 0, -q1, q1)
    theta = torch.arccos(torch.clamp(dot.abs(), -1.0, 1.0))
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < 1e-6
    safe_sin = torch.where(use_lerp, torch.ones_like(sin_theta), sin_theta)
    ratio = torch.as_tensor(ratio, dtype=q0.dtype, device=q0.device)
    w0 = torch.where(use_lerp, 1.0 - ratio, torch.sin((1.0 - ratio) * theta) / safe_sin)
    w1 = torch.where(use_lerp, ratio, torch.sin(ratio * theta) / safe_sin)
    return quat_to_mat(w0[..., None] * q0 + w1[..., None] * q1)


def umeyama(src, dst) -> tuple[float, np.ndarray, np.ndarray]:
    """Least-squares similarity (s, R, t) with s R src_i + t ~= dst_i from
    3-D point sets (numpy, host only; Umeyama 1991). Learned cameras are
    fixed only up to a global similarity, so learned-vs-true pose and mesh
    comparisons quotient it out first; fit it from camera centres."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    U, D, Vt = np.linalg.svd(dc.T @ sc / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / ((sc**2).sum() / len(src)))
    return s, R, mu_d - s * R @ mu_s
