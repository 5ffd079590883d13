"""K1: gradient-free SDF value, as a CUDA kernel and its plain version.

Replaces ``vdnerf_tpu/ops/pallas/sdf_fwd.py::sdf_value_pallas``. The kernel
(``csrc/sdf_fwd.cu``) is f32 throughout and operation-bound; see the source
for its design. The up-sample ladder's stop-gradient SDF queries go through
:func:`sdf_value`.

On a CPU tensor :func:`sdf_value` runs :func:`sdf_value_plain`; on a CUDA
tensor it launches the kernel, and a build or launch failure raises.
"""

from __future__ import annotations

import math

import torch

from vdnerf_tpu_torch.models.embedder import embed
from vdnerf_tpu_torch.models.layers import softplus_beta
from vdnerf_tpu_torch.ops.kernels import build

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def sdf_value_plain(
    pts: torch.Tensor,
    ws: list[torch.Tensor],
    bs: list[torch.Tensor],
    skip_in: tuple[int, ...],
    multires: int,
    scale: float,
) -> torch.Tensor:
    """[N, 3] -> [N, 1]. ws: effective [in, out] f32 weights, the last one
    sliced to the sdf column."""
    inputs = embed(pts * scale, multires)
    x = inputs
    for l, (w, b) in enumerate(zip(ws, bs)):
        if l in skip_in:
            x = torch.cat([x, inputs], dim=-1) * _INV_SQRT2
        x = x @ w + b
        if l < len(ws) - 1:
            x = softplus_beta(x, 100.0)
    return x[:, :1] / scale


def sdf_value(
    pts: torch.Tensor,
    ws: list[torch.Tensor],
    bs: list[torch.Tensor],
    skip_in: tuple[int, ...],
    multires: int,
    scale: float,
) -> torch.Tensor:
    """[N, 3] f32 -> [N, 1] f32 signed distance (see module docstring)."""
    if pts.device.type == "cpu":
        return sdf_value_plain(pts, ws, bs, skip_in, multires, scale)
    if pts.device.type != "cuda":
        raise ValueError(f"sdf_value: unsupported device {pts.device}")
    if pts.dim() != 2 or pts.shape[1] != 3 or pts.dtype != torch.float32:
        raise ValueError(f"sdf_value: pts must be [N, 3] f32, got {tuple(pts.shape)} {pts.dtype}")
    pts = pts.contiguous()
    ws = [w.detach().float().contiguous() for w in ws]
    bs = [b.detach().float().reshape(-1).contiguous() for b in bs]
    meta = [len(ws), sum(1 << l for l in skip_in if l < len(ws)), multires]
    woff = boff = 0
    for w, b in zip(ws, bs):
        if w.device != pts.device or w.shape[1] != b.shape[0]:
            raise ValueError("sdf_value: weight/bias shapes or devices disagree")
        meta += [w.shape[0], w.shape[1], woff, boff]
        woff += w.numel()
        boff += b.numel()
    W = torch.cat([w.reshape(-1) for w in ws])
    B = torch.cat(bs)
    n = pts.shape[0]
    out = torch.empty(n, 1, device=pts.device, dtype=torch.float32)
    lib = build.library("sdf_fwd")
    err = lib.sdf_fwd_launch(
        pts.data_ptr(), out.data_ptr(), n, W.data_ptr(), B.data_ptr(),
        build.int64_array(meta), float(scale), build.stream_ptr(pts.device),
    )
    build.LAUNCHES["sdf_fwd"] += 1
    build.check(err, "sdf_fwd")
    return out
