"""K1: gradient-free SDF value, as a CUDA kernel and its plain version.

Replaces ``vdnerf_tpu/ops/pallas/sdf_fwd.py::sdf_value_pallas``. The kernel
(``csrc/sdf_fwd.cu``) is f32-accurate: its products run on the tensor cores as
3xTF32 (each operand split into a tf32 big part and a tf32 remainder, three
products accumulated in f32); see the source for its design. The host-side
planning (:func:`rows_per_cta`, :func:`pack_weights`) is pure and tested on
the CPU. The up-sample ladder's stop-gradient SDF queries go through
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


def _pad32(x: int) -> int:
    return (x + 31) // 32 * 32


def rows_per_cta(n: int, sms: int) -> int:
    """Rows per CTA of the kernel: 64, unless 64-row tiles would leave the
    card's ``sms`` multiprocessors with fewer than two CTAs each; then 32 (two
    32-row CTAs share an SM)."""
    return 64 if -(-n // 64) >= 2 * sms else 32


def pack_weights(ws, bs):
    """Effective [in, out] weights and biases -> (W, B, per-layer meta).

    Each weight is zero-padded to [Kp, Np] = [pad32(in), pad32(out)] f32 and
    packed row-major into W, each bias zero-padded to Np into B, in layer
    order; meta holds (K, N, Kp, Np, woff, boff) per layer. The padding keeps
    every 16-byte copy of the kernel's weight ring aligned, and the zero rows
    and columns add nothing to the products."""
    meta, woff, boff = [], 0, 0
    for w, b in zip(ws, bs):
        K, N = w.shape
        if b.shape != (N,) or w.device != b.device:
            raise ValueError("sdf_value: weight/bias shapes or devices disagree")
        Kp, Np = _pad32(K), _pad32(N)
        meta += [K, N, Kp, Np, woff, boff]
        woff += Kp * Np
        boff += Np
    dev = ws[0].device
    W = torch.zeros(woff, device=dev, dtype=torch.float32)
    B = torch.zeros(boff, device=dev, dtype=torch.float32)
    for l, (w, b) in enumerate(zip(ws, bs)):
        K, N, Kp, Np, wo, bo = meta[6 * l: 6 * l + 6]
        W[wo:wo + Kp * Np].view(Kp, Np)[:K, :N] = w.detach()
        B[bo:bo + N] = b.detach()
    return W, B, meta


def _sdf_kernel_args(pts, ws, bs, skip_in, multires):
    """Check the arguments and pack the weights -> (W, B, meta) for
    :func:`_sdf_launch`."""
    if pts.dim() != 2 or pts.shape[1] != 3 or pts.dtype != torch.float32:
        raise ValueError(f"sdf_value: pts must be [N, 3] f32, got {tuple(pts.shape)} {pts.dtype}")
    if any(w.device != pts.device for w in ws) or any(w.shape[1] > 256 for w in ws[:-1]):
        raise ValueError("sdf_value: weights must lie on the points' device, hidden layers <= 256 wide")
    W, B, layer_meta = pack_weights(ws, [b.reshape(-1) for b in bs])
    sms = torch.cuda.get_device_properties(pts.device).multi_processor_count
    meta = build.int64_array([len(ws), sum(1 << l for l in skip_in if l < len(ws)), multires,
                              rows_per_cta(pts.shape[0], sms)] + layer_meta)
    return W, B, meta


def _sdf_launch(pts, out, W, B, meta, scale) -> None:
    """The kernel on contiguous ``pts`` [N, 3] into ``out`` [N, 1]."""
    err = build.library("sdf_fwd").sdf_fwd_launch(
        pts.data_ptr(), out.data_ptr(), pts.shape[0], W.data_ptr(), B.data_ptr(), meta,
        float(scale), build.stream_ptr(pts.device))
    build.LAUNCHES["sdf_fwd"] += 1
    build.check(err, "sdf_fwd")


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
    W, B, meta = _sdf_kernel_args(pts, ws, bs, skip_in, multires)
    pts = pts.contiguous()
    out = torch.empty(pts.shape[0], 1, device=pts.device, dtype=torch.float32)
    _sdf_launch(pts, out, W, B, meta, scale)
    return out
