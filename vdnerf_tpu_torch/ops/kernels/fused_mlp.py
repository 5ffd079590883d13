"""K2 (colour head forward) and K4 (background NeRF forward): CUDA kernels
and their plain versions.

Replace ``vdnerf_tpu/ops/pallas/fused_mlp.py::render_net_fused`` and
``::nerf_fused`` (forward). Numerics follow the Pallas kernels' ``_mm``:
matmul operands rounded to ``_MM_DTYPE`` (bf16), f32 accumulation, f32
bias/activations/outputs. A test may set ``_MM_DTYPE`` to f32 to hold the
plain versions to the JAX kernels' f32 mode; the CUDA kernels compute in bf16
only and refuse any other setting.

Weight norm stays outside: callers pass effective ``[in, out]`` weights. On a
CPU tensor the wrappers run the plain version; on a CUDA tensor they launch
the kernel (``csrc/fused_mlp.cu``), and a build or launch failure raises.
"""

from __future__ import annotations

import torch

from vdnerf_tpu_torch.models.embedder import embed
from vdnerf_tpu_torch.ops.kernels import build

_MM_DTYPE = torch.bfloat16
_MODES = {"idr": 0, "no_view_dir": 1, "no_normal": 2}


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[T, K] @ [K, N] with operands rounded to _MM_DTYPE, f32 accumulation."""
    return a.to(_MM_DTYPE).float() @ b.to(_MM_DTYPE).float()


def _render_concat(pts, emb_view, normals, feat, mode):
    if mode == "idr":
        return torch.cat([pts, emb_view, normals, feat], dim=-1)
    if mode == "no_view_dir":
        return torch.cat([pts, normals, feat], dim=-1)
    if mode == "no_normal":
        return torch.cat([pts, emb_view, feat], dim=-1)
    raise ValueError(f"unknown rendering mode {mode!r}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def render_net_plain(plan, pts, normals, dirs, feat, ws, bs) -> torch.Tensor:
    """plan = (mode, multires_view, squeeze_out) -> [N, d_out] f32."""
    mode, multires_view, squeeze_out = plan
    x = _render_concat(pts, embed(dirs, multires_view), normals, feat.float(), mode)
    for l, (w, b) in enumerate(zip(ws, bs)):
        x = _mm(x, w) + b
        if l < len(ws) - 1:
            x = torch.relu(x)
    return torch.sigmoid(x) if squeeze_out else torch.relu(x)


def nerf_plain(plan, pts, views, trunk_w, trunk_b, head_w, head_b):
    """plan = (multires, multires_view, skips, D, has_dpt); heads ordered
    alpha, feature, views0, rgb[, dpt] -> (alpha, rgb, dpt | None)."""
    multires, multires_view, skips, _, has_dpt = plan
    emb_pts = embed(pts, multires)
    emb_view = embed(views, multires_view)
    h = emb_pts
    for i, (w, b) in enumerate(zip(trunk_w, trunk_b)):
        h = torch.relu(_mm(h, w) + b)
        if i in skips:
            h = torch.cat([emb_pts, h], dim=-1)
    alpha = _mm(h, head_w[0]) + head_b[0]
    feature = _mm(h, head_w[1]) + head_b[1]
    h2 = torch.relu(_mm(torch.cat([feature, emb_view], dim=-1), head_w[2]) + head_b[2])
    rgb = _mm(h2, head_w[3]) + head_b[3]
    dpt = _mm(h2, head_w[4]) + head_b[4] if has_dpt else None
    return alpha, rgb, dpt


# ---------------------------------------------------------------------------
# kernel launchers
# ---------------------------------------------------------------------------


def _pad16(x: int) -> int:
    return (x + 15) // 16 * 16


def _pack(layers, device):
    """[(w [K, N], b [N])] -> (bf16 weights padded to [Kp, Np] and packed,
    f32 biases padded to Np and packed, per-layer meta)."""
    w_parts, b_parts, meta = [], [], []
    woff = boff = 0
    for w, b in layers:
        K, N = w.shape
        if b.shape != (N,) or w.device != device:
            raise ValueError("fused_mlp: weight/bias shapes or devices disagree")
        Kp, Np = _pad16(K), _pad16(N)
        wp = torch.zeros(Kp, Np, device=device, dtype=torch.bfloat16)
        wp[:K, :N] = w.detach().to(torch.bfloat16)
        bp = torch.zeros(Np, device=device, dtype=torch.float32)
        bp[:N] = b.detach().float()
        w_parts.append(wp.reshape(-1))
        b_parts.append(bp)
        meta += [K, N, Kp, Np, woff, boff]
        woff += Kp * Np
        boff += Np
    return torch.cat(w_parts), torch.cat(b_parts), meta


def _check_inputs(name, *tensors):
    if _MM_DTYPE != torch.bfloat16:
        raise RuntimeError(f"{name}: the CUDA kernel computes in bf16 only")
    for t in tensors:
        if t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(f"{name}: inputs must be 2-D f32, got {t.dtype} {tuple(t.shape)}")


def _render_launch(plan, pts, normals, dirs, feat, ws, bs):
    mode, multires_view, squeeze_out = plan
    _check_inputs("render_fwd", pts, normals, dirs, feat)
    n = pts.shape[0]
    e_view = 3 * (1 + 2 * multires_view) if multires_view > 0 else 3
    k0 = 3 + feat.shape[1] + (e_view if mode != "no_view_dir" else 0) + (
        3 if mode != "no_normal" else 0)
    if ws[0].shape[0] != k0:
        raise ValueError(f"render_fwd: first layer takes {ws[0].shape[0]} inputs, concat is {k0}")
    W, B, layer_meta = _pack(list(zip(ws, bs)), pts.device)
    meta = [len(ws), _MODES[mode], int(squeeze_out), multires_view, 0, 3,
            feat.shape[1], 0, 0, 0, 0] + layer_meta
    pts, normals, dirs, feat = (t.contiguous() for t in (pts, normals, dirs, feat))
    out = torch.empty(n, ws[-1].shape[1], device=pts.device, dtype=torch.float32)
    lib = build.library("fused_mlp")
    err = lib.render_fwd_launch(
        pts.data_ptr(), normals.data_ptr(), dirs.data_ptr(), feat.data_ptr(),
        out.data_ptr(), n, W.data_ptr(), B.data_ptr(),
        build.int64_array(meta), build.stream_ptr(pts.device),
    )
    build.LAUNCHES["render_fwd"] += 1
    build.check(err, "render_fwd")
    return out


def _nerf_launch(plan, pts, views, trunk_w, trunk_b, head_w, head_b):
    multires, multires_view, skips, D, has_dpt = plan
    _check_inputs("nerf_fwd", pts, views)
    n, d_a = pts.shape
    layers = list(zip(trunk_w, trunk_b))
    layers.append((torch.cat([head_w[0], head_w[1]], dim=1),
                   torch.cat([head_b[0], head_b[1]])))
    layers.append((head_w[2], head_b[2]))
    d_rgb = head_w[3].shape[1]
    d_dpt = head_w[4].shape[1] if has_dpt else 0
    if has_dpt:
        layers.append((torch.cat([head_w[3], head_w[4]], dim=1),
                       torch.cat([head_b[3], head_b[4]])))
    else:
        layers.append((head_w[3], head_b[3]))
    W, B, layer_meta = _pack(layers, pts.device)
    skip_mask = sum(1 << i for i in skips if i < D)
    meta = [len(layers), 0, 0, multires, multires_view, d_a, 0, skip_mask, D,
            d_rgb, d_dpt] + layer_meta
    pts, views = pts.contiguous(), views.contiguous()
    dev = pts.device
    alpha = torch.empty(n, 1, device=dev, dtype=torch.float32)
    rgb = torch.empty(n, d_rgb, device=dev, dtype=torch.float32)
    # without the dpt head the kernel never writes this buffer
    dpt = torch.empty(n if has_dpt else 1, max(d_dpt, 1), device=dev, dtype=torch.float32)
    lib = build.library("fused_mlp")
    err = lib.nerf_fwd_launch(
        pts.data_ptr(), views.data_ptr(), alpha.data_ptr(), rgb.data_ptr(),
        dpt.data_ptr(), n, W.data_ptr(), B.data_ptr(),
        build.int64_array(meta), build.stream_ptr(dev),
    )
    build.LAUNCHES["nerf_fwd"] += 1
    build.check(err, "nerf_fwd")
    return alpha, rgb, dpt if has_dpt else None


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def render_net(plan, pts, normals, dirs, feat, ws, bs) -> torch.Tensor:
    """Colour head forward. plan = (mode, multires_view, squeeze_out); ws/bs
    effective [in, out] weights and biases. -> [N, d_out] f32."""
    if pts.device.type == "cpu":
        return render_net_plain(plan, pts, normals, dirs, feat, ws, bs)
    if pts.device.type != "cuda":
        raise ValueError(f"render_net: unsupported device {pts.device}")
    return _render_launch(plan, pts, normals, dirs, feat.float(), ws, bs)


def nerf(plan, pts, views, trunk_w, trunk_b, head_w, head_b):
    """Background NeRF forward. plan = (multires, multires_view, skips, D,
    has_dpt). -> (alpha [N,1], rgb [N,rgb_dims], dpt [N,dpt_dim] | None)."""
    if pts.device.type == "cpu":
        return nerf_plain(plan, pts, views, trunk_w, trunk_b, head_w, head_b)
    if pts.device.type != "cuda":
        raise ValueError(f"nerf: unsupported device {pts.device}")
    return _nerf_launch(plan, pts, views, trunk_w, trunk_b, head_w, head_b)
