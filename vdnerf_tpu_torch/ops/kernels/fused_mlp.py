"""K2/K3 (colour head forward/backward) and K4/K5 (background NeRF
forward/backward): CUDA kernels, their plain versions, and the autograd
Functions that join them.

Replace ``vdnerf_tpu/ops/pallas/fused_mlp.py::render_net_fused`` and
``::nerf_fused`` with their custom VJPs. Numerics follow the Pallas kernels'
``_mm`` / ``_mm_dx`` / ``_mm_dw``: matmul operands rounded to ``_MM_DTYPE``
(bf16), f32 accumulation, f32 bias/activations/outputs/deltas. The relu masks
of the backward come from the rounded stored activations, as in the Pallas
backward. A test may set ``_MM_DTYPE`` to f32 to hold the plain versions to
the JAX kernels' f32 mode; the CUDA kernels compute in bf16 only and refuse
any other setting.

Weight norm stays outside: callers pass effective ``[in, out]`` weights, and
the backward returns cotangents for those, which autograd chains to
``weight_v``/``weight_g``. The backward recomputes the forward from the saved
inputs and weights, as ``_render_fused_fwd``/``_nerf_fused_fwd`` save them.
On CPU tensors the Functions run the plain versions; on CUDA tensors they
launch the kernels (``csrc/fused_mlp.cu``), and a build or launch failure
raises.

The plain backward versions are written out step by step like
``_render_kernel_bwd``/``_nerf_kernel_bwd``, not as autograd through the plain
forward: autograd's backward of ``.to(bf16).float()`` would round the
gradient after each product, where the kernels round the delta before it.
"""

from __future__ import annotations

import torch

from vdnerf_tpu_torch.models.embedder import embed, freqs
from vdnerf_tpu_torch.ops.kernels import build

_MM_DTYPE = torch.bfloat16
_MODES = {"idr": 0, "no_view_dir": 1, "no_normal": 2}


def _r(x: torch.Tensor) -> torch.Tensor:
    """A matmul operand as the kernels see it: rounded to _MM_DTYPE."""
    return x.to(_MM_DTYPE).float()


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[T, K] @ [K, N] with operands rounded to _MM_DTYPE, f32 accumulation."""
    return _r(a) @ _r(b)


def _mm_dx(d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """d @ w^T: [T, N] x [K, N] -> [T, K], operands rounded."""
    return _r(d) @ _r(w).t()


def _mm_dw(a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """a^T @ d: [T, K] x [T, N] -> [K, N], operands rounded."""
    return _r(a).t() @ _r(d)


def _d_embed(d_emb: torch.Tensor, x: torch.Tensor, multires: int) -> torch.Tensor:
    """VJP of :func:`embed` w.r.t. x: [T, d (1 + 2 L)] -> [T, d]."""
    d = x.shape[-1]
    dx = d_emb[:, :d]
    for i, f in enumerate(freqs(multires)):
        ds = d_emb[:, d * (1 + 2 * i): d * (2 + 2 * i)]
        dc = d_emb[:, d * (2 + 2 * i): d * (3 + 2 * i)]
        dx = dx + f * (ds * torch.cos(x * f) - dc * torch.sin(x * f))
    return dx


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


def _render_forward(plan, pts, normals, dirs, feat, ws, bs):
    """-> (output [N, d_out], each layer's f32 input, emb_view)."""
    mode, multires_view, squeeze_out = plan
    emb_view = embed(dirs, multires_view)
    x = _render_concat(pts, emb_view, normals, feat.float(), mode)
    acts = []
    for l, (w, b) in enumerate(zip(ws, bs)):
        acts.append(x)
        x = _mm(x, w) + b
        if l < len(ws) - 1:
            x = torch.relu(x)
    y = torch.sigmoid(x) if squeeze_out else torch.relu(x)
    return y, acts, emb_view


def render_net_plain(plan, pts, normals, dirs, feat, ws, bs) -> torch.Tensor:
    """plan = (mode, multires_view, squeeze_out) -> [N, d_out] f32."""
    return _render_forward(plan, pts, normals, dirs, feat, ws, bs)[0]


def render_net_bwd_plain(plan, pts, normals, dirs, feat, ws, bs, g):
    """Cotangent g [N, d_out] -> (d_pts, d_normals, d_dirs, d_feat, dws, dbs),
    step by step as ``_render_kernel_bwd``."""
    mode, multires_view, squeeze_out = plan
    y, acts, emb_view = _render_forward(plan, pts, normals, dirs, feat, ws, bs)
    d = g * y * (1.0 - y) if squeeze_out else g * (y > 0.0).float()
    dws, dbs = [None] * len(ws), [None] * len(ws)
    for l in range(len(ws) - 1, -1, -1):
        dws[l] = _mm_dw(acts[l], d)
        dbs[l] = d.sum(0)
        d = _mm_dx(d, ws[l])
        if l > 0:
            d = d * (_r(acts[l]) > 0).float()
    n_emb = emb_view.shape[-1]
    zeros = torch.zeros_like(pts)
    if mode == "idr":
        d_pts, d_emb, d_nrm, d_feat = d[:, :3], d[:, 3:3 + n_emb], d[:, 3 + n_emb:6 + n_emb], d[:, 6 + n_emb:]
    elif mode == "no_view_dir":
        d_pts, d_emb, d_nrm, d_feat = d[:, :3], torch.zeros_like(emb_view), d[:, 3:6], d[:, 6:]
    else:
        d_pts, d_emb, d_nrm, d_feat = d[:, :3], d[:, 3:3 + n_emb], zeros, d[:, 3 + n_emb:]
    d_dirs = _d_embed(d_emb, dirs, multires_view)
    return d_pts, d_nrm, d_dirs, d_feat, dws, dbs


def _nerf_forward(plan, pts, views, trunk_w, trunk_b, head_w, head_b):
    """-> (alpha, rgb, dpt | None, residuals of the backward)."""
    multires, multires_view, skips, _, has_dpt = plan
    emb_pts = embed(pts, multires)
    emb_view = embed(views, multires_view)
    h = emb_pts
    acts = []
    for i, (w, b) in enumerate(zip(trunk_w, trunk_b)):
        acts.append(h)
        h = torch.relu(_mm(h, w) + b)
        if i in skips:
            h = torch.cat([emb_pts, h], dim=-1)
    alpha = _mm(h, head_w[0]) + head_b[0]
    feature = _mm(h, head_w[1]) + head_b[1]
    h2_in = torch.cat([feature, emb_view], dim=-1)
    h2 = torch.relu(_mm(h2_in, head_w[2]) + head_b[2])
    rgb = _mm(h2, head_w[3]) + head_b[3]
    dpt = _mm(h2, head_w[4]) + head_b[4] if has_dpt else None
    res = {"acts": acts, "h": h, "h2_in": h2_in, "h2": h2, "emb_pts": emb_pts,
           "emb_view": emb_view}
    return alpha, rgb, dpt, res


def nerf_plain(plan, pts, views, trunk_w, trunk_b, head_w, head_b):
    """plan = (multires, multires_view, skips, D, has_dpt); heads ordered
    alpha, feature, views0, rgb[, dpt] -> (alpha, rgb, dpt | None)."""
    return _nerf_forward(plan, pts, views, trunk_w, trunk_b, head_w, head_b)[:3]


def nerf_bwd_plain(plan, pts, views, trunk_w, trunk_b, head_w, head_b,
                   g_alpha, g_rgb, g_dpt=None):
    """Cotangents of (alpha, rgb[, dpt]) -> (d_pts, d_views, dtw, dtb, dhw,
    dhb), step by step as ``_nerf_kernel_bwd``."""
    multires, multires_view, skips, D, has_dpt = plan
    _, _, _, res = _nerf_forward(plan, pts, views, trunk_w, trunk_b, head_w, head_b)
    acts, h, h2_in, h2 = res["acts"], res["h"], res["h2_in"], res["h2"]
    n_emb = res["emb_pts"].shape[-1]
    w_dim = head_w[1].shape[1]
    dhw, dhb = [None] * len(head_w), [None] * len(head_w)

    def head(idx, a_in, d):
        dhw[idx] = _mm_dw(a_in, d)
        dhb[idx] = d.sum(0)

    d_h2 = _mm_dx(g_rgb, head_w[3])
    head(3, h2, g_rgb)
    if has_dpt:
        if g_dpt is None:
            g_dpt = torch.zeros(pts.shape[0], head_w[4].shape[1], device=pts.device)
        d_h2 = d_h2 + _mm_dx(g_dpt, head_w[4])
        head(4, h2, g_dpt)
    d_h2 = d_h2 * (h2 > 0).float()
    head(2, h2_in, d_h2)
    d_h2_in = _mm_dx(d_h2, head_w[2])
    d_feature, d_emb_view = d_h2_in[:, :w_dim], d_h2_in[:, w_dim:]
    head(0, h, g_alpha)
    head(1, h, d_feature)
    d_h = _mm_dx(g_alpha, head_w[0]) + _mm_dx(d_feature, head_w[1])

    # trunk in reverse, unstitching the skip concats; the relu mask comes
    # from the stored next-layer input (minus the skip prefix)
    dtw, dtb = [None] * D, [None] * D
    d_emb_pts = torch.zeros_like(res["emb_pts"])
    for i in range(D - 1, -1, -1):
        if i in skips:
            d_emb_pts = d_emb_pts + d_h[:, :n_emb]
            d_h = d_h[:, n_emb:]
        if i == D - 1:
            relu_out = h
        else:
            relu_out = _r(acts[i + 1][:, n_emb:] if i in skips else acts[i + 1])
        d_h = d_h * (relu_out > 0).float()
        dtw[i] = _mm_dw(acts[i], d_h)
        dtb[i] = d_h.sum(0)
        d_h = _mm_dx(d_h, trunk_w[i])
    d_emb_pts = d_emb_pts + d_h
    d_pts = _d_embed(d_emb_pts, pts, multires)
    d_views = _d_embed(d_emb_view, views, multires_view)
    return d_pts, d_views, dtw, dtb, dhw, dhb


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


def _check_shapes(name, n, *pairs):
    """Each (tensor, width) must be [n, width]."""
    for t, width in pairs:
        if tuple(t.shape) != (n, width):
            raise ValueError(f"{name}: expected [{n}, {width}], got {tuple(t.shape)}")


def _render_meta(plan, feat, ws, bs, device):
    mode, multires_view, squeeze_out = plan
    e_view = 3 * (1 + 2 * multires_view) if multires_view > 0 else 3
    k0 = 3 + feat.shape[1] + (e_view if mode != "no_view_dir" else 0) + (
        3 if mode != "no_normal" else 0)
    if ws[0].shape[0] != k0:
        raise ValueError(f"render_net: first layer takes {ws[0].shape[0]} inputs, concat is {k0}")
    W, B, layer_meta = _pack(list(zip(ws, bs)), device)
    meta = [len(ws), _MODES[mode], int(squeeze_out), multires_view, 0, 3,
            feat.shape[1], 0, 0, 0, 0] + layer_meta
    return W, B, meta


def _nerf_meta(plan, d_a, trunk_w, trunk_b, head_w, head_b, device):
    """K4/K5 pack alpha with feature and rgb with dpt into single layers."""
    multires, multires_view, skips, D, has_dpt = plan
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
    W, B, layer_meta = _pack(layers, device)
    skip_mask = sum(1 << i for i in skips if i < D)
    meta = [len(layers), 0, 0, multires, multires_view, d_a, 0, skip_mask, D,
            d_rgb, d_dpt] + layer_meta
    return W, B, meta


def _render_launch(plan, pts, normals, dirs, feat, ws, bs):
    _check_inputs("render_fwd", pts, normals, dirs, feat)
    n = pts.shape[0]
    W, B, meta = _render_meta(plan, feat, ws, bs, pts.device)
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
    has_dpt = plan[4]
    _check_inputs("nerf_fwd", pts, views)
    n, d_a = pts.shape
    dev = pts.device
    W, B, meta = _nerf_meta(plan, d_a, trunk_w, trunk_b, head_w, head_b, dev)
    d_rgb, d_dpt = meta[9], meta[10]
    pts, views = pts.contiguous(), views.contiguous()
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


def _layers_of(meta):
    """(K, N, Kp, Np, woff, boff) per layer from a launcher's meta."""
    return [tuple(meta[11 + 6 * l: 17 + 6 * l]) for l in range(meta[0])]


def dw_plan(n: int, layers, sms: int) -> tuple[int, int]:
    """Row splits of the dW contraction -> (splits, rows_per_split).

    The contraction runs one CTA per 128x128 output tile of every layer's dW
    and per split; the splits divide the padded rows (a multiple of 64) into
    ranges of ``rows_per_split`` rows, a multiple of 64, so that tiles x
    splits is about two CTAs per SM (``sms``; two fit at once) and no split
    is empty. Split i covers rows
    [i * rows_per_split, min((i + 1) * rows_per_split, n_pad))."""
    n_tiles = -(-n // 64)
    out_tiles = sum(-(-Kp // 128) * -(-Np // 128) for _, _, Kp, Np, _, _ in layers)
    splits = max(1, min(n_tiles, 2 * sms // out_tiles))
    rows_per_split = -(-n_tiles // splits) * 64
    return -(-n_tiles * 64 // rows_per_split), rows_per_split


class _BwdScratch:
    """What a backward launch needs besides its inputs: the scratch of the
    tile kernel and of the split-K dW contraction (sizes in the design note of
    ``csrc/fused_mlp.cu``), and the packed dW/db it returns."""

    def __init__(self, n: int, meta, device):
        layers = _layers_of(meta)
        n_tiles = -(-n // 64)
        act_w = sum(L[2] for L in layers)
        del_w = sum(L[3] for L in layers)
        total_w = sum(L[2] * L[3] for L in layers)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        self.splits, self.rows_per_split = dw_plan(n, layers, sms)
        bf16, f32 = torch.bfloat16, torch.float32
        self.acts = torch.empty(n_tiles * 64, act_w, device=device, dtype=bf16)
        self.dels = torch.empty(n_tiles * 64, del_w, device=device, dtype=bf16)
        self.dbpart = torch.empty(n_tiles, del_w, device=device, dtype=f32)
        self.part = torch.empty(self.splits, total_w, device=device, dtype=f32)
        self.dW = torch.empty(total_w, device=device, dtype=f32)
        self.dB = torch.empty(del_w, device=device, dtype=f32)
        self.n, self.meta, self.layers = n, meta, layers

    def tile_args(self):
        return [self.acts.data_ptr(), self.dels.data_ptr(), self.dbpart.data_ptr()]

    def contract(self) -> None:
        """The dW contraction and the dW/db reductions over what the tile
        kernel left in the scratch."""
        err = build.library("fused_mlp").dw_finish_launch(
            build.int64_array(self.meta), self.n, self.acts.data_ptr(), self.dels.data_ptr(),
            self.dbpart.data_ptr(), self.part.data_ptr(), self.splits, self.rows_per_split,
            self.dW.data_ptr(), self.dB.data_ptr(), build.stream_ptr(self.dW.device))
        build.LAUNCHES["dw_contract"] += 1
        build.check(err, "dw_contract")

    def grads(self):
        """-> per-layer (dW [K, N], db [N])."""
        return [(self.dW[woff:woff + Kp * Np].view(Kp, Np)[:K, :N], self.dB[boff:boff + N])
                for K, N, Kp, Np, woff, boff in self.layers]


def _render_bwd_tile(ins, outs, W, B, meta, scratch: _BwdScratch) -> None:
    """K3's tile kernel: ins = contiguous (pts, normals, dirs, feat, g), outs =
    (d_pts, d_normals, d_dirs, d_feat), weights packed by _render_meta; leaves
    the deltas and activations in ``scratch`` for its contraction."""
    err = build.library("fused_mlp").render_bwd_launch(
        *(t.data_ptr() for t in (*ins, *outs)), ins[0].shape[0], W.data_ptr(), B.data_ptr(),
        build.int64_array(meta), *scratch.tile_args(), build.stream_ptr(ins[0].device),
    )
    build.LAUNCHES["render_bwd"] += 1
    build.check(err, "render_bwd")


def _render_bwd_launch(plan, pts, normals, dirs, feat, ws, bs, g):
    _check_inputs("render_bwd", pts, normals, dirs, feat, g)
    n = pts.shape[0]
    # the first layer's width against feat's is checked by _render_meta
    _check_shapes("render_bwd", n, (pts, 3), (normals, 3), (dirs, 3), (feat, feat.shape[1]),
                  (g, ws[-1].shape[1]))
    dev = pts.device
    W, B, meta = _render_meta(plan, feat, ws, bs, dev)
    ins = tuple(t.contiguous() for t in (pts, normals, dirs, feat, g))
    outs = (*(torch.empty(n, 3, device=dev) for _ in range(3)),
            torch.empty(n, feat.shape[1], device=dev))
    if n == 0:
        return (*outs, [torch.zeros_like(w) for w in ws], [torch.zeros_like(b) for b in bs])
    scratch = _BwdScratch(n, meta, dev)
    _render_bwd_tile(ins, outs, W, B, meta, scratch)
    scratch.contract()
    grads = scratch.grads()
    return (*outs, [dw for dw, _ in grads], [db for _, db in grads])


def _nerf_bwd_tile(ins, outs, W, B, meta, scratch: _BwdScratch) -> None:
    """K5's tile kernel: ins = contiguous (pts, views, g_alpha, g_rgb, g_dpt),
    outs = (d_pts, d_views), weights packed by _nerf_meta; leaves the deltas
    and activations in ``scratch`` for its contraction."""
    err = build.library("fused_mlp").nerf_bwd_launch(
        *(t.data_ptr() for t in (*ins, *outs)), ins[0].shape[0], W.data_ptr(), B.data_ptr(),
        build.int64_array(meta), *scratch.tile_args(), build.stream_ptr(ins[0].device),
    )
    build.LAUNCHES["nerf_bwd"] += 1
    build.check(err, "nerf_bwd")


def _nerf_bwd_launch(plan, pts, views, trunk_w, trunk_b, head_w, head_b,
                     g_alpha, g_rgb, g_dpt=None):
    has_dpt = plan[4]
    D = len(trunk_w)
    _check_inputs("nerf_bwd", pts, views, g_alpha, g_rgb)
    n, d_a = pts.shape
    dev = pts.device
    W, B, meta = _nerf_meta(plan, d_a, trunk_w, trunk_b, head_w, head_b, dev)
    d_rgb, d_dpt = meta[9], meta[10]
    if has_dpt and g_dpt is None:
        g_dpt = torch.zeros(n, d_dpt, device=dev)
    g_dpt = g_dpt if has_dpt else g_rgb  # never read without the dpt head
    _check_shapes("nerf_bwd", n, (views, 3), (g_alpha, 1), (g_rgb, d_rgb),
                  (g_dpt, d_dpt if has_dpt else d_rgb))
    ins = tuple(t.contiguous() for t in (pts, views, g_alpha, g_rgb, g_dpt))
    d_pts = torch.empty(n, d_a, device=dev)
    d_views = torch.empty(n, 3, device=dev)
    if n == 0:
        z = torch.zeros_like
        return (d_pts, d_views, [z(w) for w in trunk_w], [z(b) for b in trunk_b],
                [z(w) for w in head_w], [z(b) for b in head_b])
    scratch = _BwdScratch(n, meta, dev)
    _nerf_bwd_tile(ins, (d_pts, d_views), W, B, meta, scratch)
    scratch.contract()
    grads = scratch.grads()
    (dw_af, db_af), (dw_v0, db_v0), (dw_rd, db_rd) = grads[D:]
    dhw = [dw_af[:, :1], dw_af[:, 1:], dw_v0, dw_rd[:, :d_rgb]]
    dhb = [db_af[:1], db_af[1:], db_v0, db_rd[:d_rgb]]
    if has_dpt:
        dhw.append(dw_rd[:, d_rgb:])
        dhb.append(db_rd[d_rgb:])
    return (d_pts, d_views, [dw for dw, _ in grads[:D]], [db for _, db in grads[:D]],
            dhw, dhb)


# ---------------------------------------------------------------------------
# autograd Functions and wrappers
# ---------------------------------------------------------------------------


def _on(t: torch.Tensor, name: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type


class _RenderNet(torch.autograd.Function):
    """Forward K2 (or its plain version), backward K3 (or its plain version);
    cotangents for the four inputs and every effective weight and bias."""

    @staticmethod
    def forward(ctx, plan, pts, normals, dirs, feat, *wb):
        n = len(wb) // 2
        ws, bs = list(wb[:n]), list(wb[n:])
        ctx.plan = plan
        ctx.save_for_backward(pts, normals, dirs, feat, *wb)
        if _on(pts, "render_net") == "cpu":
            return render_net_plain(plan, pts, normals, dirs, feat, ws, bs)
        return _render_launch(plan, pts, normals, dirs, feat.float(), ws, bs)

    @staticmethod
    def backward(ctx, g):
        pts, normals, dirs, feat, *wb = ctx.saved_tensors
        n = len(wb) // 2
        ws, bs = wb[:n], wb[n:]
        fn = render_net_bwd_plain if _on(g, "render_net") == "cpu" else _render_bwd_launch
        d_pts, d_nrm, d_dirs, d_feat, dws, dbs = fn(
            ctx.plan, pts, normals, dirs, feat.float(), ws, bs, g.float())
        return (None, d_pts, d_nrm, d_dirs, d_feat.to(feat.dtype), *dws, *dbs)


class _NeRF(torch.autograd.Function):
    """Forward K4 (or its plain version), backward K5 (or its plain version);
    cotangents for pts, views and every effective weight and bias."""

    @staticmethod
    def forward(ctx, plan, pts, views, *weights):
        D, n_head = plan[3], 5 if plan[4] else 4
        ctx.plan = plan
        ctx.save_for_backward(pts, views, *weights)
        args = _split_nerf(weights, D, n_head)
        fn = nerf_plain if _on(pts, "nerf") == "cpu" else _nerf_launch
        alpha, rgb, dpt = fn(plan, pts, views, *args)
        return (alpha, rgb) if dpt is None else (alpha, rgb, dpt)

    @staticmethod
    def backward(ctx, g_alpha, g_rgb, g_dpt=None):
        pts, views, *weights = ctx.saved_tensors
        D, n_head = ctx.plan[3], 5 if ctx.plan[4] else 4
        args = _split_nerf(weights, D, n_head)
        fn = nerf_bwd_plain if _on(g_alpha, "nerf") == "cpu" else _nerf_bwd_launch
        d_pts, d_views, dtw, dtb, dhw, dhb = fn(ctx.plan, pts, views, *args,
                                                g_alpha, g_rgb, g_dpt)
        return (None, d_pts, d_views, *dtw, *dtb, *dhw, *dhb)


def _split_nerf(weights, D, n_head):
    w = list(weights)
    return w[:D], w[D:2 * D], w[2 * D:2 * D + n_head], w[2 * D + n_head:]


def render_net(plan, pts, normals, dirs, feat, ws, bs) -> torch.Tensor:
    """Colour head. plan = (mode, multires_view, squeeze_out); ws/bs
    effective [in, out] weights and biases. -> [N, d_out] f32."""
    return _RenderNet.apply(plan, pts, normals, dirs, feat, *ws, *bs)


def nerf(plan, pts, views, trunk_w, trunk_b, head_w, head_b):
    """Background NeRF. plan = (multires, multires_view, skips, D, has_dpt).
    -> (alpha [N,1], rgb [N,rgb_dims], dpt [N,dpt_dim] | None)."""
    out = _NeRF.apply(plan, pts, views, *trunk_w, *trunk_b, *head_w, *head_b)
    return out[0], out[1], out[2] if len(out) > 2 else None
