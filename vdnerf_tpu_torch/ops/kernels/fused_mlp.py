"""K2/K3 (colour head forward/backward) and K4/K5 (background NeRF
forward/backward): CUDA kernels, their plain versions, and the autograd
Functions that join them.

Replace ``vdnerf_tpu/ops/pallas/fused_mlp.py::render_net_fused`` and
``::nerf_fused`` with their custom VJPs. Numerics follow the Pallas kernels'
``_mm`` / ``_mm_dx`` / ``_mm_dw`` in one of two operand modes, a value the
callers pass (``mm``; ``models/precision.py`` derives it from the policy and
``VDNERF_FUSED``):

- bf16 (JAX's fused path): matmul operands rounded to bf16, f32
  accumulation, f32 bias/activations/outputs/deltas; the relu masks of the
  backward come from the rounded stored activations, as in the Pallas
  backward. K2-K5 and the dW contraction (``csrc/fused_mlp.cu``).
- f32 (JAX's default path, f32 ``linear``s): operands unrounded. On the card
  the split-operand mode of the same kernels (3xTF32 products,
  ``_SplitOps``), never a library product.

Every entry takes the mode; there is no default.

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

import functools
from typing import NamedTuple

import torch

from vdnerf_tpu_torch.models.embedder import embed, freqs
from vdnerf_tpu_torch.ops.kernels import build
from vdnerf_tpu_torch.utils import trace

_MODES = {"idr": 0, "no_view_dir": 1, "no_normal": 2}


def _mode(mm):
    """The operand mode a caller asked for, checked."""
    if mm not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_mlp: operands are bf16 or f32, not {mm}")
    return mm


def _r(x: torch.Tensor, mm) -> torch.Tensor:
    """A matmul operand as the kernels see it: rounded to the mode's type."""
    return x.to(_mode(mm)).float()


def _mm(a: torch.Tensor, b: torch.Tensor, mm) -> torch.Tensor:
    """[T, K] @ [K, N] with operands rounded to the mode, f32 accumulation."""
    return _r(a, mm) @ _r(b, mm)


def _mm_dx(d: torch.Tensor, w: torch.Tensor, mm) -> torch.Tensor:
    """d @ w^T: [T, N] x [K, N] -> [T, K], operands rounded."""
    return _r(d, mm) @ _r(w, mm).t()


def _mm_dw(a: torch.Tensor, d: torch.Tensor, mm) -> torch.Tensor:
    """a^T @ d: [T, K] x [T, N] -> [K, N], operands rounded."""
    return _r(a, mm).t() @ _r(d, mm)


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


def _render_forward(plan, pts, normals, dirs, feat, ws, bs, mm):
    """-> (output [N, d_out], each layer's f32 input, emb_view)."""
    mode, multires_view, squeeze_out = plan
    emb_view = embed(dirs, multires_view)
    x = _render_concat(pts, emb_view, normals, feat.float(), mode)
    acts = []
    for l, (w, b) in enumerate(zip(ws, bs)):
        acts.append(x)
        x = _mm(x, w, mm) + b
        if l < len(ws) - 1:
            x = torch.relu(x)
    y = torch.sigmoid(x) if squeeze_out else torch.relu(x)
    return y, acts, emb_view


def render_net_plain(plan, pts, normals, dirs, feat, ws, bs, *, mm) -> torch.Tensor:
    """plan = (mode, multires_view, squeeze_out) -> [N, d_out] f32; ``mm``:
    the operand mode (``torch.bfloat16`` or ``torch.float32``)."""
    return _render_forward(plan, pts, normals, dirs, feat, ws, bs, mm)[0]


def render_net_bwd_plain(plan, pts, normals, dirs, feat, ws, bs, g, *, mm):
    """Cotangent g [N, d_out] -> (d_pts, d_normals, d_dirs, d_feat, dws, dbs),
    step by step as ``_render_kernel_bwd``."""
    mode, multires_view, squeeze_out = plan
    y, acts, emb_view = _render_forward(plan, pts, normals, dirs, feat, ws, bs, mm)
    d = g * y * (1.0 - y) if squeeze_out else g * (y > 0.0).float()
    dws, dbs = [None] * len(ws), [None] * len(ws)
    for l in range(len(ws) - 1, -1, -1):
        dws[l] = _mm_dw(acts[l], d, mm)
        dbs[l] = d.sum(0)
        d = _mm_dx(d, ws[l], mm)
        if l > 0:
            d = d * (_r(acts[l], mm) > 0).float()
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


def _nerf_forward(plan, pts, views, trunk_w, trunk_b, head_w, head_b, mm):
    """-> (alpha, rgb, dpt | None, residuals of the backward)."""
    multires, multires_view, skips, _, has_dpt = plan
    emb_pts = embed(pts, multires)
    emb_view = embed(views, multires_view)
    h = emb_pts
    acts = []
    for i, (w, b) in enumerate(zip(trunk_w, trunk_b)):
        acts.append(h)
        h = torch.relu(_mm(h, w, mm) + b)
        if i in skips:
            h = torch.cat([emb_pts, h], dim=-1)
    alpha = _mm(h, head_w[0], mm) + head_b[0]
    feature = _mm(h, head_w[1], mm) + head_b[1]
    h2_in = torch.cat([feature, emb_view], dim=-1)
    h2 = torch.relu(_mm(h2_in, head_w[2], mm) + head_b[2])
    rgb = _mm(h2, head_w[3], mm) + head_b[3]
    dpt = _mm(h2, head_w[4], mm) + head_b[4] if has_dpt else None
    res = {"acts": acts, "h": h, "h2_in": h2_in, "h2": h2, "emb_pts": emb_pts,
           "emb_view": emb_view}
    return alpha, rgb, dpt, res


def nerf_plain(plan, pts, views, trunk_w, trunk_b, head_w, head_b, *, mm):
    """plan = (multires, multires_view, skips, D, has_dpt); heads ordered
    alpha, feature, views0, rgb[, dpt] -> (alpha, rgb, dpt | None); ``mm``:
    the operand mode (``torch.bfloat16`` or ``torch.float32``)."""
    return _nerf_forward(plan, pts, views, trunk_w, trunk_b, head_w, head_b, mm)[:3]


def nerf_bwd_plain(plan, pts, views, trunk_w, trunk_b, head_w, head_b,
                   g_alpha, g_rgb, g_dpt=None, *, mm):
    """Cotangents of (alpha, rgb[, dpt]) -> (d_pts, d_views, dtw, dtb, dhw,
    dhb), step by step as ``_nerf_kernel_bwd``."""
    multires, multires_view, skips, D, has_dpt = plan
    _, _, _, res = _nerf_forward(plan, pts, views, trunk_w, trunk_b, head_w, head_b, mm)
    acts, h, h2_in, h2 = res["acts"], res["h"], res["h2_in"], res["h2"]
    n_emb = res["emb_pts"].shape[-1]
    w_dim = head_w[1].shape[1]
    dhw, dhb = [None] * len(head_w), [None] * len(head_w)

    def head(idx, a_in, d):
        dhw[idx] = _mm_dw(a_in, d, mm)
        dhb[idx] = d.sum(0)

    d_h2 = _mm_dx(g_rgb, head_w[3], mm)
    head(3, h2, g_rgb)
    if has_dpt:
        if g_dpt is None:
            g_dpt = torch.zeros(pts.shape[0], head_w[4].shape[1], device=pts.device)
        d_h2 = d_h2 + _mm_dx(g_dpt, head_w[4], mm)
        head(4, h2, g_dpt)
    d_h2 = d_h2 * (h2 > 0).float()
    head(2, h2_in, d_h2)
    d_h2_in = _mm_dx(d_h2, head_w[2], mm)
    d_feature, d_emb_view = d_h2_in[:, :w_dim], d_h2_in[:, w_dim:]
    head(0, h, g_alpha)
    head(1, h, d_feature)
    d_h = _mm_dx(g_alpha, head_w[0], mm) + _mm_dx(d_feature, head_w[1], mm)

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
            relu_out = _r(acts[i + 1][:, n_emb:] if i in skips else acts[i + 1], mm)
        d_h = d_h * (relu_out > 0).float()
        dtw[i] = _mm_dw(acts[i], d_h, mm)
        dtb[i] = d_h.sum(0)
        d_h = _mm_dx(d_h, trunk_w[i], mm)
    d_emb_pts = d_emb_pts + d_h
    d_pts = _d_embed(d_emb_pts, pts, multires)
    d_views = _d_embed(d_emb_view, views, multires_view)
    return d_pts, d_views, dtw, dtb, dhw, dhb


# ---------------------------------------------------------------------------
# kernel launchers
# ---------------------------------------------------------------------------


def _pad16(x: int) -> int:
    return (x + 15) // 16 * 16


def _pack(layers, device, dtype=torch.bfloat16):
    """[(w [K, N], b [N])] -> (weights padded to [Kp, Np] and packed, bf16 for
    the kernels, f32 biases padded to Np and packed, per-layer meta). One
    gather each from the concatenated weights and biases, through an index
    cached per layer shapes: a few launches whatever the number of layers."""
    for w, b in layers:
        if b.shape != (w.shape[1],) or w.device != device:
            raise ValueError("fused_mlp: weight/bias shapes or devices disagree")
    widx, bidx, meta = _pack_index(tuple(tuple(w.shape) for w, _ in layers), device)
    zero = torch.zeros(1, device=device)
    W = torch.cat([zero] + [w.detach().float().reshape(-1) for w, _ in layers])
    B = torch.cat([zero] + [b.detach().float() for _, b in layers])
    return W.index_select(0, widx).to(dtype), B.index_select(0, bidx), list(meta)


@functools.lru_cache(maxsize=32)
def _pack_index(shapes: tuple, device: torch.device):
    """-> (source of each packed weight, of each packed bias, meta) for layers
    of these [K, N] shapes; source 0 is a zero, source 1 + i the i-th value
    of the concatenated flat weights (biases)."""
    meta, widx, bidx, wsrc, bsrc = [], [], [], 1, 1
    for K, N in shapes:
        Kp, Np = _pad16(K), _pad16(N)
        meta += [K, N, Kp, Np, sum(t.numel() for t in widx), sum(t.numel() for t in bidx)]
        w = torch.zeros(Kp, Np, dtype=torch.int64)
        w[:K, :N] = wsrc + torch.arange(K * N).view(K, N)
        b = torch.zeros(Np, dtype=torch.int64)
        b[:N] = bsrc + torch.arange(N)
        widx.append(w.reshape(-1))
        bidx.append(b)
        wsrc += K * N
        bsrc += N
    return torch.cat(widx).to(device), torch.cat(bidx).to(device), tuple(meta)


def _check_inputs(name, *tensors):
    for t in tensors:
        if t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(f"{name}: inputs must be 2-D f32, got {t.dtype} {tuple(t.shape)}")


def _check_shapes(name, n, *pairs):
    """Each (tensor, width) must be [n, width]."""
    for t, width in pairs:
        if tuple(t.shape) != (n, width):
            raise ValueError(f"{name}: expected [{n}, {width}], got {tuple(t.shape)}")


def _render_meta(plan, feat, ws, bs, device, dtype=torch.bfloat16):
    """The colour head's packed layers (W, B, meta), as K2, K3 and the ring
    image read them."""
    mode, multires_view, squeeze_out = plan
    e_view = 3 * (1 + 2 * multires_view) if multires_view > 0 else 3
    k0 = 3 + feat.shape[1] + (e_view if mode != "no_view_dir" else 0) + (
        3 if mode != "no_normal" else 0)
    if ws[0].shape[0] != k0:
        raise ValueError(f"render_net: first layer takes {ws[0].shape[0]} inputs, concat is {k0}")
    W, B, layer_meta = _pack(list(zip(ws, bs)), device, dtype)
    meta = [len(ws), _MODES[mode], int(squeeze_out), multires_view, 0, 3,
            feat.shape[1], 0, 0, 0, 0] + layer_meta
    return W, B, meta


def _emb_width(d: int, multires: int) -> int:
    return d * (1 + 2 * multires) if multires > 0 else d


def _nerf_meta(plan, d_a, trunk_w, trunk_b, head_w, head_b, device, dtype=torch.bfloat16):
    """K4/K5's packed layers: the trunk, [feature | alpha], views0, [rgb | dpt].

    The input after a skip layer is packed as [h | emb_pts] (the next layer's
    W rows permuted from the JAX order [emb_pts | h]), and feature comes
    before alpha, so that a forward output and its dx counterpart share a
    thread and register in the kernels. ``nerf_grads_from_packed`` maps the
    packed gradients back."""
    multires, multires_view, skips, D, has_dpt = plan
    e_a = _emb_width(d_a, multires)
    layers = []
    for i, (w, b) in enumerate(zip(trunk_w, trunk_b)):
        if i - 1 in skips:
            w = torch.cat([w[e_a:], w[:e_a]])
        layers.append((w, b))
    layers.append((torch.cat([head_w[1], head_w[0]], dim=1),
                   torch.cat([head_b[1], head_b[0]])))
    layers.append((head_w[2], head_b[2]))
    d_rgb = head_w[3].shape[1]
    d_dpt = head_w[4].shape[1] if has_dpt else 0
    if has_dpt:
        layers.append((torch.cat([head_w[3], head_w[4]], dim=1),
                       torch.cat([head_b[3], head_b[4]])))
    else:
        layers.append((head_w[3], head_b[3]))
    W, B, layer_meta = _pack(layers, device, dtype)
    skip_mask = sum(1 << i for i in skips if i < D)
    meta = [len(layers), 0, 0, multires, multires_view, d_a, 0, skip_mask, D,
            d_rgb, d_dpt] + layer_meta
    return W, B, meta


def nerf_grads_from_packed(meta, grads):
    """Per packed layer (dW [K, N], db [N]) of a ``_nerf_meta`` layer list ->
    (dtw, dtb, dhw, dhb) in the JAX order of ``nerf_bwd_plain``."""
    multires, d_a, skip_mask, D, d_rgb, d_dpt = (meta[k] for k in (3, 5, 7, 8, 9, 10))
    e_a = _emb_width(d_a, multires)
    dtw, dtb = [], []
    for i, (dw, db) in enumerate(grads[:D]):
        if i > 0 and (skip_mask >> (i - 1)) & 1:
            dw = torch.cat([dw[dw.shape[0] - e_a:], dw[:dw.shape[0] - e_a]])
        dtw.append(dw)
        dtb.append(db)
    (dw_fa, db_fa), (dw_v0, db_v0), (dw_rd, db_rd) = grads[D:]
    wf = dw_fa.shape[1] - 1
    dhw = [dw_fa[:, wf:], dw_fa[:, :wf], dw_v0, dw_rd[:, :d_rgb]]
    dhb = [db_fa[wf:], db_fa[:wf], db_v0, db_rd[:d_rgb]]
    if d_dpt:
        dhw.append(dw_rd[:, d_rgb:])
        dhb.append(db_rd[d_rgb:])
    return dtw, dtb, dhw, dhb


# The weight rings of the 128-row and the NeRF tile kernels (csrc/fused_mlp.cu,
# K2Ring, K4Ring, K5Ring): stages of one slab each, a slab being _KS reduction
# rows of a product pass of at most _MAX_OUT output columns, as wgmma reads it
# from shared memory. K2's stage count is a launch argument, the most of
# _K2_RING_STAGES that its two input tiles leave room for: 5 for the 304
# padded inputs of the colour and depth heads, 3 for depth_before_color's 400.
_RING_STAGES = 6
_K2_RING_STAGES = (5, 3)
_KS = 32
_MAX_OUT = 256
_THREADS = 256
# dynamic shared memory a block may use on the H100 (sm_90)
_SMEM_MAX = 232_448


def _render_smem(layers, stages: int) -> int:
    rows = 128
    ldh = max((Kp for _, _, Kp, _, _, _ in layers[1:]), default=0)
    smem = 2 * (stages * _KS * _MAX_OUT + rows * (layers[0][2] + ldh))
    return smem + -(-8 * (stages + 2) // 16) * 16


def render_ring_stages(meta) -> int:
    """K2's ring stages for a ``_render_meta`` layer list in the bf16 mode: the
    most of ``_K2_RING_STAGES`` whose carve fits (5 for the 304 padded inputs
    of the colour and depth heads; 3 for the colour head's 400 under
    ``depth_before_color``, 217,136 bytes); the fewest when none fits, which
    :func:`render_launch_plan` then refuses."""
    layers = _layers_of(meta)
    fits = [st for st in _K2_RING_STAGES if _render_smem(layers, st) <= _SMEM_MAX]
    return fits[0] if fits else _K2_RING_STAGES[-1]


def render_launch_plan(meta, n: int, sms: int, stages: int | None = None) -> tuple[int, int, int]:
    """-> (rows per tile, CTAs, dynamic shared-memory bytes) of K2 in the bf16
    mode on ``n`` rows of a ``_render_meta`` layer list, on a card of ``sms``
    SMs, its ring of ``stages`` stages (None: :func:`render_ring_stages`).
    The CTAs are persistent, one per SM (or per tile, if fewer), CTA i running
    tiles i, i + CTAs, ...; the bytes are its carve (csrc/fused_mlp.cu,
    render_fwd_kernel): the ring, then two bf16 tiles in the core layout,
    layer 0's input [rows, Kp0] and the hidden layers' [rows, max Kp of the
    later layers], then an mbarrier per ring stage and the two that hand the
    input tile from the producer warpgroup to the product warpgroups (the
    bytes rounded up to 16). The launcher takes both as given.

    At 5 stages a first layer wider than 320 inputs (padded) does not fit; at
    3 one wider than 448. The colour head under ``depth_before_color`` (289 +
    the depth head's 96 = 385 inputs at full width, 400 padded) runs at 3. A
    plan that does not fit is refused here, before any launch, with a
    ValueError. (The split f32 mode has no such limit: ``_SplitOps``.)"""
    layers = _layers_of(meta)
    stages = render_ring_stages(meta) if stages is None else stages
    if stages not in _K2_RING_STAGES:
        raise ValueError(f"render_fwd: {stages} ring stages; K2 runs {_K2_RING_STAGES}")
    smem = _render_smem(layers, stages)
    if smem > _SMEM_MAX:
        K0, _, Kp0 = layers[0][:3]
        raise ValueError(
            f"render_fwd: a first layer of {K0} inputs (padded to {Kp0}) needs {smem} bytes of "
            f"shared memory at {stages} ring stages, more than the {_SMEM_MAX} a block has; "
            "K2 takes at most 320 padded inputs beside 256-wide hidden layers at 5 stages, "
            "448 at 3 (depth_before_color widens the colour head's input by the depth "
            "features)")
    return 128, min(-(-n // 128), sms), smem


def render_schedule(meta):
    """K2's product passes, in the order the kernel runs them: (layer, dx,
    first output column, width), one forward pass per layer over its padded
    width (the output layer's 16 columns fill one 64-column chunk). The
    launcher checks that the list is exactly this."""
    return [(l, 0, 0, Np) for l, (_, _, _, Np, _, _) in enumerate(_layers_of(meta))]


def nerf_launch_plan(meta, bwd: bool) -> tuple[int, int]:
    """-> (rows per CTA, dynamic shared-memory bytes) of K4 (``bwd`` False)
    or K5's tile kernel for a ``_nerf_meta`` layer list, as the kernels carve
    it (csrc/fused_mlp.cu, nerf_fwd_kernel / nerf_bwd_kernel): the ring, the
    bf16 activation tile [rows, lda] and the two embeddings [rows, pad16(e)];
    K4 adds alpha's weight column in f32, K5 the relu-mask bits of the trunk
    and views0 (two 32-bit words per thread each), the db column sums of four
    warps and the f32 cotangents of the two embeddings; then one mbarrier per
    ring stage. The launchers take these bytes as given.

    This plan is the bf16 mode's. The split f32 mode has no tile kernel: each
    product is one launch of ``split_gemm_kernel`` on 128 x 128 output tiles,
    its persistent CTAs one an SM with a 3-stage ring of 32-deep f32 slabs, a
    2-stage ring of their split B and two epilogue staging blocks, 230,480
    bytes a CTA (``_SPLIT_TILE``, ``split_dw_plan``)."""
    layers = _layers_of(meta)
    multires, multires_view, d_a, D = meta[3], meta[4], meta[5], meta[8]
    e_a, e_b = _emb_width(d_a, multires), _emb_width(3, multires_view)
    lda = max(max(Kp, _pad16(N)) for _, N, Kp, _, _, _ in layers)
    rows = 64 if bwd else 128
    smem = 2 * (_RING_STAGES * _KS * _MAX_OUT + rows * (lda + _pad16(e_a) + _pad16(e_b)))
    if bwd:
        smem += 4 * ((D + 1) * 2 * _THREADS + 4 * _MAX_OUT + rows * (e_a + e_b))
    else:
        smem += 4 * layers[D][2]
    return rows, smem + 8 * _RING_STAGES


def nerf_schedule(meta, bwd: bool):
    """The product passes of K4 (``bwd`` False) or of K5's tile kernel, in the
    order the kernel runs them: (layer, dx, first output column, width). The
    forward through views0 ([feature | alpha] as its wf feature columns; alpha
    is a per-row dot), then K4's [rgb | dpt], or K5's dx of every layer from
    the last down, each in passes of at most _MAX_OUT columns with the pass
    from column 0 last. The launchers take this list as given, checking only
    that each pass lies inside its layer."""
    layers = _layers_of(meta)
    T = meta[8]
    out = [(l, 0, 0, layers[l][3]) for l in range(T)]
    out += [(T, 0, 0, layers[T][1] - 1), (T + 1, 0, 0, layers[T + 1][3])]
    if not bwd:
        return out + [(T + 2, 0, 0, layers[T + 2][3])]
    for l in range(T + 2, -1, -1):
        Kp = layers[l][2]
        out += [(l, 1, n0, min(_MAX_OUT, Kp - n0)) for n0 in range(_MAX_OUT, Kp, _MAX_OUT)]
        out.append((l, 1, 0, min(_MAX_OUT, Kp)))
    return out


@functools.lru_cache(maxsize=16)
def _ring_index(meta: tuple, schedules: tuple, device: torch.device):
    """-> (gather index into [packed W | 0] that gives the ring image, each
    of ``schedules`` as its launcher takes it: [n, then layer, dx, n0, width,
    the pass's offset in the image per pass]), cached per layer list.

    The image holds every slab of every pass of the schedules once, exactly as
    a ring stage holds it (the no-swizzle core-matrix layout of the wgmma
    machinery, zero past the layer), so that one bulk copy fills a stage:
    core matrix (n / 8, k / 8) of a slab at (n / 8) * 256 + (k / 8) * 64,
    its 16-byte row n % 8 (dx, K-major) or k % 8 (forward, MN-major); a pass
    of width w fills ceil(w / 64) * 64 output rows of each slab."""
    layers = _layers_of(meta)
    zero = sum(Kp * Np for _, _, Kp, Np, _, _ in layers)
    parts, offs, off = [], {}, 0
    for l, dx, n0, w in dict.fromkeys(q for sched in schedules for q in sched):
        _, _, Kp, Np, woff, _ = layers[l]
        rows = -(-w // 64) * 64
        slabs = -(-(Np if dx else Kp) // _KS)
        k = torch.arange(slabs * _KS)
        n = torch.arange(rows)
        if dx:
            src = woff + (n0 + n[:, None]) * Np + k[None, :]
            ok = (n[:, None] < w) & (k[None, :] < Np)
            g = torch.where(ok, src, zero).view(rows // 8, 8, slabs, _KS // 8, 8)
            g = g.permute(2, 0, 3, 1, 4)
        else:
            src = woff + k[:, None] * Np + n0 + n[None, :]
            ok = (k[:, None] < Kp) & (n[None, :] < w)
            g = torch.where(ok, src, zero).view(slabs, _KS, rows // 8, 8).permute(0, 2, 1, 3)
        parts.append(g.reshape(-1))
        offs[(l, dx, n0, w)] = off
        off += g.numel()
    idx = torch.cat(parts).to(device=device, dtype=torch.int32)
    return idx, [[len(ps)] + [v for q in ps for v in (*q, offs[q])] for ps in schedules]


def _ring(W, meta, schedules):
    """-> (the ring image of packed weights W, then each of ``schedules``
    with its passes' offsets in the image)."""
    idx, scheds = _ring_index(tuple(meta), tuple(tuple(s) for s in schedules), W.device)
    return (torch.index_select(torch.cat([W, W.new_zeros(1)]), 0, idx), *scheds)


def _nerf_ring(W, meta):
    """-> (the ring image of packed weights W, K4's schedule, K5's)."""
    return _ring(W, meta, (nerf_schedule(meta, False), nerf_schedule(meta, True)))


def _nerf_pack(plan, d_a, trunk_w, trunk_b, head_w, head_b, device):
    """-> what K4 and K5 launch on: the (W, B, meta) of _nerf_meta and
    _nerf_ring's (image, K4's schedule, K5's), built once for the pair."""
    W, B, meta = _nerf_meta(plan, d_a, trunk_w, trunk_b, head_w, head_b, device)
    return W, B, meta, _nerf_ring(W, meta)


def _render_pack(plan, feat, ws, bs, device):
    """-> what K2 launches on and K3 takes from it: the (W, B, meta) of
    _render_meta (K3 reads W) and (the ring image of W, K2's schedule)."""
    W, B, meta = _render_meta(plan, feat, ws, bs, device)
    return W, B, meta, _ring(W, meta, (render_schedule(meta),))


def _render_fwd_run(pts, normals, dirs, feat, packed):
    """K2's launch on contiguous inputs and weights packed by _render_pack ->
    [n, d_out]."""
    n = pts.shape[0]
    _, B, meta, (img, sched) = packed
    out = torch.empty(n, _layers_of(meta)[-1][1], device=pts.device, dtype=torch.float32)
    sms = torch.cuda.get_device_properties(pts.device).multi_processor_count
    stages = render_ring_stages(meta)
    _, ctas, smem = render_launch_plan(meta, n, sms, stages)
    err = build.library("fused_mlp").render_fwd_launch(
        pts.data_ptr(), normals.data_ptr(), dirs.data_ptr(), feat.data_ptr(), out.data_ptr(), n,
        img.data_ptr(), B.data_ptr(), build.int64_array(meta), build.int64_array(sched), ctas,
        smem, stages, build.stream_ptr(pts.device),
    )
    build.LAUNCHES["render_fwd"] += 1
    build.check(err, "render_fwd")
    return out


def _render_launch(plan, pts, normals, dirs, feat, ws, bs):
    """K2 -> (output [n, d_out], what _render_pack packed for it)."""
    _check_inputs("render_fwd", pts, normals, dirs, feat)
    _check_shapes("render_fwd", pts.shape[0], (pts, 3), (normals, 3), (dirs, 3),
                  (feat, feat.shape[1]))
    packed = _render_pack(plan, feat, ws, bs, pts.device)
    ins = (t.contiguous() for t in (pts, normals, dirs, feat))
    return _render_fwd_run(*ins, packed), packed


def _nerf_fwd_run(pts, views, packed, has_dpt):
    """K4's launch on contiguous inputs and weights packed by _nerf_pack ->
    (alpha, rgb, dpt | None)."""
    n = pts.shape[0]
    dev = pts.device
    W, B, meta, (img, sched, _) = packed
    d_rgb, d_dpt = meta[9], meta[10]
    alpha = torch.empty(n, 1, device=dev, dtype=torch.float32)
    rgb = torch.empty(n, d_rgb, device=dev, dtype=torch.float32)
    # without the dpt head the kernel never writes this buffer
    dpt = torch.empty(n if has_dpt else 1, max(d_dpt, 1), device=dev, dtype=torch.float32)
    err = build.library("fused_mlp").nerf_fwd_launch(
        pts.data_ptr(), views.data_ptr(), alpha.data_ptr(), rgb.data_ptr(),
        dpt.data_ptr(), n, W.data_ptr(), img.data_ptr(), B.data_ptr(), build.int64_array(meta),
        build.int64_array(sched), nerf_launch_plan(meta, False)[1], build.stream_ptr(dev),
    )
    build.LAUNCHES["nerf_fwd"] += 1
    build.check(err, "nerf_fwd")
    return alpha, rgb, dpt if has_dpt else None


def _nerf_launch(plan, pts, views, trunk_w, trunk_b, head_w, head_b):
    """K4 -> ((alpha, rgb, dpt | None), what _nerf_pack packed for it)."""
    _check_inputs("nerf_fwd", pts, views)
    packed = _nerf_pack(plan, pts.shape[1], trunk_w, trunk_b, head_w, head_b, pts.device)
    return _nerf_fwd_run(pts.contiguous(), views.contiguous(), packed, plan[4]), packed


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
    (d_pts, d_normals, d_dirs, d_feat), weights packed by _render_meta (as
    _render_pack packs them for K2); leaves the deltas and activations in
    ``scratch`` for its contraction."""
    err = build.library("fused_mlp").render_bwd_launch(
        *(t.data_ptr() for t in (*ins, *outs)), ins[0].shape[0], W.data_ptr(), B.data_ptr(),
        build.int64_array(meta), *scratch.tile_args(), build.stream_ptr(ins[0].device),
    )
    build.LAUNCHES["render_bwd"] += 1
    build.check(err, "render_bwd")


def _render_bwd_launch(plan, pts, normals, dirs, feat, ws, bs, g, packed=None):
    """K3 -> (d_pts, d_normals, d_dirs, d_feat, dws, dbs); ``packed``: what
    K2 launched with (_render_pack), else packed here."""
    _check_inputs("render_bwd", pts, normals, dirs, feat, g)
    n = pts.shape[0]
    # the first layer's width against feat's is checked by _render_meta
    _check_shapes("render_bwd", n, (pts, 3), (normals, 3), (dirs, 3), (feat, feat.shape[1]),
                  (g, ws[-1].shape[1]))
    dev = pts.device
    W, B, meta = packed[:3] if packed is not None else _render_meta(plan, feat, ws, bs, dev)
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


def _nerf_bwd_tile(ins, outs, packed, scratch: _BwdScratch) -> None:
    """K5's tile kernel: ins = contiguous (pts, views, g_alpha, g_rgb, g_dpt),
    outs = (d_pts, d_views), weights packed by _nerf_pack; leaves the deltas
    and activations in ``scratch`` for its contraction."""
    _, B, meta, (img, _, sched) = packed
    err = build.library("fused_mlp").nerf_bwd_launch(
        *(t.data_ptr() for t in (*ins, *outs)), ins[0].shape[0], img.data_ptr(), B.data_ptr(),
        build.int64_array(meta), build.int64_array(sched), nerf_launch_plan(meta, True)[1],
        *scratch.tile_args(), build.stream_ptr(ins[0].device),
    )
    build.LAUNCHES["nerf_bwd"] += 1
    build.check(err, "nerf_bwd")


def _nerf_bwd_launch(plan, pts, views, trunk_w, trunk_b, head_w, head_b,
                     g_alpha, g_rgb, g_dpt=None, packed=None):
    """K5 -> (d_pts, d_views, dtw, dtb, dhw, dhb); ``packed``: what K4
    launched with (_nerf_pack), else packed here."""
    has_dpt = plan[4]
    _check_inputs("nerf_bwd", pts, views, g_alpha, g_rgb)
    n, d_a = pts.shape
    dev = pts.device
    if packed is None:
        packed = _nerf_pack(plan, d_a, trunk_w, trunk_b, head_w, head_b, dev)
    meta = packed[2]
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
    _nerf_bwd_tile(ins, (d_pts, d_views), packed, scratch)
    scratch.contract()
    return (d_pts, d_views, *nerf_grads_from_packed(meta, scratch.grads()))


# ---------------------------------------------------------------------------
# the split-operand f32 mode (csrc/fused_mlp.cu, split_*)
# ---------------------------------------------------------------------------
#
# K2-K5 and the dW contraction with f32-accurate operands: each layer's
# product is one launch of split_gemm_kernel (3xTF32 on wgmma) whose
# epilogue applies the layer's bias and activation (or, backward, the relu
# mask or the output's delta), the activations and deltas live in f32 [n,
# width] buffers between launches, and every layer's dW, with its db summed
# in the same pass, is one grouped, row-split launch summed in split order by
# one reduction. A weight product (every forward and dx one) reads its B from
# a split image of the layer's weights, made for every layer and orientation
# of a call by one launch at its start (``SplitImage``); the contraction's B,
# a delta, is split as it is read. The schedules below list the launches on
# an ``ops`` object: ``_SplitOps`` launches them on the card; a test may pass
# one that computes them in torch, to hold the schedules to the plain
# versions on the CPU.

EPI_NONE, EPI_RELU, EPI_SIGMOID, EPI_MASK, EPI_DSIGMOID, EPI_DRELU = range(6)
# the contraction's tile: 128 output rows x 128 columns, 32-deep slabs
_SPLIT_TILE = (128, 128, 32)
# the weight path's tile widths (wgmma N), narrowest first
WEIGHT_TILES = (16, 32, 64, 96, 128)


def split_tile(n: int) -> int:
    """The weight path's tile width for an output of ``n`` columns: the
    narrowest of ``WEIGHT_TILES`` that holds it; past 128 columns whichever
    of 96 and 128 pads the output least (128 on a tie)."""
    for bn in WEIGHT_TILES[:-1]:
        if n <= bn:
            return bn
    return min((128, 96), key=lambda bn: -(-n // bn) * bn)


def image_words(K: int, N: int, bn: int) -> int:
    """Words of a K x N weight image in tiles of ``bn`` columns: a (tile,
    32-deep slab) block of big then small tf32, 2 * bn * 32 words each."""
    return -(-N // bn) * -(-K // 32) * 2 * bn * 32


class SplitImage(NamedTuple):
    """B of a weight product as split_gemm_kernel's weight path reads it:
    ``w`` (a layer's packed [Kp, Np] weights), or its transpose for a dx
    product (``trans``), split into big and small tf32 in tiles of ``bn``
    columns (:func:`split_image_plain` writes the same words). On the card
    the image lies in ``buf`` (the call's images, one allocation) from word
    ``off``; a stand-in that computes from ``w`` has no ``buf``."""

    buf: torch.Tensor | None
    off: int
    w: torch.Tensor
    trans: bool
    bn: int

    @property
    def K(self) -> int:
        return self.w.shape[1] if self.trans else self.w.shape[0]

    @property
    def N(self) -> int:
        return self.w.shape[0] if self.trans else self.w.shape[1]

    @property
    def t(self) -> torch.Tensor:
        """The image's words."""
        return self.buf[self.off:self.off + image_words(self.K, self.N, self.bn)]


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' split_tf32: big = x rounded to tf32 (to nearest, ties
    away), small = x - big cut to tf32."""
    big = ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return big, ((x - big).view(torch.int32) & -0x2000).view(torch.float32)


def split_image_plain(w: torch.Tensor, trans: bool, bn: int) -> torch.Tensor:
    """The weight image split_gemm_kernel(SplitImages) writes, in torch: for
    column tile j and slab s, block j * n_slabs + s holds B's big tf32 tile,
    then its small one, element (k, n) of each at (n / 8) * 256 + (k / 4) *
    32 + (n % 8) * 4 + k % 4 (wgmma's K-major core matrices); zero past B."""
    B = w.t() if trans else w
    K, N = B.shape
    tiles, slabs = -(-N // bn), -(-K // 32)
    padded = torch.zeros(slabs * 32, tiles * bn, dtype=torch.float32, device=w.device)
    padded[:K, :N] = B
    big, small = split_tf32(padded)
    # [k, n] -> [tile, slab, n / 8, k / 4, n % 8, k % 4]
    def order(x):
        return (x.view(slabs, 8, 4, tiles, bn // 8, 8).permute(3, 0, 4, 1, 5, 2)
                .reshape(tiles, slabs, bn * 32))
    return torch.stack([order(big), order(small)], 2).reshape(-1)


def split_dw_plan(n: int, layers, sms: int) -> tuple[int, int]:
    """Row splits of the split mode's dW contraction -> (splits,
    rows_per_split): at most two work items per SM (``sms``; the kernel's
    persistent CTAs, one an SM, walk them) over every layer's 128 x 128
    output tiles, each split a multiple of 32 rows and none empty."""
    tm, tn, tk = _SPLIT_TILE
    tiles = sum(-(-Kp // tm) * -(-Np // tn) for _, _, Kp, Np, _, _ in layers)
    splits = max(1, min(-(-n // tk), 2 * sms // tiles))
    rows = -(-(-(-n // splits)) // tk) * tk
    return -(-n // rows), rows


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _ld(t) -> int:
    return 0 if t is None else t.stride(0)


class _SplitOps:
    """The split mode's launches on the card, on 2-D f32 views whose rows are
    contiguous (any row stride that keeps 16-byte alignment), for the kernel
    ``name`` (``render_fwd_f32``, ...). Each launch adds one to
    ``build.LAUNCHES[name]`` where it is made, a launch of the dW contraction
    (:meth:`dw`: the products with the bias columns' sums, one reduction) to
    ``dw_contract_f32``; each launcher runs one grid. The program counters
    ``split_gemm.weights_bn<width>`` (a weight product, by tile width) and
    ``split_gemm.contraction`` count the product launches by path."""

    def __init__(self, device, name):
        self.device = device
        self.name = name
        self.lib = build.library("fused_mlp")
        self.stream = build.stream_ptr(device)
        self.sms = torch.cuda.get_device_properties(device).multi_processor_count

    def _launched(self, err, what, counter=None):
        build.LAUNCHES[counter or self.name] += 1
        build.check(err, what)

    def images(self, pairs):
        """[(w, trans)] -> their ``SplitImage``s, made by one launch."""
        shapes = [((w.shape[1], w.shape[0]) if trans else tuple(w.shape)) for w, trans in pairs]
        bns = [split_tile(N) for _, N in shapes]
        sizes = [image_words(K, N, bn) for (K, N), bn in zip(shapes, bns)]
        buf = torch.empty(sum(sizes), device=self.device)
        base = buf.data_ptr()
        imgs, rec, at = [], [], 0
        for (w, trans), (K, N), bn, size in zip(pairs, shapes, bns, sizes):
            imgs.append(SplitImage(buf, at, w, trans, bn))
            rec += [w.data_ptr(), w.stride(0), K, N, int(trans), bn, base + 4 * at]
            at += size
        self._launched(self.lib.split_image_launch(build.int64_array(rec), len(pairs),
                                                   self.stream), "split_image")
        return imgs

    def mm(self, A, img, C, *, bias=None, epi=EPI_NONE, aux=None, aux_n=0, n_store=None,
           C2=None, n_store2=0):
        """C[:, :n_store] (then C2[:, :n_store2]) <- epi(A B + bias): A [M, K],
        B [K, N] the weights of ``img`` (a ``SplitImage``)."""
        M, K = A.shape
        N = img.N
        if K != img.K:
            raise ValueError(f"split_mm: A has {K} columns, the image {img.K} rows")
        rec = [A.data_ptr(), A.stride(0), img.buf.data_ptr() + 4 * img.off, C.data_ptr(),
               C.stride(0), M, N, K, _ptr(bias), epi, _ptr(aux), _ld(aux), aux_n,
               N if n_store is None else n_store, _ptr(C2), _ld(C2), n_store2]
        trace.count(f"split_gemm.weights_bn{img.bn}")
        self._launched(self.lib.split_wmm_launch(build.int64_array(rec), 1, img.bn, self.sms,
                                                 self.stream), "split_mm")

    def embed(self, src, freqs, dst):
        """dst [n, width] <- src's embedding (``freqs`` bands; 0 copies), zero
        past it."""
        self._launched(self.lib.split_embed_launch(
            src.data_ptr(), src.stride(0), src.shape[1], freqs, src.shape[0], dst.data_ptr(),
            dst.stride(0), dst.shape[1], self.stream), "split_embed")

    def embed_vjp(self, srcs, x, freqs, out):
        """out [n, d] <- the embedding's VJP at x of sum(srcs) ([n, e] views)."""
        rec = [v for s in srcs for v in (s.data_ptr(), s.stride(0))]
        self._launched(self.lib.split_embed_vjp_launch(
            build.int64_array(rec), len(srcs), x.data_ptr(), x.shape[1], freqs, x.shape[0],
            out.data_ptr(), self.stream), "split_embed_vjp")

    def dw(self, pairs, layers):
        """Per layer (its input [n, Kp], its delta [n, Np]) -> (dW packed as
        the weights, db packed as the biases): one grouped launch of the
        contraction, split over rows, each split's db the column sums of the
        deltas taken in the same pass, then one reduction over the splits in
        split order."""
        n = pairs[0][0].shape[0]
        total_w = sum(Kp * Np for _, _, Kp, Np, _, _ in layers)
        total_b = sum(Np for _, _, _, Np, _, _ in layers)
        dev = self.device
        out = torch.empty(total_w + total_b, device=dev)
        if n == 0:
            out.zero_()
            return out[:total_w], out[total_w:]
        splits, rows = split_dw_plan(n, layers, self.sms)
        part = torch.empty(splits, total_w + total_b, device=dev)
        recs = []
        for (x, d), (_, _, Kp, Np, woff, boff) in zip(pairs, layers):
            recs += [x.data_ptr(), x.stride(0), d.data_ptr(), d.stride(0),
                     part.data_ptr() + 4 * woff, Np, Kp, Np, n, 0, EPI_NONE, 0, 0, 0, Np, 0, 0,
                     0, total_w + total_b, rows, part.data_ptr() + 4 * (total_w + boff)]
        lib, st, dw = self.lib, self.stream, "dw_contract_f32"
        trace.count("split_gemm.contraction")
        self._launched(lib.split_mm_launch(build.int64_array(recs), len(layers), splits, self.sms,
                                           st), "split_dw", dw)
        self._launched(lib.split_reduce_launch(part.data_ptr(), splits, total_w + total_b,
                                               out.data_ptr(), st), "split_dw_reduce", dw)
        return out[:total_w], out[total_w:]


def _w_of(W, B, layer):
    """A packed layer's weights [Kp, Np] and bias [Np] as views."""
    _, _, Kp, Np, woff, boff = layer
    return W[woff:woff + Kp * Np].view(Kp, Np), B[boff:boff + Np]


def _grads_of(dW, dB, layers):
    return [(dW[woff:woff + Kp * Np].view(Kp, Np)[:K, :N], dB[boff:boff + N])
            for K, N, Kp, Np, woff, boff in layers]


def split_render(ops, plan, pts, normals, dirs, feat, packed, g=None):
    """K2 in the split mode -> [n, d_out]; given the output's cotangent ``g``,
    K3 -> (d_pts, d_normals, d_dirs, d_feat, per-layer (dW, db)). ``packed``:
    ``_render_meta``'s (W, B, meta) in f32. The backward recomputes the
    forward keeping every layer's input; the output layer's epilogue gives
    its delta at once."""
    mode, freqs_v, squeeze = plan
    W, B, meta = packed
    layers = _layers_of(meta)
    n, dev, L = pts.shape[0], pts.device, len(layers)
    e_view = _emb_width(3, freqs_v)
    c_nrm = 3 + (e_view if mode != "no_view_dir" else 0)
    c_feat = c_nrm + (3 if mode != "no_normal" else 0)
    x = torch.empty(n, layers[0][2], device=dev)
    ops.embed(pts, 0, x[:, :3])
    if mode != "no_view_dir":
        ops.embed(dirs, freqs_v, x[:, 3:3 + e_view])
    if mode != "no_normal":
        ops.embed(normals, 0, x[:, c_nrm:c_nrm + 3])
    ops.embed(feat, 0, x[:, c_feat:])
    ws, bs = zip(*(_w_of(W, B, layer) for layer in layers))
    imgs = ops.images([(w, False) for w in ws] + ([(w, True) for w in ws] if g is not None else []))
    acts = [x]
    for l, (layer, b) in enumerate(zip(layers, bs)):
        N, Np = layer[1], layer[3]
        if l + 1 < L:
            x = torch.empty(n, Np, device=dev)
            ops.mm(acts[-1], imgs[l], x, bias=b, epi=EPI_RELU)
            acts.append(x)
            if g is None:
                acts[-2] = None
        elif g is None:
            out = torch.empty(n, N, device=dev)
            ops.mm(acts[-1], imgs[l], out, bias=b, epi=EPI_SIGMOID if squeeze else EPI_RELU,
                   n_store=N)
            return out
        else:
            d = torch.empty(n, Np, device=dev)
            ops.mm(acts[-1], imgs[l], d, bias=b, epi=EPI_DSIGMOID if squeeze else EPI_DRELU,
                   aux=g, aux_n=N)
    dels = [None] * L
    dels[L - 1] = d
    for l in range(L - 1, -1, -1):
        dx = torch.empty(n, layers[l][2], device=dev)
        if l > 0:
            ops.mm(dels[l], imgs[L + l], dx, epi=EPI_MASK, aux=acts[l], aux_n=layers[l][2])
            dels[l - 1] = dx
        else:
            ops.mm(dels[0], imgs[L], dx)
    d_pts = torch.empty(n, 3, device=dev)
    ops.embed_vjp([dx[:, :3]], pts, 0, d_pts)
    d_dirs = torch.zeros(n, 3, device=dev)
    if mode != "no_view_dir":
        ops.embed_vjp([dx[:, 3:3 + e_view]], dirs, freqs_v, d_dirs)
    d_nrm = torch.zeros(n, 3, device=dev)
    if mode != "no_normal":
        ops.embed_vjp([dx[:, c_nrm:c_nrm + 3]], normals, 0, d_nrm)
    d_feat = torch.empty(n, feat.shape[1], device=dev)
    ops.embed_vjp([dx[:, c_feat:c_feat + feat.shape[1]]], feat, 0, d_feat)
    dW, dB = ops.dw(list(zip(acts, dels)), layers)
    return d_pts, d_nrm, d_dirs, d_feat, _grads_of(dW, dB, layers)


def split_nerf(ops, pts, views, packed, grads_out=None):
    """K4 in the split mode -> (alpha, rgb, dpt | None); given the outputs'
    cotangents ``grads_out`` = (g_alpha, g_rgb, g_dpt | None), K5 -> (d_pts,
    d_views, per packed layer (dW, db)). ``packed``: ``_nerf_meta``'s (W, B,
    meta) in f32: the trunk (after a skip layer its input is [h | emb_pts]),
    [feature | alpha], views0 over [feature | emb_view], [rgb | dpt]."""
    W, B, meta = packed
    layers = _layers_of(meta)
    multires, multires_view, d_a, skip_mask, T, d_rgb, d_dpt = (
        meta[k] for k in (3, 4, 5, 7, 8, 9, 10))
    n, dev = pts.shape[0], pts.device
    wt, wf = layers[0][1], layers[T][1] - 1
    bwd = grads_out is not None
    skip_in = [i + 1 for i in range(T - 1) if (skip_mask >> i) & 1]  # inputs [h | emb_pts]
    X = [None] * (T + 3)
    X[0] = torch.empty(n, layers[0][2], device=dev)
    ops.embed(pts, multires, X[0])
    for i in skip_in:
        X[i] = torch.empty(n, layers[i][2], device=dev)
        ops.embed(pts, multires, X[i][:, wt:])
    X[T + 1] = torch.empty(n, layers[T + 1][2], device=dev)
    ops.embed(views, multires_view, X[T + 1][:, wf:])
    ws, bs = zip(*(_w_of(W, B, layer) for layer in layers))
    # the forward's images (the backward's recompute stops before [rgb | dpt]),
    # then the backward's dx images, layer by layer
    fwd = ops.images([(w, False) for w in ws[:T + 2 if bwd else T + 3]]
                     + ([(w, True) for w in ws] if bwd else []))
    dxs = fwd[T + 2:] if bwd else None
    for i in range(T):
        if X[i + 1] is None:
            X[i + 1] = torch.empty(n, layers[i][3], device=dev)
        ops.mm(X[i], fwd[i], X[i + 1], bias=bs[i], epi=EPI_RELU, n_store=wt)
        if not bwd:
            X[i] = None
    alpha = torch.empty(n, 1, device=dev)
    ops.mm(X[T], fwd[T], X[T + 1], bias=bs[T], n_store=wf, C2=alpha, n_store2=1)
    X[T + 2] = torch.empty(n, layers[T + 1][3], device=dev)
    ops.mm(X[T + 1], fwd[T + 1], X[T + 2], bias=bs[T + 1], epi=EPI_RELU)
    if not bwd:
        rgb = torch.empty(n, d_rgb, device=dev)
        dpt = torch.empty(n, d_dpt, device=dev) if d_dpt else None
        ops.mm(X[T + 2], fwd[T + 2], rgb, bias=bs[T + 2], n_store=d_rgb, C2=dpt, n_store2=d_dpt)
        return alpha, rgb, dpt
    g_alpha, g_rgb, g_dpt = grads_out
    D = [None] * (T + 3)  # each layer's delta, [n, Np] views
    D[T + 2] = torch.empty(n, layers[T + 2][3], device=dev)
    if d_dpt:
        ops.embed(g_rgb, 0, D[T + 2][:, :d_rgb])
        ops.embed(g_dpt, 0, D[T + 2][:, d_rgb:])
    else:
        ops.embed(g_rgb, 0, D[T + 2])
    # views0's delta under its relu mask, then its dx: [d_feature | d_emb_view]
    D[T + 1] = torch.empty(n, layers[T + 2][2], device=dev)
    ops.mm(D[T + 2], dxs[T + 2], D[T + 1], epi=EPI_MASK, aux=X[T + 2], aux_n=layers[T + 2][2])
    dv = torch.empty(n, layers[T + 1][2], device=dev)
    ops.mm(D[T + 1], dxs[T + 1], dv)
    D[T] = torch.empty(n, layers[T][3], device=dev)
    ops.embed(dv[:, :wf], 0, D[T][:, :wf])
    ops.embed(g_alpha, 0, D[T][:, wf:])
    # the trunk in reverse: dx of layer i under layer i-1's relu mask (the
    # first wt columns; a skip input's embedding columns unmasked)
    skip_dx = []  # the embedding columns of the skip inputs' dx, deepest first
    for i in range(T, 0, -1):
        dx = torch.empty(n, layers[i][2], device=dev)
        ops.mm(D[i], dxs[i], dx, epi=EPI_MASK, aux=X[i], aux_n=wt)
        D[i - 1] = dx[:, :wt]
        if i in skip_in:
            skip_dx.append(dx[:, wt:])
    dx0 = torch.empty(n, layers[0][2], device=dev)
    ops.mm(D[0], dxs[0], dx0)
    e_a = _emb_width(d_a, multires)
    d_pts = torch.empty(n, d_a, device=dev)
    ops.embed_vjp([s[:, :e_a] for s in skip_dx] + [dx0[:, :e_a]], pts, multires, d_pts)
    d_views = torch.empty(n, 3, device=dev)
    ops.embed_vjp([dv[:, wf:wf + _emb_width(3, multires_view)]], views, multires_view, d_views)
    dW, dB = ops.dw(list(zip(X, D)), layers)
    return d_pts, d_views, _grads_of(dW, dB, layers)


def _render_launch_f32(plan, pts, normals, dirs, feat, ws, bs):
    """K2 in the split mode -> (output [n, d_out], its f32 pack)."""
    _check_inputs("render_fwd", pts, normals, dirs, feat)
    _check_shapes("render_fwd", pts.shape[0], (pts, 3), (normals, 3), (dirs, 3),
                  (feat, feat.shape[1]))
    packed = _render_meta(plan, feat, ws, bs, pts.device, torch.float32)
    ins = (t.contiguous() for t in (pts, normals, dirs, feat))
    return split_render(_SplitOps(pts.device, "render_fwd_f32"), plan, *ins, packed), packed


def _render_bwd_launch_f32(plan, pts, normals, dirs, feat, ws, bs, g, packed=None):
    """K3 and its dW contraction in the split mode -> (d_pts, d_normals,
    d_dirs, d_feat, dws, dbs); ``packed``: the forward's f32 pack."""
    _check_inputs("render_bwd", pts, normals, dirs, feat, g)
    n = pts.shape[0]
    _check_shapes("render_bwd", n, (pts, 3), (normals, 3), (dirs, 3), (feat, feat.shape[1]),
                  (g, ws[-1].shape[1]))
    if packed is None:
        packed = _render_meta(plan, feat, ws, bs, pts.device, torch.float32)
    ins = tuple(t.contiguous() for t in (pts, normals, dirs, feat))
    *outs, grads = split_render(_SplitOps(pts.device, "render_bwd_f32"), plan, *ins, packed,
                                g=g.contiguous())
    return (*outs, [dw for dw, _ in grads], [db for _, db in grads])


def _nerf_launch_f32(plan, pts, views, trunk_w, trunk_b, head_w, head_b):
    """K4 in the split mode -> ((alpha, rgb, dpt | None), its f32 pack)."""
    _check_inputs("nerf_fwd", pts, views)
    packed = _nerf_meta(plan, pts.shape[1], trunk_w, trunk_b, head_w, head_b, pts.device,
                        torch.float32)
    ops = _SplitOps(pts.device, "nerf_fwd_f32")
    return split_nerf(ops, pts.contiguous(), views.contiguous(), packed), packed


def _nerf_bwd_launch_f32(plan, pts, views, trunk_w, trunk_b, head_w, head_b,
                         g_alpha, g_rgb, g_dpt=None, packed=None):
    """K5 and its dW contraction in the split mode -> (d_pts, d_views, dtw,
    dtb, dhw, dhb); ``packed``: the forward's f32 pack."""
    has_dpt = plan[4]
    _check_inputs("nerf_bwd", pts, views, g_alpha, g_rgb)
    n, d_a = pts.shape
    if packed is None:
        packed = _nerf_meta(plan, d_a, trunk_w, trunk_b, head_w, head_b, pts.device,
                            torch.float32)
    meta = packed[2]
    d_rgb, d_dpt = meta[9], meta[10]
    if has_dpt and g_dpt is None:
        g_dpt = torch.zeros(n, d_dpt, device=pts.device)
    _check_shapes("nerf_bwd", n, (views, 3), (g_alpha, 1), (g_rgb, d_rgb),
                  *([(g_dpt, d_dpt)] if has_dpt else []))
    gs = (g_alpha.contiguous(), g_rgb.contiguous(), g_dpt.contiguous() if has_dpt else None)
    d_pts, d_views, grads = split_nerf(_SplitOps(pts.device, "nerf_bwd_f32"), pts.contiguous(),
                                       views.contiguous(), packed, gs)
    return (d_pts, d_views, *nerf_grads_from_packed(meta, grads))


# ---------------------------------------------------------------------------
# autograd Functions and wrappers
# ---------------------------------------------------------------------------


def _on(t: torch.Tensor, name: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type


class _RenderNet(torch.autograd.Function):
    """Forward K2 (or its plain version), backward K3 (or its plain version),
    in the operand mode ``mm``; cotangents for the four inputs and every
    effective weight and bias."""

    @staticmethod
    def forward(ctx, plan, mm, pts, normals, dirs, feat, *wb):
        n = len(wb) // 2
        ws, bs = list(wb[:n]), list(wb[n:])
        ctx.plan, ctx.mm = plan, mm
        ctx.save_for_backward(pts, normals, dirs, feat, *wb)
        ctx.packed = None
        if _on(pts, "render_net") == "cpu":
            return render_net_plain(plan, pts, normals, dirs, feat, ws, bs, mm=mm)
        # the backward launches K3 on the weights K2 was launched with
        launch = _render_launch if mm == torch.bfloat16 else _render_launch_f32
        out, ctx.packed = launch(plan, pts, normals, dirs, feat.float(), ws, bs)
        return out

    @staticmethod
    def backward(ctx, g):
        pts, normals, dirs, feat, *wb = ctx.saved_tensors
        n = len(wb) // 2
        ws, bs = wb[:n], wb[n:]
        args = (ctx.plan, pts, normals, dirs, feat.float(), ws, bs, g.float())
        if _on(g, "render_net") == "cpu":
            out = render_net_bwd_plain(*args, mm=ctx.mm)
        elif ctx.mm == torch.bfloat16:
            out = _render_bwd_launch(*args, packed=ctx.packed)
        else:
            out = _render_bwd_launch_f32(*args, packed=ctx.packed)
        d_pts, d_nrm, d_dirs, d_feat, dws, dbs = out
        return (None, None, d_pts, d_nrm, d_dirs, d_feat.to(feat.dtype), *dws, *dbs)


class _NeRF(torch.autograd.Function):
    """Forward K4 (or its plain version), backward K5 (or its plain version),
    in the operand mode ``mm``; cotangents for pts, views and every effective
    weight and bias."""

    @staticmethod
    def forward(ctx, plan, mm, pts, views, *weights):
        D, n_head = plan[3], 5 if plan[4] else 4
        ctx.plan, ctx.mm = plan, mm
        ctx.save_for_backward(pts, views, *weights)
        args = _split_nerf(weights, D, n_head)
        ctx.packed = None
        if _on(pts, "nerf") == "cpu":
            alpha, rgb, dpt = nerf_plain(plan, pts, views, *args, mm=mm)
        else:
            # the backward launches K5 on the weights K4 was launched with
            launch = _nerf_launch if mm == torch.bfloat16 else _nerf_launch_f32
            (alpha, rgb, dpt), ctx.packed = launch(plan, pts, views, *args)
        return (alpha, rgb) if dpt is None else (alpha, rgb, dpt)

    @staticmethod
    def backward(ctx, g_alpha, g_rgb, g_dpt=None):
        pts, views, *weights = ctx.saved_tensors
        D, n_head = ctx.plan[3], 5 if ctx.plan[4] else 4
        args = (ctx.plan, pts, views, *_split_nerf(weights, D, n_head), g_alpha, g_rgb, g_dpt)
        if _on(g_alpha, "nerf") == "cpu":
            out = nerf_bwd_plain(*args, mm=ctx.mm)
        elif ctx.mm == torch.bfloat16:
            out = _nerf_bwd_launch(*args, packed=ctx.packed)
        else:
            out = _nerf_bwd_launch_f32(*args, packed=ctx.packed)
        d_pts, d_views, dtw, dtb, dhw, dhb = out
        return (None, None, d_pts, d_views, *dtw, *dtb, *dhw, *dhb)


def _split_nerf(weights, D, n_head):
    w = list(weights)
    return w[:D], w[D:2 * D], w[2 * D:2 * D + n_head], w[2 * D + n_head:]


def render_net(plan, pts, normals, dirs, feat, ws, bs, mm) -> torch.Tensor:
    """Colour head. plan = (mode, multires_view, squeeze_out); ws/bs
    effective [in, out] weights and biases; ``mm``: the operand mode
    (``torch.bfloat16`` or ``torch.float32``).
    -> [N, d_out] f32."""
    return _RenderNet.apply(plan, _mode(mm), pts, normals, dirs, feat, *ws, *bs)


def nerf(plan, pts, views, trunk_w, trunk_b, head_w, head_b, mm):
    """Background NeRF. plan = (multires, multires_view, skips, D, has_dpt);
    ``mm`` as :func:`render_net`'s.
    -> (alpha [N,1], rgb [N,rgb_dims], dpt [N,dpt_dim] | None)."""
    out = _NeRF.apply(plan, _mode(mm), pts, views, *trunk_w, *trunk_b, *head_w, *head_b)
    return out[0], out[1], out[2] if len(out) > 2 else None
