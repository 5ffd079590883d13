"""The SDF block: the SDF network's value, spatial gradient and feature as one
autograd Function, its elementwise stages hand-written CUDA kernels.

:class:`SDFBlock` takes the points and each linear's effective [out, in]
weight and bias (the weight norm stays autograd's, outside) and returns
``(sdf [N, 1], grad [N, 3], feat [N, d_out - 1])``. It writes out what
``torch.autograd.grad(create_graph=True)`` and the outer backward would
differentiate, in f32:

- **Forward**: the linears as f32 products (``F.linear``), each hidden one's
  softplus(100) in one stage (:func:`act`), which also writes the skip
  layer's ``[h, emb] / sqrt(2)`` input. Then the gradient's chain down the
  layers: it starts from the last layer's sdf row as a broadcast row (the
  chain's cotangent there is constant), and at each hidden layer takes one
  product with the weight and one stage ``* sigma(100 z)`` (:func:`tangent`).
  The embedding's Jacobian finishes it (:func:`embed_grad`).
- **Backward** (once differentiable): one sweep up carries the gradient
  chain's cotangent (:func:`embed_cot`, then per layer a product and
  :func:`up`, which also forms the second-order term
  ``rbar * p * 100 sigma (1 - sigma)``); one sweep down carries the ordinary
  cotangent with that term added (:func:`down`). Each weight's gradient sums
  one product from each sweep. The points' gradient, with the embedding's
  second derivative (:func:`embed_vjp`), only where the points require it
  (the learned cameras).

Every product is an f32 ``torch.mm`` / ``F.linear`` (cuBLAS, TF32 as the
process allows it); every elementwise stage launches ``csrc/sdf_block.cu``
for CUDA tensors (one count in ``build.LAUNCHES["sdf_block"]`` each) and
runs its plain formula (``<stage>_plain``, which takes tensors of either
device) for CPU tensors. Stages write into given tensors,
column slices of larger ones included, and allocate nothing on the card, so
a step's CUDA graph captures them. The bf16 policy keeps autograd's route
(``models/fields.py``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from vdnerf_tpu_torch.models.embedder import embed, embed_dim, freqs
from vdnerf_tpu_torch.models.layers import softplus_beta
from vdnerf_tpu_torch.ops.kernels import build

_BETA = 100.0
_C = 1.0 / math.sqrt(2.0)  # the skip's scale
_MAX_TAILS = 4
_ROWS_PER_CTA = 8  # of the row stages (csrc/sdf_block.cu's kRows)


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """The network's shape around its weights: the embedding's bands, the
    input scale and the skip layers (each 1 <= l <= n_linear - 2)."""

    multires: int
    scale: float
    skip_in: tuple[int, ...]


# -- the stages: a kernel for CUDA tensors, the plain formula for CPU ones --


def _block(t: torch.Tensor | None) -> tuple:
    """(pointer, row stride) of an f32 block with unit column stride."""
    if t is None:
        return None, 0
    if t.dtype != torch.float32 or t.dim() != 2 or (t.stride(1) != 1 and t.shape[1] > 1):
        raise ValueError(f"sdf_block: needs f32 [n, c] blocks with unit column stride, got "
                         f"{t.dtype} {tuple(t.shape)} {t.stride()}")
    return t.data_ptr(), t.stride(0)


def _row(t: torch.Tensor | None):
    """The pointer of a contiguous f32 row, or None."""
    if t is None:
        return None
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError("sdf_block: a broadcast row must be contiguous f32")
    return t.data_ptr()


def _launch(fn: str, device, *args) -> None:
    err = getattr(build.library("sdf_block"), fn)(*args, build.stream_ptr(device))
    build.LAUNCHES["sdf_block"] += 1
    build.check(err, fn)


def _tails(tails: list[torch.Tensor]) -> ctypes.Array:
    if len(tails) > _MAX_TAILS:
        raise ValueError(f"sdf_block: at most {_MAX_TAILS} skip layers")
    vals = [len(tails)] + [v for t in tails for v in _block(t)]
    return (ctypes.c_longlong * len(vals))(*vals)


def _sigmoid(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """sigma(100 z) and its derivative in z, from e = exp(-|100 z|)."""
    bz = _BETA * z
    e = torch.exp(-bz.abs())
    t = 1.0 / (1.0 + e)
    return torch.where(bz > 0, t, e * t), _BETA * (e * t) * t


def act(z, out, coef: float = 1.0, tail=None, tcoef: float = 1.0) -> None:
    """out[:, :C] = coef softplus_100(z); out[:, C:] = tcoef tail."""
    if not z.is_cuda:
        return act_plain(z, out, coef, tail, tcoef)
    n, C = z.shape
    T = 0 if tail is None else tail.shape[1]
    _launch("sdfb_act_launch", z.device, *_block(z), *_block(out), n, C, coef, *_block(tail), T,
            tcoef)


def tangent(q, pvec, pcoef: float, z, out) -> None:
    """out = p sigma(100 z), p = pcoef q, or the broadcast row ``pvec``."""
    if not z.is_cuda:
        return tangent_plain(q, pvec, pcoef, z, out)
    n, C = z.shape
    _launch("sdfb_tangent_launch", z.device, *_block(q), _row(pvec), pcoef, *_block(z),
            *_block(out), n, C)


def _partials(n: int, C: int, like: torch.Tensor) -> torch.Tensor:
    """The kernels' per-CTA column sums: one row per 8 rows of the stage."""
    return torch.empty(-(-n // _ROWS_PER_CTA), C, device=like.device, dtype=torch.float32)


def up(rbar, q, pvec, pcoef: float, z, qbar, s2, tail=None, tcoef: float = 1.0,
       colsum: bool = False):
    """The sweep up through one layer's ``r = p sigma(100 z)``:
    qbar[:, :C] = pcoef rbar sigma, qbar[:, C:] = tcoef tail, and the
    second-order term s2 = rbar p 100 sigma (1 - sigma). With ``colsum``,
    returns the column sums of qbar[:, :C] (``qbar`` may then be None: the
    sum is its only use below the last layer); else None."""
    if not z.is_cuda:
        return up_plain(rbar, q, pvec, pcoef, z, qbar, s2, tail, tcoef, colsum)
    n, C = z.shape
    T = 0 if tail is None else tail.shape[1]
    psum = _partials(n, C, z) if colsum else None
    _launch("sdfb_up_launch", z.device, *_block(rbar), *_block(q), _row(pvec), pcoef,
            *_block(z), *_block(qbar), *_block(s2), None if psum is None else psum.data_ptr(),
            n, C, *_block(tail), T, tcoef)
    return psum.sum(0) if colsum else None


def down(abar, acoef: float, z, s2, out) -> torch.Tensor:
    """The sweep down through one layer's activation:
    out = acoef abar sigma(100 z) + s2 (``out`` may be ``s2``) -> its column
    sums (the bias's gradient)."""
    if not z.is_cuda:
        return down_plain(abar, acoef, z, s2, out)
    n, C = z.shape
    psum = _partials(n, C, z)
    _launch("sdfb_down_launch", z.device, *_block(abar), acoef, *_block(z), *_block(s2),
            *_block(out), psum.data_ptr(), n, C)
    return psum.sum(0)


def embed_grad(q0, tails, tcoef: float, e, L: int, scale: float, E_out=None) -> torch.Tensor:
    """The spatial gradient from the sdf's cotangent at the embedding,
    E = q0 + tcoef sum(tails): grad = scale E J(scale pts) [N, 3]; E is
    written to ``E_out`` where given."""
    if not q0.is_cuda:
        return embed_grad_plain(q0, tails, tcoef, e, L, scale, E_out)
    n = q0.shape[0]
    grad = torch.empty(n, 3, device=q0.device, dtype=torch.float32)
    _launch("sdfb_embed_grad_launch", q0.device, *_block(q0), _tails(tails), tcoef, *_block(e),
            grad.data_ptr(), None if E_out is None else E_out.data_ptr(), n, L, scale)
    return grad


def embed_cot(gbar, e, L: int, scale: float, out) -> None:
    """The gradient's cotangent at the embedding: out = scale gbar J^T."""
    if not gbar.is_cuda:
        return embed_cot_plain(gbar, e, L, scale, out)
    _launch("sdfb_embed_cot_launch", gbar.device, gbar.data_ptr(), *_block(e), *_block(out),
            gbar.shape[0], L, scale)


def embed_vjp(abar0, tails, tcoef: float, gbar, E, e, L: int, scale: float) -> torch.Tensor:
    """The points' cotangent [N, 3]: the embedding's, abar0 + tcoef sum(tails),
    through J^T, plus the gradient's own dependence on the points through J,
    times scale."""
    if not abar0.is_cuda:
        return embed_vjp_plain(abar0, tails, tcoef, gbar, E, e, L, scale)
    n = abar0.shape[0]
    out = torch.empty(n, 3, device=abar0.device, dtype=torch.float32)
    _launch("sdfb_embed_vjp_launch", abar0.device, *_block(abar0), _tails(tails), tcoef,
            gbar.data_ptr(), E.data_ptr(), *_block(e), out.data_ptr(), n, L, scale)
    return out


# -- the stages' plain formulas: the CPU's route, and the card's yardstick --


def act_plain(z, out, coef: float = 1.0, tail=None, tcoef: float = 1.0) -> None:
    C = z.shape[1]
    out[:, :C] = softplus_beta(z, _BETA) * coef
    if tail is not None:
        out[:, C:] = tail * tcoef


def tangent_plain(q, pvec, pcoef: float, z, out) -> None:
    p = pvec if pvec is not None else pcoef * q
    out.copy_(p * _sigmoid(z)[0])


def up_plain(rbar, q, pvec, pcoef: float, z, qbar, s2, tail=None, tcoef: float = 1.0,
             colsum: bool = False):
    C = z.shape[1]
    s, ds = _sigmoid(z)
    p = pvec if pvec is not None else pcoef * q
    qb = pcoef * (rbar * s)
    if qbar is not None:
        qbar[:, :C] = qb
    s2.copy_(rbar * p * ds)
    if tail is not None:
        qbar[:, C:] = tail * tcoef
    return qb.sum(0) if colsum else None


def down_plain(abar, acoef: float, z, s2, out) -> torch.Tensor:
    out.copy_(acoef * abar * _sigmoid(z)[0] + s2)
    return out.sum(0)


def _parts(t: torch.Tensor, L: int):
    """An embedding-shaped [N, 3 (1 + 2L)] block -> its x [N, 3], sin and cos
    parts [N, L, 3]."""
    rest = t[:, 3:].reshape(t.shape[0], L, 2, 3)
    return t[:, :3], rest[:, :, 0], rest[:, :, 1]


def _freqs(L: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(freqs(L), dtype=like.dtype, device=like.device).view(1, L, 1)


def _gathered(base, tails, tcoef):
    out = base
    for t in tails:
        out = out + tcoef * t
    return out


def embed_grad_plain(q0, tails, tcoef: float, e, L: int, scale: float,
                     E_out=None) -> torch.Tensor:
    E = _gathered(q0, tails, tcoef)
    if E_out is not None:
        E_out.copy_(E)
    g = E[:, :3]
    if L > 0:
        _, es, ec = _parts(E, L)
        _, sn, cs = _parts(e, L)
        g = g + (_freqs(L, e) * (es * cs - ec * sn)).sum(1)
    return scale * g


def embed_cot_plain(gbar, e, L: int, scale: float, out) -> None:
    g = scale * gbar
    out[:, :3] = g
    if L > 0:
        _, sn, cs = _parts(e, L)
        gf = g[:, None, :] * _freqs(L, e)
        out[:, 3:] = torch.stack([gf * cs, -gf * sn], 2).reshape(gbar.shape[0], 6 * L)


def embed_vjp_plain(abar0, tails, tcoef: float, gbar, E, e, L: int,
                    scale: float) -> torch.Tensor:
    eb = _gathered(abar0, tails, tcoef)
    u = eb[:, :3]
    if L > 0:
        f = _freqs(L, e)
        _, sn, cs = _parts(e, L)
        _, ebs, ebc = _parts(eb, L)
        _, Es, Ec = _parts(E, L)
        u = u + (f * (ebs * cs - ebc * sn)).sum(1)
        u = u - scale * gbar * (f * f * (Es * sn + Ec * cs)).sum(1)
    return scale * u


# -- the block --


def _check(plan: BlockPlan, ws) -> None:
    n = len(ws)
    if n < 2 or any(not 1 <= l <= n - 2 for l in plan.skip_in):
        raise ValueError(f"sdf_block: skip layers {plan.skip_in} outside 1..{n - 2}")


def forward(plan: BlockPlan, pts, ws, bs, keep: bool = False, keep_E: bool = False):
    """(sdf, grad, feat, saved): the block's forward. ``saved`` is None
    unless ``keep`` (the backward's tensors: each linear's input, each
    hidden pre-activation, the gradient chain at each, and, with ``keep_E``,
    the sdf's cotangent at the embedding)."""
    _check(plan, ws)
    n_lin, N, dev = len(ws), pts.shape[0], pts.device
    L, scale, skips = plan.multires, plan.scale, plan.skip_in
    d0 = embed_dim(L)
    e = embed(pts * scale, L)
    a, As, Zs = e, [], []
    for l in range(n_lin - 1):
        z = F.linear(a, ws[l], bs[l])
        if keep:
            As.append(a)
        Zs.append(z)
        C = z.shape[1]
        skip = (l + 1) in skips
        a = torch.empty(N, C + (d0 if skip else 0), device=dev, dtype=torch.float32)
        act(z, a, _C if skip else 1.0, e if skip else None, _C)
    if keep:
        As.append(a)
    o = F.linear(a, ws[-1], bs[-1])
    del a
    sdf, feat = o[:, :1] / scale, o[:, 1:]

    # the gradient's chain, from the last layer's sdf row down
    w0 = ws[-1][0] / scale
    Rs, Qs = [None] * (n_lin - 1), [None] * (n_lin - 1)
    r = torch.empty_like(Zs[-1])
    tangent(None, w0, 1.0, Zs[-1], r)
    for l in range(n_lin - 2, -1, -1):
        q = torch.mm(r, ws[l])
        if keep:
            Rs[l] = r
        if keep or l in skips:
            Qs[l] = q
        if l > 0:
            C = Zs[l - 1].shape[1]
            r = torch.empty_like(Zs[l - 1])
            tangent(q[:, :C], None, _C if l in skips else 1.0, Zs[l - 1], r)
    E = torch.empty(N, d0, device=dev, dtype=torch.float32) if keep_E else None
    grad = embed_grad(q, [Qs[l][:, -d0:] for l in skips], _C, e, L, scale, E)
    saved = (As, Zs, Rs, Qs[1:], E) if keep else None
    return sdf, grad, feat, saved


def backward(plan: BlockPlan, ws, saved, g_sdf, g_grad, g_feat, want_params: bool,
             want_pts: bool):
    """The cotangents of (sdf, grad, feat) -> (points' gradient or None,
    weights' gradients, biases' gradients), the parameters' None unless
    ``want_params``."""
    As, Zs, Rs, Qs, E = saved
    Qs = [None] + list(Qs)
    n_lin = len(ws)
    L, scale, skips = plan.multires, plan.scale, plan.skip_in
    e = As[0]
    N, d0, dev = e.shape[0], e.shape[1], e.device
    dW, db = [None] * n_lin, [None] * n_lin

    # up: the gradient chain's cotangent, from the embedding to the last layer
    Ebar = torch.empty(N, d0, device=dev, dtype=torch.float32)
    embed_cot(g_grad.contiguous(), e, L, scale, Ebar)
    qbar, S2 = Ebar, [None] * (n_lin - 1)
    for l in range(n_lin - 1):
        rbar = torch.mm(qbar, ws[l].t())
        if want_params:
            dW[l] = torch.mm(Rs[l].t(), qbar)
        C = rbar.shape[1]
        S2[l] = torch.empty_like(rbar)
        if l == n_lin - 2:  # below the last layer, whose sdf row is the chain's start
            qsum = up(rbar, None, ws[-1][0] / scale, 1.0, Zs[l], None, S2[l], colsum=True)
            break
        skip = (l + 1) in skips
        qbar = torch.empty(N, C + (d0 if skip else 0), device=dev, dtype=torch.float32)
        up(rbar, Qs[l + 1][:, :C], None, _C if skip else 1.0, Zs[l], qbar, S2[l],
           Ebar if skip else None, _C)

    # down: the ordinary cotangent, the second-order terms added
    zbar = torch.cat([g_sdf / scale, g_feat], dim=1)
    if want_params:
        dW[-1] = torch.mm(zbar.t(), As[-1])
        dW[-1][0] += qsum / scale
        db[-1] = zbar.sum(0)
    abar = torch.mm(zbar, ws[-1])
    tails = []
    for l in range(n_lin - 2, -1, -1):
        C = Zs[l].shape[1]
        skip = (l + 1) in skips
        if skip:
            tails.append(abar[:, C:])
        zb = S2[l]
        bias_grad = down(abar[:, :C], _C if skip else 1.0, Zs[l], zb, zb)
        if want_params:
            db[l] = bias_grad
            dW[l].addmm_(zb.t(), As[l])
        if l > 0 or want_pts:
            abar = torch.mm(zb, ws[l])
    d_pts = embed_vjp(abar, tails, _C, g_grad.contiguous(), E, e, L, scale) if want_pts else None
    return d_pts, dW, db


class SDFBlock(torch.autograd.Function):
    """``SDFBlock.apply(plan, pts, *ws, *bs)`` -> (sdf, grad, feat); see the
    module's docstring."""

    @staticmethod
    def forward(ctx, plan: BlockPlan, pts, *params):
        n_lin = len(params) // 2
        ws, bs = params[:n_lin], params[n_lin:]
        want_pts = ctx.needs_input_grad[1]
        sdf, grad, feat, saved = forward(plan, pts, ws, bs, keep=True, keep_E=want_pts)
        As, Zs, Rs, Qs, E = saved
        ctx.plan, ctx.n_lin, ctx.has_E = plan, n_lin, E is not None
        ctx.save_for_backward(*ws, *As, *Zs, *Rs, *Qs, *([E] if E is not None else []))
        return sdf, grad, feat

    @staticmethod
    @once_differentiable
    def backward(ctx, g_sdf, g_grad, g_feat):
        n = ctx.n_lin
        t = ctx.saved_tensors
        ws, As, Zs = t[:n], t[n:2 * n], t[2 * n:3 * n - 1]
        Rs, Qs = t[3 * n - 1:4 * n - 2], t[4 * n - 2:5 * n - 4]
        E = t[5 * n - 4] if ctx.has_E else None
        want_params = any(ctx.needs_input_grad[2:])
        d_pts, dW, db = backward(ctx.plan, ws, (As, Zs, Rs, Qs, E), g_sdf, g_grad, g_feat,
                                 want_params, ctx.needs_input_grad[1])
        return (None, d_pts, *dW, *db)

