"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (``cuda`` marker) and skip without one: a CUDA
kernel has no CPU interpret mode. The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Inputs and weights are numpy-seeded, at small widths and odd row counts so
the ragged last tile is exercised. Tolerances: K1 (f32 throughout) atol 1e-4,
for summation order and last-ulp differences of exp/log1p/sin/cos; K2/K4
(bf16 operands, f32 accumulation on both sides) two bf16 ulps at the output's
scale, 2^-7 * max(1, max|plain|), because a last-ulp difference upstream can
flip one bf16 rounding. K3/K5 (the backward kernels): each dW/db within 2^-7
of its largest entry (the kernel sums rows in another order than the plain
version, so a delta near a bf16 rounding boundary can round the other way);
the input cotangents with at least 99.9% of their elements at the K2/K4
tolerance and a relative L2 error within 2^-7, because a row whose
pre-activation lies within f32 summation noise of a relu kink, or whose
sigmoid output is so near 1 that 1 - y keeps few bits, differs by a few
percent on its own; and two launches on the same inputs agree bit for bit
(the cross-CTA reduction is in a fixed order).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vdnerf_tpu_torch.ops.kernels import build, fused_mlp, sdf_fwd

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _weights(rng, dims, device):
    ws = [torch.tensor(rng.normal(size=(k, n)) / np.sqrt(k), dtype=torch.float32, device=device)
          for k, n in dims]
    bs = [torch.tensor(rng.normal(size=n) * 0.05, dtype=torch.float32, device=device)
          for _, n in dims]
    return ws, bs


def _bf16_close(got, want):
    err = float((got - want).abs().max())
    assert err <= 2.0**-7 * max(1.0, float(want.abs().max())), err


def _rel_close(got, want):
    err = float((got - want).abs().max())
    assert err <= 2.0**-7 * float(want.abs().max()), err


def _cotangent_close(got, want):
    d = (got - want).abs()
    within = float((d <= 2.0**-7 * max(1.0, float(want.abs().max()))).float().mean())
    assert within >= 0.999, within
    assert float(d.norm()) <= 2.0**-7 * float(want.norm()), float(d.norm() / want.norm())


def _nerf_inputs(rng, n, has_dpt, device):
    D, W, skips, multires, multires_view = 4, 32, (2,), 4, 2
    e_pts, e_view = 4 * (1 + 2 * multires), 3 * (1 + 2 * multires_view)
    tw, tb = _weights(rng, [(e_pts, W)] + [(W + e_pts if i - 1 in skips else W, W)
                                         for i in range(1, D)], device)
    hw, hb = _weights(rng, [(W, 1), (W, W), (W + e_view, W // 2), (W // 2, 3)]
                      + ([(W // 2, 7)] if has_dpt else []), device)
    p = rng.normal(size=(n, 3))
    pts = np.concatenate([p / np.linalg.norm(p, axis=-1, keepdims=True),
                          rng.uniform(0, 1, size=(n, 1))], -1)
    pts = torch.tensor(pts, dtype=torch.float32, device=device)
    views = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32, device=device)
    plan = (multires, multires_view, skips, D, has_dpt)
    return plan, pts, views, (tw, tb, hw, hb)


@pytest.mark.parametrize("hidden,n_lin,skip,multires,scale", [
    (64, 5, (2,), 6, 1.0), (32, 3, (), 4, 1.0), (64, 5, (2,), 6, 2.0)])
def test_sdf_kernel_matches_plain(card, hidden, n_lin, skip, multires, scale):
    rng = np.random.default_rng(0)
    d_emb = 3 * (1 + 2 * multires)
    dims, width = [], d_emb
    for l in range(n_lin):
        k = width + (d_emb if l in skip else 0)
        n = 1 if l == n_lin - 1 else (hidden - d_emb if l + 1 in skip else hidden)
        dims.append((k, n))
        width = n
    ws, bs = _weights(rng, dims, card)
    pts = torch.tensor(rng.uniform(-1, 1, size=(301, 3)), dtype=torch.float32, device=card)
    before = build.LAUNCHES["sdf_fwd"]
    got = sdf_fwd.sdf_value(pts, ws, bs, skip, multires, scale)
    assert build.LAUNCHES["sdf_fwd"] == before + 1
    want = sdf_fwd.sdf_value_plain(pts, ws, bs, skip, multires, scale)
    assert got.shape == (301, 1)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode,multires_view,d_small,squeeze_out", [
    ("idr", 4, 3 + 27 + 3, True), ("no_view_dir", 0, 3 + 3, True),
    ("no_normal", 4, 3 + 27, False)])
def test_render_kernel_matches_plain(card, mode, multires_view, d_small, squeeze_out):
    rng = np.random.default_rng(2)
    ws, bs = _weights(rng, [(d_small + 32, 48), (48, 48), (48, 3)], card)
    pts, nrm, dirs = (torch.tensor(rng.normal(size=(77, 3)), dtype=torch.float32, device=card)
                      for _ in range(3))
    feat = torch.tensor(rng.normal(size=(77, 32)), dtype=torch.float32, device=card)
    plan = (mode, multires_view, squeeze_out)
    before = build.LAUNCHES["render_fwd"]
    got = fused_mlp.render_net(plan, pts, nrm, dirs, feat, ws, bs)
    assert build.LAUNCHES["render_fwd"] == before + 1
    _bf16_close(got, fused_mlp.render_net_plain(plan, pts, nrm, dirs, feat, ws, bs))


@pytest.mark.parametrize("has_dpt", [False, True])
def test_nerf_kernel_matches_plain(card, has_dpt):
    plan, pts, views, (tw, tb, hw, hb) = _nerf_inputs(np.random.default_rng(3), 83, has_dpt, card)
    before = build.LAUNCHES["nerf_fwd"]
    got = fused_mlp.nerf(plan, pts, views, tw, tb, hw, hb)
    assert build.LAUNCHES["nerf_fwd"] == before + 1
    want = fused_mlp.nerf_plain(plan, pts, views, tw, tb, hw, hb)
    assert (got[2] is None) == (not has_dpt)
    for g, w in zip(got, want):
        if w is not None:
            _bf16_close(g, w)


def _check_grads(got, want, n_inputs):
    flat = lambda xs: [t for x in xs for t in (x if isinstance(x, list) else [x])]  # noqa: E731
    got, want = flat(got), flat(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        (_cotangent_close if i < n_inputs else _rel_close)(g, w)


@pytest.mark.parametrize("mode,multires_view,d_small,squeeze_out", [
    ("idr", 4, 3 + 27 + 3, True), ("idr", 4, 3 + 27 + 3, False),
    ("no_view_dir", 0, 3 + 3, True), ("no_normal", 4, 3 + 27, True)])
def test_render_bwd_kernel_matches_plain(card, mode, multires_view, d_small, squeeze_out):
    rng = np.random.default_rng(12)
    ws, bs = _weights(rng, [(d_small + 32, 48), (48, 48), (48, 3)], card)
    pts, nrm, dirs = (torch.tensor(rng.normal(size=(141, 3)), dtype=torch.float32, device=card)
                      for _ in range(3))
    feat = torch.tensor(rng.normal(size=(141, 32)), dtype=torch.float32, device=card)
    g = torch.tensor(rng.normal(size=(141, 3)), dtype=torch.float32, device=card)
    plan = (mode, multires_view, squeeze_out)
    args = (plan, pts, nrm, dirs, feat, ws, bs, g)
    before = build.LAUNCHES["render_bwd"]
    got = fused_mlp._render_bwd_launch(*args)
    again = fused_mlp._render_bwd_launch(*args)
    assert build.LAUNCHES["render_bwd"] == before + 2
    _check_grads(got, fused_mlp.render_net_bwd_plain(*args), 4)
    for a, b in zip(got[:4] + tuple(got[4]) + tuple(got[5]),
                    again[:4] + tuple(again[4]) + tuple(again[5])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("has_dpt", [False, True])
def test_nerf_bwd_kernel_matches_plain(card, has_dpt):
    rng = np.random.default_rng(13)
    plan, pts, views, weights = _nerf_inputs(rng, 141, has_dpt, card)
    gs = [torch.tensor(rng.normal(size=(141, k)), dtype=torch.float32, device=card)
          for k in ([1, 3, 7] if has_dpt else [1, 3])]
    before = build.LAUNCHES["nerf_bwd"]
    got = fused_mlp._nerf_bwd_launch(plan, pts, views, *weights, *gs)
    again = fused_mlp._nerf_bwd_launch(plan, pts, views, *weights, *gs)
    assert build.LAUNCHES["nerf_bwd"] == before + 2
    _check_grads(got, fused_mlp.nerf_bwd_plain(plan, pts, views, *weights, *gs), 2)
    for a, b in zip(got[:2] + tuple(t for l in got[2:] for t in l),
                    again[:2] + tuple(t for l in again[2:] for t in l)):
        assert torch.equal(a, b)


def test_autograd_through_the_kernels(card):
    """torch.autograd.grad through the Functions launches K2/K3 and K4/K5."""
    rng = np.random.default_rng(14)
    ws, bs = _weights(rng, [(3 + 27 + 3 + 32, 48), (48, 48), (48, 3)], card)
    leaves = [w.requires_grad_(True) for w in ws + bs]
    x = [torch.tensor(rng.normal(size=(99, k)), dtype=torch.float32, device=card)
         for k in (3, 3, 3, 32)]
    before = dict(build.LAUNCHES)
    out = fused_mlp.render_net(("idr", 4, True), *x, ws, bs)
    grads = torch.autograd.grad(out.square().sum(), leaves)
    plan, pts, views, weights = _nerf_inputs(rng, 99, False, card)
    nleaves = [t.requires_grad_(True) for group in weights for t in group]
    alpha, rgb, _ = fused_mlp.nerf(plan, pts, views, *weights)
    grads += torch.autograd.grad(alpha.sum() + rgb.square().sum(), nleaves)
    for k in ("render_fwd", "render_bwd", "nerf_fwd", "nerf_bwd"):
        assert build.LAUNCHES[k] == before[k] + 1, k
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_kernels_refuse_an_f32_policy(card, monkeypatch):
    rng = np.random.default_rng(4)
    ws, bs = _weights(rng, [(3 + 27 + 3 + 8, 16), (16, 3)], card)
    x = torch.zeros(5, 3, device=card)
    monkeypatch.setattr(fused_mlp, "_MM_DTYPE", torch.float32)
    with pytest.raises(RuntimeError, match="bf16 only"):
        fused_mlp.render_net(("idr", 4, True), x, x, x, torch.zeros(5, 8, device=card), ws, bs)


def _sdf_full_width(rng, device):
    dims = [(39, 256), (256, 256), (256, 256), (256, 217)] + [(256, 256)] * 4 + [(256, 1)]
    ws = [torch.tensor(rng.normal(size=(k, n)) * np.sqrt(2.0 / n), dtype=torch.float32,
                       device=device) for k, n in dims]
    bs = [torch.tensor(rng.normal(size=n) * 0.05, dtype=torch.float32, device=device)
          for _, n in dims]
    return ws, bs


@pytest.mark.parametrize("n", [1, 63, 8192, 20001])
def test_sdf_kernel_full_width_row_counts(card, n):
    """Both tile heights (32 rows below two 64-row CTAs per SM, 64 above),
    a tile with one row, a ragged tail; two launches bit-identical."""
    rng = np.random.default_rng(21)
    ws, bs = _sdf_full_width(rng, card)
    pts = torch.tensor(rng.uniform(-1, 1, size=(n, 3)), dtype=torch.float32, device=card)
    got = sdf_fwd.sdf_value(pts, ws, bs, (4,), 6, 1.0)
    assert torch.equal(got, sdf_fwd.sdf_value(pts, ws, bs, (4,), 6, 1.0))
    torch.testing.assert_close(got, sdf_fwd.sdf_value_plain(pts, ws, bs, (4,), 6, 1.0),
                               atol=1e-4, rtol=0)


def _rel_l2_close(got, want, tol=2.0**-6):
    err = float((got - want).norm() / want.norm().clamp_min(1e-30))
    assert err <= tol, err


@pytest.mark.parametrize("n,width", [(1, 64), (63, 64), (8192, 64), (8192, 256), (1001, 256)])
def test_render_bwd_kernel_row_counts(card, n, width):
    """K3 at few rows, ragged, and the training ladder's 8,192 rows, at a one-
    chunk width (64) and at full width (256, the 5-chunk first-layer dx);
    each output within 2^-6 relative L2 (the full-width noise of PERF.md)
    and two launches bit-identical."""
    rng = np.random.default_rng(22)
    ws, bs = _weights(rng, [(3 + 27 + 3 + width, width)] + [(width, width)] * 3 + [(width, 3)],
                      card)
    pts, nrm, dirs = (torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32, device=card)
                      for _ in range(3))
    feat = torch.tensor(rng.normal(size=(n, width)) * 0.5, dtype=torch.float32, device=card)
    g = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32, device=card)
    args = (("idr", 4, True), pts, nrm, dirs, feat, ws, bs, g)
    flat = lambda xs: [t for x in xs for t in (x if isinstance(x, list) else [x])]  # noqa: E731
    got, again = flat(fused_mlp._render_bwd_launch(*args)), flat(fused_mlp._render_bwd_launch(*args))
    want = flat(fused_mlp.render_net_bwd_plain(*args))
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        _rel_l2_close(a, w)


@pytest.mark.parametrize("n", [63, 8192, 16896])
def test_dw_contraction_matches_matmul(card, n):
    """The contraction alone, on the scratch one K3 launch left: every layer's
    dW equals acts_l^T dels_l in f32 (same bf16 products, another summation
    order), db the column sums of the tile partials, and a second launch of
    the contraction gives the same bits."""
    rng = np.random.default_rng(23)
    ws, bs = _weights(rng, [(3 + 27 + 3 + 256, 256)] + [(256, 256)] * 3 + [(256, 3)], card)
    x = [torch.tensor(rng.normal(size=(n, k)), dtype=torch.float32, device=card)
         for k in (3, 3, 3, 256)]
    g = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32, device=card)
    W, B, meta = fused_mlp._render_meta(("idr", 4, True), x[3], ws, bs, card)
    sc = fused_mlp._BwdScratch(n, meta, card)
    fused_mlp._render_bwd_tile((*x, g), [torch.empty_like(t) for t in x], W, B, meta, sc)
    before = build.LAUNCHES["dw_contract"]
    sc.contract()
    dW, dB = sc.dW.clone(), sc.dB.clone()
    sc.contract()
    assert build.LAUNCHES["dw_contract"] == before + 2
    assert torch.equal(dW, sc.dW) and torch.equal(dB, sc.dB)
    aoff = doff = 0
    for K, N, Kp, Np, woff, boff in sc.layers:
        want = sc.acts[:, aoff:aoff + Kp].float().t() @ sc.dels[:, doff:doff + Np].float()
        got = dW[woff:woff + Kp * Np].view(Kp, Np)
        torch.testing.assert_close(got, want, atol=1e-5 * float(want.abs().max()) + 1e-6, rtol=1e-4)
        torch.testing.assert_close(dB[boff:boff + Np], sc.dbpart[:, boff:boff + Np].sum(0),
                                   atol=1e-5 * float(dB.abs().max()) + 1e-6, rtol=1e-4)
        aoff += Kp
        doff += Np
