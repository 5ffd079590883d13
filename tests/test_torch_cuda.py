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

The monodepth side-car (cuDNN convolutions, no kernel of the port's own) is
held on the card against the same module on the CPU: DenseNet-161's taps
within 1e-4 relative L2, one training step's loss within 1e-3 and its
encoder gradient within 1e-3 or the CPU's own f32 error; its predict CLI
runs on the card when no device is given.
"""

from __future__ import annotations

import os

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


def _render_inputs(rng, n, d_feat, device):
    pts, nrm, dirs = (torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32, device=device)
                      for _ in range(3))
    feat = torch.tensor(rng.normal(size=(n, d_feat)) * 0.5, dtype=torch.float32, device=device)
    return pts, nrm, dirs, feat


@pytest.mark.parametrize("n,d_feat,aligned", [(0, 32, True), (77, 30, True), (77, 32, False),
                                              (300, 36, True)])
def test_render_kernel_input_paths(card, n, d_feat, aligned):
    """K2's input tile from a feature width that is not a multiple of 4, or a
    feature buffer off a 16-byte boundary (the scalar path), a width that is
    (the 16-byte path), and no rows at all."""
    rng = np.random.default_rng(5)
    ws, bs = _weights(rng, [(3 + 27 + 3 + d_feat, 48), (48, 40), (40, 3)], card)
    pts, nrm, dirs, feat = _render_inputs(rng, n, d_feat, card)
    if not aligned:
        buf = torch.empty(n * d_feat + 1, device=card)[1:].view(n, d_feat)
        feat = buf.copy_(feat)
        assert feat.is_contiguous() and feat.data_ptr() % 16
    plan = ("idr", 4, True)
    got = fused_mlp.render_net(plan, pts, nrm, dirs, feat, ws, bs)
    assert got.shape == (n, 3)
    if n:
        _bf16_close(got, fused_mlp.render_net_plain(plan, pts, nrm, dirs, feat, ws, bs))


@pytest.mark.parametrize("dims", [[(3 + 27 + 3 + 32, 272), (272, 3)], [(3 + 27 + 3 + 32, 48),
                                                                      (48, 264)]])
def test_render_kernel_refuses_a_pass_wider_than_256(card, dims):
    rng = np.random.default_rng(6)
    ws, bs = _weights(rng, dims, card)
    with pytest.raises(RuntimeError, match="render_fwd launch failed"):
        fused_mlp.render_net(("idr", 4, True), *_render_inputs(rng, 9, 32, card), ws, bs)


def _render_full_width(rng, n, d_out, device):
    """The colour head of womsk_white_tpu, 289 -> 256 x4 -> d_out: 3, or the
    96 of the wdepth recipe's depth head, which is the same net."""
    ws, bs = _weights(rng, [(289, 256)] + [(256, 256)] * 3 + [(256, d_out)], device)
    return ("idr", 4, True), _render_inputs(rng, n, 256, device), ws, bs


@pytest.mark.parametrize("d_out", [3, 96])
@pytest.mark.parametrize("n", [1, 63, 127, 128, 129, 65536 + 37, 393216 + 37])
def test_render_kernel_full_width_row_counts(card, n, d_out):
    """K2 at full width around its 128-row tiles and at a training step's
    and a serving chunk's rows with a ragged tail, against the plain version."""
    plan, x, ws, bs = _render_full_width(np.random.default_rng(26), n, d_out, card)
    got = fused_mlp.render_net(plan, *x, ws, bs)
    want = fused_mlp.render_net_plain(plan, *x, ws, bs)
    assert got.shape == want.shape == (n, d_out)
    _bf16_close(got, want)


@pytest.mark.parametrize("n,width", [(141, 48), (1001, 256)])
def test_render_bwd_on_the_forward_pack(card, n, width):
    """K3 launched on the weights K2 packed (as the autograd Function hands
    them over) equals K3 packing its own, bit for bit."""
    rng = np.random.default_rng(27)
    ws, bs = _weights(rng, [(3 + 27 + 3 + width, width), (width, width), (width, 3)], card)
    x = _render_inputs(rng, n, width, card)
    g = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32, device=card)
    plan = ("idr", 4, True)
    _, packed = fused_mlp._render_launch(plan, *x, ws, bs)
    flat = lambda xs: [t for x in xs for t in (x if isinstance(x, list) else [x])]  # noqa: E731
    got = flat(fused_mlp._render_bwd_launch(plan, *x, ws, bs, g, packed=packed))
    want = flat(fused_mlp._render_bwd_launch(plan, *x, ws, bs, g))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


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


def _nerf_full_width(rng, n, has_dpt, device):
    """The background NeRF of womsk_white_tpu: 8x256, skip after 4, 84-ch
    point and 27-ch view embeddings, heads alpha, feature, views0, rgb[, dpt
    96]; points on the unit sphere with an inverse radius."""
    t_dims = [(84, 256)] + [(256, 256)] * 4 + [(340, 256)] + [(256, 256)] * 2
    h_dims = [(256, 1), (256, 256), (283, 128), (128, 3)] + ([(128, 96)] if has_dpt else [])
    tw, tb = _weights(rng, t_dims, device)
    hw, hb = _weights(rng, h_dims, device)
    p = rng.normal(size=(n, 3))
    pts = np.concatenate([p / np.linalg.norm(p, axis=-1, keepdims=True),
                          rng.uniform(0, 1, size=(n, 1))], -1)
    v = rng.normal(size=(n, 3))
    views = v / np.linalg.norm(v, axis=-1, keepdims=True)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    return (10, 4, (4,), 8, has_dpt), t(pts), t(views), (tw, tb, hw, hb)


NERF_ROWS = [1, 63, 64, 127, 128, 129, 16896 + 37]


@pytest.mark.parametrize("has_dpt", [False, True])
@pytest.mark.parametrize("n", NERF_ROWS)
def test_nerf_kernel_full_width_row_counts(card, n, has_dpt):
    """K4 at full width around its 128-row tiles and at a training step's
    outside rows with a ragged tail, against the plain version."""
    plan, pts, views, weights = _nerf_full_width(np.random.default_rng(24), n, has_dpt, card)
    got = fused_mlp.nerf(plan, pts, views, *weights)
    want = fused_mlp.nerf_plain(plan, pts, views, *weights)
    assert (got[2] is None) == (not has_dpt)
    for g, w in zip(got, want):
        if w is not None:
            assert g.shape == w.shape
            _bf16_close(g, w)


@pytest.mark.parametrize("has_dpt", [False, True])
@pytest.mark.parametrize("n", NERF_ROWS)
def test_nerf_bwd_kernel_full_width_row_counts(card, n, has_dpt):
    """K5 at full width: each output within 2^-6 relative L2 of the plain
    version (the full-width noise of PERF.md) and two launches bit-identical."""
    rng = np.random.default_rng(25)
    plan, pts, views, weights = _nerf_full_width(rng, n, has_dpt, card)
    gs = [torch.tensor(rng.normal(size=(n, k)), dtype=torch.float32, device=card)
          for k in ([1, 3, 96] if has_dpt else [1, 3])]
    flat = lambda xs: [t for x in xs for t in (x if isinstance(x, list) else [x])]  # noqa: E731
    args = (plan, pts, views, *weights, *gs)
    got, again = flat(fused_mlp._nerf_bwd_launch(*args)), flat(fused_mlp._nerf_bwd_launch(*args))
    want = flat(fused_mlp.nerf_bwd_plain(*args))
    assert len(got) == len(want)
    for a, b, w in zip(got, again, want):
        assert a.shape == w.shape and torch.equal(a, b)
        _rel_l2_close(a, w)


def test_sdf_kernel_mesh_grid_matches_plain(card):
    """The mesh grid through K1 at 65^3: one full 64^3 chunk and a ragged one
    of 12,481 rows, against the same grid through the plain version."""
    from vdnerf_tpu_torch.mesh.extract import grid_values

    rng = np.random.default_rng(23)
    ws, bs = _sdf_full_width(rng, card)
    before = build.LAUNCHES["sdf_fwd"]
    got = grid_values([-1.01] * 3, [1.01] * 3, 65,
                      lambda p: sdf_fwd.sdf_value(p, ws, bs, (4,), 6, 1.0), device=card)
    assert build.LAUNCHES["sdf_fwd"] == before + 2
    want = grid_values([-1.01] * 3, [1.01] * 3, 65,
                       lambda p: sdf_fwd.sdf_value_plain(p, ws, bs, (4,), 6, 1.0), device=card)
    assert got.shape == (65, 65, 65) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_masked_render_launches_no_background_kernel(card):
    """The masked regime's renderer (no outside samples, a resampled core at
    frac 0.25) at small widths, forward and backward on the card: K1-K3 run,
    K4/K5 never; colour within 5e-3 of the plain versions on the CPU."""
    from vdnerf_tpu_torch.data.dataset import near_far_from_sphere
    from vdnerf_tpu_torch.models.fields import NeRFConfig, RenderConfig, SDFConfig
    from vdnerf_tpu_torch.ops.renderer import NeuSModel, NeuSNetworks, RendererConfig, render

    nets = NeuSNetworks(
        sdf=SDFConfig(d_out=65, d_hidden=64, n_layers=4, skip_in=(2,)),
        color=RenderConfig(d_feature=64, d_hidden=64, n_layers=2, multires_view=4),
        nerf=NeRFConfig(D=4, W=64, skips=(2,), multires=6, multires_view=2),
        renderer=RendererConfig(n_samples=16, n_importance=16, n_outside=0, perturb=0.0,
                                n_render_samples=16, resample_uniform_frac=0.25))
    rng = np.random.default_rng(31)
    o = rng.normal(size=(256, 3))
    o = 3.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-0.6, 0.6, size=(256, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    colors, launches = {}, {}
    for dev in (card, torch.device("cpu")):
        model = NeuSModel(nets, 0.3, torch.Generator().manual_seed(0)).to(dev)
        ro, rd = (torch.tensor(a, dtype=torch.float32, device=dev) for a in (o, d))
        build.reset_launches()
        out = render(nets, model, ro, rd, *near_far_from_sphere(ro, rd),
                     background_rgb=torch.ones(1, 3, device=dev))
        out["color_fine"].square().sum().backward()
        colors[dev.type], launches[dev.type] = out["color_fine"].detach().cpu(), dict(build.LAUNCHES)
    # the ladder's first query, its 3 rounds, and the 4th the weight estimate reads
    assert launches["cuda"]["sdf_fwd"] == 5
    assert launches["cuda"]["render_fwd"] == launches["cuda"]["render_bwd"] == 1
    assert launches["cuda"]["nerf_fwd"] == launches["cuda"]["nerf_bwd"] == 0
    assert not any(launches["cpu"].values())
    torch.testing.assert_close(colors["cuda"], colors["cpu"], atol=5e-3, rtol=0)


def test_interpolated_frame_through_the_kernels(card):
    """One frame of the novel-view sweep (``render_between`` at ratio 0.5
    between two learned cameras, resolution level 2: 768 rays, one chunk) at
    small widths with the womsk renderer features: on the card K1, K2 and K4
    run (K2 and K4 once) and no backward kernel; the colour within 5e-3 of
    the plain versions on the CPU."""
    from vdnerf_tpu_torch.data.cameras import LearnedCameras
    from vdnerf_tpu_torch.models.fields import NeRFConfig, RenderConfig, SDFConfig
    from vdnerf_tpu_torch.ops.renderer import NeuSModel, NeuSNetworks, RendererConfig
    from vdnerf_tpu_torch.train.config import TrainConfig
    from vdnerf_tpu_torch.train.validate import ImageRenderer, resolve_cams

    nets = NeuSNetworks(
        sdf=SDFConfig(d_out=65, d_hidden=64, n_layers=4, skip_in=(2,)),
        color=RenderConfig(d_feature=64, d_hidden=64, n_layers=2, multires_view=4),
        nerf=NeRFConfig(D=4, W=64, skips=(2,), multires=6, multires_view=2),
        renderer=RendererConfig(n_samples=16, n_importance=16, n_outside=8, perturb=0.0,
                                skip_bg_inside=True, n_render_samples=24,
                                resample_uniform_frac=1.0))
    W, H = 64, 48
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -3.0
    turned = np.array([[0.0, 0, 1, -3], [0, 1, 0, 0], [-1, 0, 0, 0], [0, 0, 0, 1]], np.float32)
    tcfg = TrainConfig(batch_size=256, use_white_bkgd=True)
    frames, launches = {}, {}
    for dev in (card, torch.device("cpu")):
        model = NeuSModel(nets, 0.3, torch.Generator().manual_seed(0)).to(dev)
        cams = LearnedCameras(np.stack([pose, turned]), 50.0, H, W).to(dev)
        poses, intrin_inv = resolve_cams(cams, None, None)
        build.reset_launches()
        frames[dev.type] = ImageRenderer(nets, tcfg, H, W).render_between(
            model, poses, intrin_inv, 0, 1, 0.5, resolution_level=2)
        launches[dev.type] = dict(build.LAUNCHES)
    assert frames["cuda"].shape == (H // 2, W // 2, 3)
    assert launches["cuda"]["sdf_fwd"] > 0
    assert launches["cuda"]["render_fwd"] == launches["cuda"]["nerf_fwd"] == 1
    assert launches["cuda"]["render_bwd"] == launches["cuda"]["nerf_bwd"] == 0
    assert launches["cuda"]["dw_contract"] == 0 and not any(launches["cpu"].values())
    np.testing.assert_allclose(frames["cuda"], frames["cpu"], atol=5e-3, rtol=0)


@pytest.mark.parametrize("n", [63, 8192, 49152 + 37])
def test_depth_head_bwd_full_width(card, n):
    """K3 at the wdepth recipe's depth head (289 -> 256 x4 -> 96: the output
    layer two 64-column chunks, a 256 x 96 dW in the contraction) at few
    rows, the ladder's 8,192 and a resampled core's 49,152 with a ragged
    tail: each output within 2^-6 relative L2 of render_net_bwd_plain, two
    launches bit-identical."""
    rng = np.random.default_rng(41)
    plan, x, ws, bs = _render_full_width(rng, n, 96, card)
    g = torch.tensor(rng.normal(size=(n, 96)), dtype=torch.float32, device=card)
    args = (plan, *x, ws, bs, g)
    flat = lambda xs: [t for x in xs for t in (x if isinstance(x, list) else [x])]  # noqa: E731
    before = build.LAUNCHES["render_bwd"]
    got, again = flat(fused_mlp._render_bwd_launch(*args)), flat(fused_mlp._render_bwd_launch(*args))
    assert build.LAUNCHES["render_bwd"] == before + 2
    want = flat(fused_mlp.render_net_bwd_plain(*args))
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in want]
    assert tuple(got[4 + 4].shape) == (256, 96)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        _rel_l2_close(a, w)


def test_depth_head_through_autograd(card):
    """The depth head at full width through torch.autograd: K2 once, then K3
    once on K2's pack, its gradients bit for bit K3's on that pack and within
    2^-6 relative L2 of the plain backward."""
    rng = np.random.default_rng(42)
    n = 4096 + 37
    plan, x, ws, bs = _render_full_width(rng, n, 96, card)
    leaves = [t.clone().requires_grad_(True) for t in ws + bs]
    g = torch.tensor(rng.normal(size=(n, 96)), dtype=torch.float32, device=card)
    before = dict(build.LAUNCHES)
    out = fused_mlp.render_net(plan, *x, leaves[:5], leaves[5:])
    grads = torch.autograd.grad(out, leaves, g)
    assert build.LAUNCHES["render_fwd"] == before["render_fwd"] + 1
    assert build.LAUNCHES["render_bwd"] == before["render_bwd"] + 1
    _bf16_close(out.detach(), fused_mlp.render_net_plain(plan, *x, ws, bs))
    _, packed = fused_mlp._render_launch(plan, *x, ws, bs)
    on_pack = fused_mlp._render_bwd_launch(plan, *x, ws, bs, g, packed=packed)
    plain = fused_mlp.render_net_bwd_plain(plan, *x, ws, bs, g)
    for got, k3, w in zip(grads, [*on_pack[4], *on_pack[5]], [*plain[4], *plain[5]]):
        assert torch.equal(got, k3)
        _rel_l2_close(got, w)


def test_wdepth_render_launches_both_heads(card):
    """A wdepth renderer at small widths (depth head d_out 8, the NeRF's dpt
    head, skip_bg_inside), forward and backward of a loss on the colour and
    the depth features: K2 and K3 launch twice (the depth head and the colour
    head), K4 and K5 once, twice the colour head's K2/K3 launches of the same
    renderer without a depth head; colour and render_feats within 5e-3 of
    the plain versions on the CPU."""
    import dataclasses

    from vdnerf_tpu_torch.data.dataset import near_far_from_sphere
    from vdnerf_tpu_torch.models.fields import NeRFConfig, RenderConfig, SDFConfig
    from vdnerf_tpu_torch.ops.renderer import NeuSModel, NeuSNetworks, RendererConfig, render

    base = NeuSNetworks(
        sdf=SDFConfig(d_out=65, d_hidden=64, n_layers=4, skip_in=(2,)),
        color=RenderConfig(d_feature=64, d_hidden=64, n_layers=2, multires_view=4),
        nerf=NeRFConfig(D=4, W=64, skips=(2,), multires=6, multires_view=2,
                        gen_depth_feats=True, dpt_dim=8),
        renderer=RendererConfig(n_samples=16, n_importance=16, n_outside=8, perturb=0.0,
                                skip_bg_inside=True))
    wdepth = dataclasses.replace(base, depth=RenderConfig(d_feature=64, d_hidden=64, n_layers=2,
                                                          multires_view=4, d_out=8))
    rng = np.random.default_rng(43)
    o = rng.normal(size=(256, 3))
    o = 3.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-0.6, 0.6, size=(256, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    outs, launches = {}, {}
    for key, nets, dev in (("base", base, card), ("card", wdepth, card),
                           ("cpu", wdepth, torch.device("cpu"))):
        model = NeuSModel(nets, 0.3, torch.Generator().manual_seed(0)).to(dev)
        ro, rd = (torch.tensor(a, dtype=torch.float32, device=dev) for a in (o, d))
        build.reset_launches()
        out = render(nets, model, ro, rd, *near_far_from_sphere(ro, rd),
                     background_rgb=torch.ones(1, 3, device=dev))
        loss = out["color_fine"].square().sum()
        if "render_feats" in out:
            loss = loss + out["render_feats"].square().sum()
        loss.backward()
        outs[key] = {k: out[k].detach().cpu() for k in ("color_fine", "render_feats") if k in out}
        launches[key] = dict(build.LAUNCHES)
    assert launches["base"]["render_fwd"] == launches["base"]["render_bwd"] == 1
    for k in ("render_fwd", "render_bwd"):
        assert launches["card"][k] == 2 * launches["base"][k] == 2, k
    assert launches["card"]["nerf_fwd"] == launches["card"]["nerf_bwd"] == 1
    assert not any(launches["cpu"].values())
    assert outs["card"]["render_feats"].shape == (256, 8)
    for k in ("color_fine", "render_feats"):
        torch.testing.assert_close(outs["card"][k], outs["cpu"][k], atol=5e-3, rtol=0)


# ---------------------------------------------------------------------------
# the captured training step (train/dispatch.py)
# ---------------------------------------------------------------------------


def _small_trainer(card, learn=False, bf16=False, **tcfg):
    """A wdepth-shaped trainer at small widths on the card (depth head d_out
    8, the NeRF's dpt head, a 16-of-32 resampled core, perturbation on),
    seeded, with a camera 3 units from the sphere -> (trainer, core nets,
    host batches). With ``learn``, two learned cameras (the second turned
    about the sphere), batches from both in turn, and the learn confs'
    camera keys with the refine gate at step 5. With ``bf16``, the SDF block
    under the bf16 policy (``train.bf16``)."""
    import dataclasses

    from vdnerf_tpu_torch.data.cameras import LearnedCameras
    from vdnerf_tpu_torch.models.fields import NeRFConfig, RenderConfig, SDFConfig
    from vdnerf_tpu_torch.ops.renderer import NeuSModel, NeuSNetworks, RendererConfig
    from vdnerf_tpu_torch.train.config import TrainConfig
    from vdnerf_tpu_torch.train.step import Trainer

    nets = NeuSNetworks(
        sdf=SDFConfig(d_out=65, d_hidden=64, n_layers=4, skip_in=(2,)),
        color=RenderConfig(d_feature=64, d_hidden=64, n_layers=2, multires_view=4),
        nerf=NeRFConfig(D=4, W=64, skips=(2,), multires=6, multires_view=2,
                        gen_depth_feats=True, dpt_dim=8),
        renderer=RendererConfig(n_samples=16, n_importance=16, n_outside=8, perturb=1.0,
                                skip_bg_inside=True, n_render_samples=16),
        depth=RenderConfig(d_feature=64, d_hidden=64, n_layers=2, multires_view=4, d_out=8))
    faithful = dataclasses.replace(
        nets, renderer=dataclasses.replace(nets.renderer, n_render_samples=0))
    learn_keys = dict(learnable=True, focal_lr=5e-4, pose_lr=5e-4, focal_lr_gamma=0.9,
                      pose_lr_gamma=0.9, step_size=4, start_refine_pose_iter=5,
                      start_refine_focal_iter=5) if learn else {}
    cfg = TrainConfig(**{**dict(batch_size=256, end_iter=100, warm_up_end=20, anneal_end=50,
                                extract_depth=True, depth_start_iter=5, depth_loss_scale=10.0),
                         **learn_keys, **tcfg})
    W, H, focal = 64, 48, 50.0
    intrin = torch.tensor([[focal, 0, W / 2, 0], [0, focal, H / 2, 0], [0, 0, 1, 0],
                           [0, 0, 0, 1]])
    pose = torch.eye(4)
    pose[2, 3] = -3.0
    turned = torch.tensor([[0.0, 0, 1, -3], [0, 1, 0, 0], [-1, 0, 0, 0], [0, 0, 0, 1]])
    if learn:
        cams = LearnedCameras(torch.stack([pose, turned]).numpy(), focal, H, W).to(card)
    else:
        cams = {"pose_all": pose[None].to(card),
                "intrin_inv_all": torch.linalg.inv(intrin)[None].to(card)}
    rng = np.random.default_rng(61)
    batches = [{
        "img_idx": np.int32(i % 2 if learn else 0),
        "pixels_x": rng.integers(0, W, size=cfg.batch_size).astype(np.int32),
        "pixels_y": rng.integers(0, H, size=cfg.batch_size).astype(np.int32),
        "color": rng.uniform(0, 1, size=(cfg.batch_size, 3)).astype(np.float32),
        "mask": np.ones((cfg.batch_size, 1), np.float32),
        "feats": rng.normal(size=(cfg.batch_size, 8)).astype(np.float32),
    } for i in range(12)]
    model = NeuSModel(nets, 0.3, torch.Generator().manual_seed(0),
                      torch.bfloat16 if bf16 else None).to(card)
    trainer = Trainer(cfg, model, cams, torch.Generator(device=card).manual_seed(0))
    return trainer, faithful, nets, batches


def test_captured_step_replays_the_eager_steps(card):
    """12 steps in windows of 4 through StepDispatch (3 eager warm-up steps,
    then replays, per program) across two program switches (distillation on
    from step 6, the resampled core from step 8), against 12 eager card
    steps of the same seeded trainer: every step's metrics and every final
    parameter and Adam moment bit for bit equal, the generator at the same
    offset; Adam's lr (Trainer.inputs[2]) holds the schedule's value at every
    replay."""
    from vdnerf_tpu_torch.train.dispatch import WARMUP_STEPS, StepDispatch

    graphed, faithful, resampled, batches = _small_trainer(card)
    eager = _small_trainer(card)[0]
    cores = [faithful if s < 8 else resampled for s in range(12)]
    dispatch = StepDispatch(graphed)
    lrs, set_step = [], dispatch._set_step

    def recorded(window, j):
        set_step(window, j)
        lrs.append((window.steps[j], float(graphed.inputs[2])))

    dispatch._set_step = recorded
    build.reset_launches()
    got = []
    for w in range(3):
        steps = range(4 * w, 4 * w + 4)
        got += dispatch.run(steps, cores[4 * w:4 * w + 4], batches[4 * w:4 * w + 4]).read()
    replay_launches = dict(build.LAUNCHES)
    build.reset_launches()
    want = [{k: float(v) for k, v in eager.step(cores[s], batches[s], s).items()}
            for s in range(12)]
    # the programs (faithful, no distill) 0-5, (faithful, distill) 6-7,
    # (resampled, distill) 8-11, each replayed after its warm-up steps
    programs = [range(0, 6), range(6, 8), range(8, 12)]
    assert [s for s, _ in lrs] == [s for p in programs for s in p[WARMUP_STEPS:]]
    assert len(dispatch.programs) == sum(len(p) > WARMUP_STEPS for p in programs) == 2
    assert all(lr == graphed.schedule(s) and lr > 0 for s, lr in lrs)
    assert graphed.optimizer.param_groups[0]["lr"].data_ptr() == graphed.inputs[2].data_ptr()
    assert build.LAUNCHES == replay_launches
    assert got == want
    assert graphed.generator.get_offset() == eager.generator.get_offset()
    for (name, p), q in zip(graphed.model.named_parameters(), eager.model.parameters()):
        assert torch.equal(p, q), name
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(graphed.optimizer.state[p][k], eager.optimizer.state[q][k]), name


def test_captured_bf16_step_replays_the_eager_steps(card):
    """``train.bf16``: the bf16 SDF block changes nothing in the capture. 8
    steps in windows of 4 (3 eager warm-up steps, then replays) across the
    distillation switch at step 6, against 8 eager card steps of the same
    seeded bf16 trainer: metrics, parameters and Adam moments bit for bit,
    the generator at the same offset, and the same launches."""
    from vdnerf_tpu_torch.train.dispatch import StepDispatch

    graphed, faithful, _, batches = _small_trainer(card, bf16=True)
    eager = _small_trainer(card, bf16=True)[0]
    assert graphed.model.sdf_network_fine.matmul_dtype == torch.bfloat16
    dispatch = StepDispatch(graphed)
    build.reset_launches()
    got = []
    for w in range(2):
        got += dispatch.run(range(4 * w, 4 * w + 4), [faithful] * 4,
                            batches[4 * w:4 * w + 4]).read()
    replay_launches = dict(build.LAUNCHES)
    build.reset_launches()
    want = [{k: float(v) for k, v in eager.step(faithful, batches[s], s).items()}
            for s in range(8)]
    assert len(dispatch.programs) == 1  # (faithful, no distill); steps 6-7 stay eager
    assert build.LAUNCHES == replay_launches
    assert got == want
    assert graphed.generator.get_offset() == eager.generator.get_offset()
    for (name, p), q in zip(graphed.model.named_parameters(), eager.model.parameters()):
        assert torch.equal(p, q), name
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(graphed.optimizer.state[p][k], eager.optimizer.state[q][k]), name


def test_bf16_sdf_block_on_the_card_matches_the_cpu(card):
    """The bf16 SDF block (sdf, spatial gradient, feature) and its parameter
    gradients through the second-order path, at full width (8x256) on 8,192
    points, on the card against the same module on the CPU: both round every
    product and activation to bf16, in another summation order, so a value
    near a rounding boundary rounds the other way on one side; held at 2^-7
    relative L2 (the value and the feature) and 2^-6 (the gradients), the
    size of bf16's own error (its relative L2 from the f32 block is printed)."""
    from vdnerf_tpu_torch.models.fields import SDFConfig, SDFNetwork

    pts = torch.tensor(np.random.default_rng(71).uniform(-1, 1, size=(8192, 3)),
                       dtype=torch.float32)
    res = {}
    for key, dev, mm in (("card", card, torch.bfloat16), ("cpu", "cpu", torch.bfloat16),
                         ("cpu_f32", "cpu", None)):
        net = SDFNetwork(SDFConfig(), torch.Generator().manual_seed(0), mm).to(dev)
        sdf, grad, feat = net.sdf_value_grad_feat(pts.to(dev))
        assert (sdf.dtype, grad.dtype) == (torch.float32, torch.float32)
        assert feat.dtype == (torch.bfloat16 if mm else torch.float32)
        loss = (sdf ** 2).sum() + ((grad.norm(dim=-1) - 1) ** 2).sum() + feat.float().sum()
        loss.backward()
        res[key] = [t.detach().float().cpu() for t in (sdf, grad, feat)] + [
            p.grad.cpu() for p in net.parameters()]

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    gaps = [rel(a, b) for a, b in zip(res["card"], res["cpu"])]
    own = [rel(a, b) for a, b in zip(res["cpu"], res["cpu_f32"])]
    print(f"\nbf16 SDF block, card vs CPU: sdf {gaps[0]:.2e}, grad {gaps[1]:.2e}, feat "
          f"{gaps[2]:.2e}, worst parameter gradient {max(gaps[3:]):.2e}; CPU bf16 vs f32: "
          f"{own[0]:.2e}, {own[1]:.2e}, {own[2]:.2e}, {max(own[3:]):.2e}")
    assert gaps[0] <= 2.0**-7 and gaps[2] <= 2.0**-7
    assert gaps[1] <= 2.0**-6 and max(gaps[3:]) <= 2.0**-6


def test_replays_draw_new_jitter(card):
    """With lr 0 (the parameters never move) and one batch for every step,
    the replays of one program still give different losses: each draws the
    next jitter and stratified numbers from the registered generator, as the
    eager steps do (their losses equal bit for bit)."""
    from vdnerf_tpu_torch.train.dispatch import StepDispatch

    graphed, faithful, _, batches = _small_trainer(card, learning_rate=0.0, extract_depth=False)
    eager = _small_trainer(card, learning_rate=0.0, extract_depth=False)[0]
    dispatch = StepDispatch(graphed)
    got = [m["loss"] for m in dispatch.run(range(6), [faithful] * 6, [batches[0]] * 6).read()]
    want = [float(eager.step(faithful, batches[0], s)["loss"]) for s in range(6)]
    assert len(dispatch.programs) == 1
    assert got == want
    assert len(set(got[3:])) == 3, got  # the replays


def test_capturable_adam_resumes_from_a_reference_checkpoint(card, tmp_path):
    """A card trainer's checkpoint holds Adam in the reference format (host
    tensors, a float lr, capturable off); loaded into a fresh card trainer,
    Adam is capturable again with its lr the trainer's input and its step
    counts on the card, and the resumed trainer's next step (a replay)
    equals the writer's next eager step bit for bit."""
    from vdnerf_tpu_torch.io.checkpoints import load_reference_checkpoint, save_training_checkpoint
    from vdnerf_tpu_torch.train.dispatch import WARMUP_STEPS, StepDispatch

    writer, faithful, _, batches = _small_trainer(card, extract_depth=False)
    for s in range(4):
        writer.step(faithful, batches[s], s)
    path = str(tmp_path / "ckpt_000004.pth")
    save_training_checkpoint(path, writer.model, 4, writer.optimizer)
    saved = torch.load(path, weights_only=True)["optimizer"]
    assert all(type(g["lr"]) is float and g["capturable"] is False for g in saved["param_groups"])
    assert all(t.device.type == "cpu" for st in saved["state"].values() for t in st.values()
               if torch.is_tensor(t))

    resumed, *_ = _small_trainer(card, extract_depth=False)
    assert load_reference_checkpoint(path, resumed.model, resumed.optimizer) == 4
    group = resumed.optimizer.param_groups[0]
    assert group["capturable"] and group["lr"].data_ptr() == resumed.inputs[2].data_ptr()
    assert all(st["step"].device.type == "cuda" for st in resumed.optimizer.state.values())
    steps = range(4, 4 + WARMUP_STEPS + 1)  # the last one a replay
    resumed.generator.set_state(writer.generator.get_state())
    StepDispatch(resumed).run(steps, [faithful] * len(steps), batches[4:4 + len(steps)])
    for s in steps:
        writer.step(faithful, batches[s], s)
    for p, q in zip(writer.model.parameters(), resumed.model.parameters()):
        assert torch.equal(p, q)


def _equal_cameras(a, b):
    """Two learned-camera trainers hold the same r, t, fx and camera Adams,
    bit for bit."""
    for (name, p), q in zip(a.cams.named_parameters(), b.cams.parameters()):
        assert torch.equal(p, q), name
    for oa, ob in zip(a.camera_optimizers(), b.camera_optimizers()):
        for p, q in zip(oa.param_groups[0]["params"], ob.param_groups[0]["params"]):
            assert (p in oa.state) == (q in ob.state)
            if p in oa.state:
                for k in ("exp_avg", "exp_avg_sq", "step"):
                    assert torch.equal(oa.state[p][k], ob.state[q][k]), k


def test_captured_learned_camera_step_replays_the_eager_steps(card):
    """12 learned-camera steps in windows of 4 across the refine gate (step
    5) and the distillation switch (step 6), against 12 eager card steps of
    the same seeded trainer: the metrics, the networks, r, t, fx and both
    camera Adams' moments and step counts bit for bit equal; the camera
    Adams never step before the gate and read their lrs from
    Trainer.inputs in the replays."""
    from vdnerf_tpu_torch.train.dispatch import StepDispatch

    graphed, faithful, _, batches = _small_trainer(card, learn=True)
    eager = _small_trainer(card, learn=True)[0]
    init = {k: v.clone() for k, v in graphed.cams.state_dict().items()}
    dispatch = StepDispatch(graphed)
    got = []
    for w in range(3):
        steps = range(4 * w, 4 * w + 4)
        got += dispatch.run(steps, [faithful] * 4, batches[4 * w:4 * w + 4]).read()
        if w == 0:
            # steps 0-3: before the gate, the cameras and their Adams untouched
            assert all(torch.equal(v, init[k]) for k, v in graphed.cams.state_dict().items())
            assert graphed.pose_optimizer.state == {} == graphed.focal_optimizer.state
    want = [{k: float(v) for k, v in eager.step(faithful, batches[s], s).items()}
            for s in range(12)]
    # programs: (no distill, no refine) 0-5, (distill, refine) 6-11
    assert {k[1:] for k in dispatch.programs} == {(False, False), (True, True)}
    assert got == want
    for (name, p), q in zip(graphed.model.named_parameters(), eager.model.parameters()):
        assert torch.equal(p, q), name
    _equal_cameras(graphed, eager)
    assert not torch.equal(graphed.cams.r, init["r"]) and not torch.equal(graphed.cams.fx,
                                                                         init["fx"])
    for opt, field in zip(graphed.camera_optimizers(), (3, 4)):
        group = opt.param_groups[0]
        assert group["capturable"] and group["lr"].data_ptr() == graphed.inputs[field].data_ptr()
        assert float(opt.state[group["params"][0]]["step"]) == 6


def test_learned_cameras_resume_from_a_card_checkpoint(card, tmp_path):
    """A card trainer's checkpoint and pnf checkpoint, loaded into a fresh
    card trainer: the camera Adams are capturable again with their lrs the
    trainer's inputs, and the resumed trainer's next steps (the last a
    replay) equal the writer's next eager steps bit for bit."""
    from vdnerf_tpu_torch.io.checkpoints import (
        load_pnf_checkpoint,
        load_reference_checkpoint,
        save_pnf_checkpoint,
        save_training_checkpoint,
    )
    from vdnerf_tpu_torch.train.dispatch import WARMUP_STEPS, StepDispatch

    writer, faithful, _, batches = _small_trainer(card, learn=True, extract_depth=False,
                                                  start_refine_pose_iter=1)
    for s in range(4):
        writer.step(faithful, batches[s], s)
    save_training_checkpoint(str(tmp_path / "ckpt.pth"), writer.model, 4, writer.optimizer)
    save_pnf_checkpoint(str(tmp_path / "pnf.pth"), writer.cams, 4,
                        *writer.camera_optimizers())
    resumed, *_ = _small_trainer(card, learn=True, extract_depth=False, start_refine_pose_iter=1)
    load_reference_checkpoint(str(tmp_path / "ckpt.pth"), resumed.model, resumed.optimizer)
    assert load_pnf_checkpoint(str(tmp_path / "pnf.pth"), resumed.cams,
                               *resumed.camera_optimizers()) == 4
    for opt, field in zip(resumed.camera_optimizers(), (3, 4)):
        group = opt.param_groups[0]
        assert group["capturable"] and group["lr"].data_ptr() == resumed.inputs[field].data_ptr()
        assert all(st["step"].device.type == "cuda" for st in opt.state.values())
    _equal_cameras(writer, resumed)
    steps = range(4, 4 + WARMUP_STEPS + 1)
    resumed.generator.set_state(writer.generator.get_state())
    StepDispatch(resumed).run(steps, [faithful] * len(steps), batches[4:4 + len(steps)])
    for s in steps:
        writer.step(faithful, batches[s], s)
    for p, q in zip(writer.model.parameters(), resumed.model.parameters()):
        assert torch.equal(p, q)
    _equal_cameras(writer, resumed)


# --- the wavelet monodepth side-car (cuDNN convolutions; f32, TF32 off) -------


def _wavelet_batch(rng, n, size):
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    return {"image": t(rng.uniform(size=(n, 3, size, size))),
            "depth": t(rng.uniform(0, 200, size=(n, 1, size // 2, size // 2))),
            "mask": t(rng.uniform(size=(n, 1, size // 2, size // 2)) > 0.2)}


def test_wavelet_side_car_on_the_card_matches_the_cpu(card):
    """DenseNet-161 with the wavelet decoder, the same module and weights on
    the card and on the CPU: the five eval taps at 128^2 within 1e-4
    relative L2 each; one training-mode step at a batch of 2, the loss within
    1e-3 and the encoder's gradient (all tensors as one vector) within 1e-3,
    or, where the CPU's f32 gradient is farther than that from its f64
    evaluation (DenseNet-121 at 128^2: 3.2e-3 on the CPU alone), within 1.5x
    the CPU's distance of f64."""
    import copy

    from vdnerf_tpu_torch.utils.device import configure_numerics
    from vdnerf_tpu_torch.wavelet.model import WaveletOpts, create_model
    from vdnerf_tpu_torch.wavelet.train_lib import finetune_loss

    configure_numerics()
    model = create_model(WaveletOpts(), card)
    cpu = copy.deepcopy(model).to("cpu")
    rng = np.random.default_rng(0)
    x = _wavelet_batch(rng, 1, 128)["image"]
    with torch.no_grad():
        for got, want in zip(model.encode(x.to(card)), cpu.encode(x)):
            _rel_l2_close(got.cpu(), want, 1e-4)
    batch = _wavelet_batch(rng, 2, 128)
    res = []
    for m in (model, cpu, copy.deepcopy(cpu).double()):
        m.train()
        p0 = next(m.parameters())
        loss, _ = finetune_loss(m, {k: v.to(p0.device, p0.dtype) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, list(m.encoder.parameters()))
        res.append((loss.detach().cpu().double(),
                    torch.cat([g.cpu().double().flatten() for g in grads])))
    _rel_l2_close(res[0][0], res[1][0], 1e-3)
    rel = lambda a, b: float((res[a][1] - res[b][1]).norm() / res[b][1].norm())  # noqa: E731
    # the gradient is ill-conditioned in f32: where the CPU's own is farther
    # than 1e-3 from f64, the card's must be within 1.5x that of f64
    assert rel(0, 1) <= 1e-3 or rel(0, 2) <= 1.5 * rel(1, 2), (rel(0, 1), rel(0, 2), rel(1, 2))


def _predict_scene(tmp_path):
    import cv2 as cv

    from vdnerf_tpu_torch.wavelet.io import save_model
    from vdnerf_tpu_torch.wavelet.model import WaveletOpts, create_model

    model = create_model(WaveletOpts(encoder_type="mobilenet_light"), "cpu")
    folder = os.path.dirname(save_model(model, str(tmp_path / "log"), 0))
    img_dir = tmp_path / "image"
    img_dir.mkdir()
    rng = np.random.default_rng(1)
    for i in range(2):
        cv.imwrite(str(img_dir / f"{i:03d}.png"),
                   rng.integers(0, 256, size=(40, 56, 3), dtype=np.uint8))
    return model, ["-ckpt", folder, "-d", str(img_dir), "--encoder_type", "mobilenet_light"]


def test_predict_refuses_to_run_without_a_card(monkeypatch, tmp_path):
    from vdnerf_tpu_torch.wavelet.predict import main as predict

    _, argv = _predict_scene(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict(argv)


def test_predict_runs_on_the_card(card, tmp_path):
    """With no device given, predict runs on cuda:0 (the model's weights
    there) and writes what the CPU computes, within 1e-4."""
    import cv2 as cv

    from vdnerf_tpu_torch.wavelet import predict as predict_cli

    model, argv = _predict_scene(tmp_path)
    devices = []
    create = predict_cli.create_model

    def spy(opts, device):
        m = create(opts, device)
        devices.append(next(m.parameters()).device)
        return m

    predict_cli.create_model = spy
    try:
        paths = predict_cli.main(argv)
    finally:
        predict_cli.create_model = create
    assert devices == [torch.device("cuda:0")] and len(paths) == 2
    for p in paths:
        pic = cv.imread(str(tmp_path / "image" / (os.path.basename(p)[:-4] + ".png")))
        x = torch.from_numpy((pic.astype(np.float32) / 255.0).transpose(2, 0, 1).copy())[None]
        with torch.no_grad():
            want = model.encode(x)[0]
        _rel_l2_close(torch.from_numpy(np.load(p)), want, 1e-4)
