"""The port's K3/K5 plain backward versions against ``jax.vjp`` of the JAX
package's ``render_net_fused`` / ``nerf_fused`` (Pallas in interpret mode).

Same numpy-seeded inputs, weights and cotangents on both sides, N = 37 (not a
multiple of the Pallas tile of 32, so its zero-padded rows run). Tolerances,
per tensor, relative to the largest entry of the JAX result:

- both sides' matmul operands in f32 (``f32_matmuls``): 1e-5, f32 summation
  order;
- the production bf16 operand rounding: 2^-7, two bf16 ulps at the tensor's
  scale. The two frameworks sum each product in another order, so an f32
  activation or delta that lies near a bf16 rounding boundary can round to the
  neighbouring bf16 value on one side; one such flip moves the products it
  feeds by one bf16 ulp.

Also: ``torch.autograd.grad`` through the port's autograd Functions on CPU
tensors gives exactly the plain backward's cotangents.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kernels import RENDER_MODES, _nerf_case, _np_weights, _t
from torch_parity import one_torch_thread, f32_matmuls  # noqa: F401
from vdnerf_tpu.ops.pallas import fused_mlp as jfused
from vdnerf_tpu_torch.ops.kernels import fused_mlp

N = 37
TOL = {"f32": 1e-5, "bf16": 2.0**-7}


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"max abs err {err:.3e} > {rel:.1e} x {scale:.3e}"


def _render_case(mode, squeeze_out):
    multires_view, d_small = RENDER_MODES[mode]
    rng = np.random.default_rng(5)
    d_feat, width = 32, 48
    ws, bs = _np_weights(rng, [(d_small + d_feat, width), (width, width), (width, 3)])
    pts, nrm, dirs = (rng.normal(size=(N, 3)).astype(np.float32) for _ in range(3))
    feat = rng.normal(size=(N, d_feat)).astype(np.float32)
    g = rng.normal(size=(N, 3)).astype(np.float32)
    plan = (mode, multires_view, squeeze_out)
    jplan = (mode, jfused._freqs(multires_view), squeeze_out, len(ws))
    return plan, jplan, [pts, nrm, dirs, feat], ws, bs, g


def _render_grads(mode, squeeze_out, mm):
    plan, jplan, inputs, ws, bs, g = _render_case(mode, squeeze_out)

    def f(pts, nrm, dirs, feat, ws, bs):
        return jfused.render_net_fused(jplan, 32, pts, nrm, dirs, feat, ws, bs)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in inputs),
                     [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs])
    want = vjp(jnp.asarray(g))
    got = fused_mlp.render_net_bwd_plain(plan, *_t(inputs), _t(ws), _t(bs), torch.tensor(g),
                                         mm=mm)
    return got, want


def _check_render(got, want, rel):
    for gt, wt in zip(got[:4], want[:4]):
        _close(gt, wt, rel)
    for gl, wl in zip(got[4:], want[4:]):
        assert len(gl) == len(wl)
        for gt, wt in zip(gl, wl):
            _close(gt, wt, rel)


@pytest.mark.parametrize("squeeze_out", [True, False])
@pytest.mark.parametrize("mode", list(RENDER_MODES))
def test_render_bwd_plain_matches_pallas_vjp_f32(f32_matmuls, mode, squeeze_out):
    _check_render(*_render_grads(mode, squeeze_out, f32_matmuls), TOL["f32"])


@pytest.mark.parametrize("squeeze_out", [True, False])
@pytest.mark.parametrize("mode", list(RENDER_MODES))
def test_render_bwd_plain_matches_pallas_vjp_bf16(mode, squeeze_out):
    _check_render(*_render_grads(mode, squeeze_out, torch.bfloat16), TOL["bf16"])


def _nerf_grads(has_dpt, mm):
    plan, jplan, inputs, weights = _nerf_case(has_dpt, n=N)
    rng = np.random.default_rng(6)
    gs = [rng.normal(size=(N, 1)), rng.normal(size=(N, 3))]
    if has_dpt:
        gs.append(rng.normal(size=(N, weights[2][4].shape[1])))
    gs = [g.astype(np.float32) for g in gs]

    def f(pts, views, tw, tb, hw, hb):
        return jfused.nerf_fused(jplan, 32, pts, views, tw, tb, hw, hb)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in inputs),
                     *[[jnp.asarray(x) for x in group] for group in weights])
    want = vjp((jnp.asarray(gs[0]), jnp.asarray(gs[1]),
                jnp.asarray(gs[2]) if has_dpt else None))
    got = fused_mlp.nerf_bwd_plain(plan, *_t(inputs), *[_t(group) for group in weights],
                                   *_t(gs), mm=mm)
    return got, want


def _check_nerf(got, want, rel):
    for gt, wt in zip(got[:2], want[:2]):
        _close(gt, wt, rel)
    for gl, wl in zip(got[2:], want[2:]):
        assert len(gl) == len(wl)
        for gt, wt in zip(gl, wl):
            _close(gt, wt, rel)


@pytest.mark.parametrize("has_dpt", [False, True])
def test_nerf_bwd_plain_matches_pallas_vjp_f32(f32_matmuls, has_dpt):
    _check_nerf(*_nerf_grads(has_dpt, f32_matmuls), TOL["f32"])


@pytest.mark.parametrize("has_dpt", [False, True])
def test_nerf_bwd_plain_matches_pallas_vjp_bf16(has_dpt):
    _check_nerf(*_nerf_grads(has_dpt, torch.bfloat16), TOL["bf16"])


def _leaves(xs):
    return [x.detach().clone().requires_grad_(True) for x in xs]


@pytest.mark.parametrize("mode", list(RENDER_MODES))
def test_render_function_backward_is_the_plain_backward(mode):
    plan, _, inputs, ws, bs, g = _render_case(mode, True)
    inputs, ws, bs = _leaves(_t(inputs)), _leaves(_t(ws)), _leaves(_t(bs))
    out = fused_mlp.render_net(plan, *inputs, ws, bs, torch.bfloat16)
    got = torch.autograd.grad(out, inputs + ws + bs, torch.tensor(g), allow_unused=True)
    with torch.no_grad():
        d4, d5, d6, d7, dws, dbs = fused_mlp.render_net_bwd_plain(
            plan, *inputs, ws, bs, torch.tensor(g), mm=torch.bfloat16)
    for a, b in zip(got, [d4, d5, d6, d7, *dws, *dbs]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("has_dpt", [False, True])
def test_nerf_function_backward_is_the_plain_backward(has_dpt):
    plan, _, inputs, weights = _nerf_case(has_dpt, n=N)
    inputs = _leaves(_t(inputs))
    weights = [_leaves(_t(group)) for group in weights]
    alpha, rgb, dpt = fused_mlp.nerf(plan, *inputs, *weights, torch.bfloat16)
    rng = np.random.default_rng(7)
    gs = [torch.tensor(rng.normal(size=t.shape).astype(np.float32)) for t in (alpha, rgb)]
    outs = [alpha, rgb]
    if has_dpt:
        gs.append(torch.tensor(rng.normal(size=dpt.shape).astype(np.float32)))
        outs.append(dpt)
    flat = inputs + [x for group in weights for x in group]
    got = torch.autograd.grad(outs, flat, gs)
    with torch.no_grad():
        d_pts, d_views, dtw, dtb, dhw, dhb = fused_mlp.nerf_bwd_plain(
            plan, *inputs, *weights, *gs, mm=torch.bfloat16)
    for a, b in zip(got, [d_pts, d_views, *dtw, *dtb, *dhw, *dhb]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
