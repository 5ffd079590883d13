"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain versions; these are held
against ``sdf_value_pallas`` / ``render_net_fused`` / ``nerf_fused`` in
Pallas interpret mode, on the same numpy-seeded inputs and weights, with odd
row counts so the padding paths run. Tolerances: K1 (f32) atol 1e-5; K2/K4
with both sides' matmul operands in f32 atol 1e-5; in the production bf16
policy atol 3e-3 (a bf16 rounding of an activation can land on the other
side in the two frameworks).

The CUDA kernels themselves are held against the plain versions on the card
in ``test_torch_cuda.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import f32_matmuls  # noqa: F401
from vdnerf_tpu.models.fields import SDFConfig, sdf_init
from vdnerf_tpu.ops.pallas import fused_mlp as jfused
from vdnerf_tpu.ops.pallas.sdf_fwd import sdf_value_pallas
from vdnerf_tpu_torch.ops.kernels import fused_mlp, sdf_fwd


def _np_weights(rng, dims, scale_out=False):
    ws, bs = [], []
    for k, n in dims:
        std = np.sqrt(2.0 / n) if scale_out else 1.0 / np.sqrt(k)
        ws.append((rng.normal(size=(k, n)) * std).astype(np.float32))
        bs.append((rng.normal(size=n) * 0.05).astype(np.float32))
    return ws, bs


def _t(arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

SDF_CFGS = [
    SDFConfig(d_hidden=64, n_layers=4, d_out=65, skip_in=(2,)),
    SDFConfig(d_hidden=32, n_layers=2, d_out=33, skip_in=()),
    SDFConfig(d_hidden=64, n_layers=4, d_out=65, skip_in=(2,), scale=2.0),
]


def _sdf_case(cfg, n):
    import jax

    params = sdf_init(jax.random.PRNGKey(0), cfg)
    ws, bs = jfused_effective(params)
    ws[-1], bs[-1] = ws[-1][:, :1], bs[-1][:1]
    pts = np.random.default_rng(1).uniform(-1, 1, size=(n, 3)).astype(np.float32)
    return params, ws, bs, pts


def jfused_effective(params):
    from vdnerf_tpu.models.layers import effective_weight

    return ([np.asarray(effective_weight(p)) for p in params["layers"]],
            [np.asarray(p["b"]) for p in params["layers"]])


@pytest.mark.parametrize("cfg", SDF_CFGS)
def test_sdf_plain_matches_pallas(cfg):
    params, ws, bs, pts = _sdf_case(cfg, 301)
    want = np.asarray(sdf_value_pallas(cfg, params, jnp.asarray(pts), tile=128, interpret=True))
    got = sdf_fwd.sdf_value(torch.from_numpy(pts), _t(ws), _t(bs), cfg.skip_in,
                            cfg.multires, cfg.scale).numpy()
    assert got.shape == (301, 1)
    np.testing.assert_allclose(got, want, atol=1e-5)


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

RENDER_MODES = {
    "idr": (4, 3 + 27 + 3),
    "no_view_dir": (0, 3 + 3),
    "no_normal": (4, 3 + 27),
}


def _render_case(mode, n=77, d_feat=32, width=48, squeeze_out=True):
    multires_view, d_small = RENDER_MODES[mode]
    rng = np.random.default_rng(2)
    ws, bs = _np_weights(rng, [(d_small + d_feat, width), (width, width), (width, 3)])
    pts, nrm, dirs = (rng.normal(size=(n, 3)).astype(np.float32) for _ in range(3))
    feat = rng.normal(size=(n, d_feat)).astype(np.float32)
    jplan = (mode, jfused._freqs(multires_view), squeeze_out, len(ws))
    return (mode, multires_view, squeeze_out), jplan, (pts, nrm, dirs, feat), ws, bs


def _render_pair(mode, **kw):
    plan, jplan, inputs, ws, bs = _render_case(mode, **kw)
    want = np.asarray(jfused.render_net_fused(
        jplan, 32, *(jnp.asarray(a) for a in inputs),
        [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs]))
    got = fused_mlp.render_net(plan, *_t(inputs), _t(ws), _t(bs)).numpy()
    return got, want


@pytest.mark.parametrize("mode", list(RENDER_MODES))
def test_render_plain_matches_pallas_f32(f32_matmuls, mode):
    got, want = _render_pair(mode)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("mode", list(RENDER_MODES))
def test_render_plain_matches_pallas_bf16(mode):
    got, want = _render_pair(mode, squeeze_out=mode != "no_normal")
    np.testing.assert_allclose(got, want, atol=3e-3)


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------


def _nerf_case(has_dpt, n=83, D=4, W=32, skips=(2,), multires=4, multires_view=2):
    rng = np.random.default_rng(3)
    e_pts, e_view = 4 * (1 + 2 * multires), 3 * (1 + 2 * multires_view)
    t_dims = [(e_pts, W)] + [(W + e_pts if i - 1 in skips else W, W) for i in range(1, D)]
    tw, tb = _np_weights(rng, t_dims)
    h_dims = [(W, 1), (W, W), (W + e_view, W // 2), (W // 2, 3)] + ([(W // 2, 7)] if has_dpt else [])
    hw, hb = _np_weights(rng, h_dims)
    p = rng.normal(size=(n, 3))
    pts = np.concatenate([p / np.linalg.norm(p, axis=-1, keepdims=True),
                          rng.uniform(0, 1, size=(n, 1))], -1).astype(np.float32)
    views = rng.normal(size=(n, 3)).astype(np.float32)
    plan = (multires, multires_view, skips, D, has_dpt)
    jplan = (jfused._freqs(multires), jfused._freqs(multires_view), skips, D, has_dpt)
    return plan, jplan, (pts, views), (tw, tb, hw, hb)


def _nerf_pair(has_dpt):
    plan, jplan, inputs, weights = _nerf_case(has_dpt)
    want = jfused.nerf_fused(jplan, 32, *(jnp.asarray(a) for a in inputs),
                             *[[jnp.asarray(x) for x in group] for group in weights])
    got = fused_mlp.nerf(plan, *_t(inputs), *[_t(group) for group in weights])
    assert (got[2] is None) == (not has_dpt)
    return [g.numpy() for g in got if g is not None], [np.asarray(w) for w in want if w is not None]


@pytest.mark.parametrize("has_dpt", [False, True])
def test_nerf_plain_matches_pallas_f32(f32_matmuls, has_dpt):
    for g, w in zip(*_nerf_pair(has_dpt)):
        np.testing.assert_allclose(g, w, atol=1e-5)


@pytest.mark.parametrize("has_dpt", [False, True])
def test_nerf_plain_matches_pallas_bf16(has_dpt):
    for g, w in zip(*_nerf_pair(has_dpt)):
        np.testing.assert_allclose(g, w, atol=3e-3)


def test_wrappers_refuse_other_devices():
    pts = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError):
        sdf_fwd.sdf_value(pts, [], [], (), 0, 1.0)
    with pytest.raises(ValueError):
        fused_mlp.render_net(("idr", 4, True), pts, pts, pts, pts, [], [])
