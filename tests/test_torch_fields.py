"""Port fields (vdnerf_tpu_torch.models.fields) against vdnerf_tpu's, and the
checkpoint bridge between the two packages.

Same numpy-seeded inputs and the same parameters (carried by
``from_jax_params``) through both; f32 policy on both sides. Tolerance
atol 1e-5, rtol 1e-4: f32 sums taken in another order.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import NERF, f32_matmuls, jax_nets, jax_params, port_model, to_numpy  # noqa: F401
from vdnerf_tpu.models import fields as jf
from vdnerf_tpu_torch.io import checkpoints as tck

TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def setup():
    nets = jax_nets()
    params = jax_params(nets, seed=1)
    return nets, params, port_model(nets, params)


def _pts(n=53, seed=0):
    return np.random.default_rng(seed).uniform(-1.2, 1.2, size=(n, 3)).astype(np.float32)


def test_sdf_forward_value_and_grad(setup):
    nets, params, model = setup
    pts = _pts()
    sdf_net = model.sdf_network_fine
    with torch.no_grad():
        full = sdf_net(torch.from_numpy(pts)).numpy()
        value = sdf_net.sdf_value(torch.from_numpy(pts)).numpy()
        sdf, grad, feat = sdf_net.sdf_value_grad_feat(torch.from_numpy(pts))
    np.testing.assert_allclose(full, np.asarray(jf.sdf_apply(nets.sdf, params["sdf"], pts)), **TOL)
    np.testing.assert_allclose(value, np.asarray(jf.sdf_value(nets.sdf, params["sdf"], pts)), **TOL)
    j_sdf, j_grad, j_feat = jf.sdf_value_grad_feat(nets.sdf, params["sdf"], jnp.asarray(pts))
    np.testing.assert_allclose(sdf.numpy(), np.asarray(j_sdf), **TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), **TOL)
    np.testing.assert_allclose(feat.numpy(), np.asarray(j_feat), **TOL)


def test_softplus_has_no_identity_cutoff():
    from vdnerf_tpu.models.layers import softplus_beta as j_softplus
    from vdnerf_tpu_torch.models.layers import softplus_beta

    x = np.linspace(-0.5, 0.5, 1001).astype(np.float32)
    np.testing.assert_allclose(
        softplus_beta(torch.from_numpy(x)).numpy(), np.asarray(j_softplus(x)), atol=1e-7, rtol=1e-6
    )


@pytest.mark.parametrize("mode", ["idr", "no_view_dir", "no_normal"])
def test_color_head(f32_matmuls, mode):
    from vdnerf_tpu_torch.models.fields import RenderConfig, RenderingNetwork

    kw = {"idr": dict(d_in=9, multires_view=4), "no_view_dir": dict(d_in=6, multires_view=0),
          "no_normal": dict(d_in=6, multires_view=4)}[mode]
    cfg = jf.RenderConfig(mode=mode, d_feature=32, d_hidden=48, n_layers=3, **kw)
    params = jf.render_net_init(jax.random.PRNGKey(2), cfg)
    net = RenderingNetwork(RenderConfig(**cfg.__dict__), torch.Generator().manual_seed(0))
    for l, p in enumerate(to_numpy(params)["layers"]):
        net.load_state_dict(tck.linear_state(f"lin{l}", p), strict=False)
    rng = np.random.default_rng(3)
    pts, nrm, dirs = (rng.normal(size=(41, 3)).astype(np.float32) for _ in range(3))
    feat = rng.normal(size=(41, 32)).astype(np.float32)
    with torch.no_grad():
        got = net(*(torch.from_numpy(a) for a in (pts, nrm, dirs, feat))).numpy()
    want = jf.render_net_apply(cfg, params, pts, nrm, dirs, feat)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("gen_depth_feats", [False, True])
def test_nerf(f32_matmuls, gen_depth_feats):
    from vdnerf_tpu_torch.models.fields import NeRF, NeRFConfig

    cfg = jf.NeRFConfig(**{**NERF.__dict__, "gen_depth_feats": gen_depth_feats, "dpt_dim": 5})
    params = jf.nerf_init(jax.random.PRNGKey(4), cfg)
    net = NeRF(NeRFConfig(**cfg.__dict__), torch.Generator().manual_seed(0))
    nerf_p = to_numpy(params)
    sd = {}
    for i, p in enumerate(nerf_p["pts_linears"]):
        sd.update(tck.linear_state(f"pts_linears.{i}", p))
    sd.update(tck.linear_state("views_linears.0", nerf_p["views_linears"][0]))
    for head in ("feature_linear", "alpha_linear", "rgb_linear", "dpt_linear"):
        if head in nerf_p:
            sd.update(tck.linear_state(head, nerf_p[head]))
    net.load_state_dict(sd)
    rng = np.random.default_rng(5)
    p = rng.normal(size=(45, 3))
    r = rng.uniform(1.0, 4.0, size=(45, 1))
    pts4 = np.concatenate([p / np.linalg.norm(p, axis=-1, keepdims=True), 1 / r], -1).astype(np.float32)
    views = rng.normal(size=(45, 3)).astype(np.float32)
    with torch.no_grad():
        got = net(torch.from_numpy(pts4), torch.from_numpy(views))
    want = jf.nerf_apply(cfg, params, pts4, views)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_weight_norm_round_trip_through_reference_pth(setup, tmp_path):
    """JAX params -> from_jax_params -> port model -> reference .pth ->
    vdnerf_tpu's import_torch_checkpoint: the same parameters, exactly."""
    from vdnerf_tpu.io.checkpoints import import_torch_checkpoint

    nets, params, model = setup
    path = str(tmp_path / "ckpt_000007.pth")
    tck.save_training_checkpoint(path, model, 7)
    back, step = import_torch_checkpoint(path, nets, extract_depth=False)
    assert step == 7
    want = jax.tree_util.tree_leaves_with_path(to_numpy(params))
    got = dict(jax.tree_util.tree_leaves_with_path(to_numpy(back)))
    assert len(got) == len(want)
    for path_, leaf in want:
        np.testing.assert_array_equal(got[path_], leaf)


def test_npz_and_pth_load_to_identical_parameters(setup, tmp_path):
    """The JAX package's ckpt_*.npz and a reference ckpt_*.pth of the same
    parameters load into identical port parameters."""
    from vdnerf_tpu.io.checkpoints import save_state

    nets, params, model = setup
    npz = str(tmp_path / "ckpt_000011.npz")
    save_state(npz, {"params": params, "step": jnp.asarray(11, jnp.int32),
                     "key": jax.random.PRNGKey(0)})
    pth = str(tmp_path / "ckpt_000011.pth")
    tck.save_training_checkpoint(pth, model, 11)

    a = port_model(nets, jax_params(nets, seed=9))
    b = port_model(nets, jax_params(nets, seed=9))
    assert tck.load_jax_checkpoint(npz, a) == 11
    assert tck.load_reference_checkpoint(pth, b) == 11
    sa, sb, s0 = a.state_dict(), b.state_dict(), model.state_dict()
    assert sa.keys() == sb.keys() == s0.keys()
    for k in s0:
        assert torch.equal(sa[k], s0[k]), k
        assert torch.equal(sb[k], s0[k]), k
