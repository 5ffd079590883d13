"""``train.bf16``: the port's bf16 SDF block against the JAX package's.

Under the bf16 policy (``vdnerf_tpu_torch/models/precision.py``; JAX
``enable_bf16(True)``) each linear of the SDF network takes bf16 operands,
accumulates in f32, adds the f32 bias and returns bf16, softplus runs on bf16
activations, the sdf channel comes back in f32 and the feature in bf16.
What is held here, on the CPU, at the small widths of ``torch_parity.py``:

- one bf16 linear against JAX ``linear`` (within one bf16 ulp of the output;
  the input's and the weight's gradients come back bf16-rounded as the
  transpose of JAX's casts gives them), and softplus(100) on bf16 against
  ``jax.nn.softplus`` on bf16 (equal);
- the SDF block (sdf, spatial gradient, feature) against JAX's under the
  policy, compiled without XLA's excess precision (below): measured relative
  L2 sdf 0, gradient 3.5e-5, feature 0 (JAX's own bf16-to-f32 distance
  4.0e-3, 5.3e-3, 4.0e-3); held at 2^-8, 2^-7 and 2^-8, as products that sum
  in another order can round the other way;
- the training step under ``train.bf16`` (mask-free, the faithful
  ``skip_bg_inside`` renderer of ``test_torch_train.py``): per tensor, the
  port's distance from JAX's bf16 step against JAX's bf16 step's own
  distance from its f32 step (relative L2 against JAX's bf16 gradient). Both
  JAX steps take the fused Pallas path, which rounds the colour head's and
  the background NeRF's operands to bf16 as K2-K5 do, so the bf16 SDF block
  is all that tells them apart; JAX's ladder is traced in f32 here, as the
  port's runs K1 in f32. 40 of the 41 tensors are within 1.5x of JAX's own
  distance, and the last SDF layer's gains (``lin4.weight_g``, in effect
  one scalar: the sdf column's) at 1.74x; held at STEP_GAP_FACTOR = 2x plus
  1e-4. The loss: 2.3e-5 against JAX's own 1.2e-3;
- the ladder's K1 in f32 alone (JAX's bf16 step with an f32 ladder against
  JAX's as shipped): per tensor within 0.97x of JAX's own bf16-to-f32
  distance, held at 1.5x plus 1e-4;
- a 20-step loss trajectory (``test_torch_bf16_trajectory.py``);
- with ``train.bf16 = false`` the step is the f32 step bit for bit: the SDF
  block, the gradients and a trained step equal those of the plain f32
  chain written out here;
- downstream stays f32: the render's outputs are f32 and the colour head's
  backward (K3's plain version) returns the feature's cotangent in bf16;
- the runner switches the policy for training only (``train.bf16``), and
  ``VDNERF_BF16`` sets it for every mode, as the JAX package does.

Every JAX call here that sets ``enable_bf16(True)`` restores
``enable_bf16(False)`` in a ``finally``: later test files run in the same
worker.
"""

from __future__ import annotations

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import NETS, H, W, _batches, _cfgs, _jax_tree_as_port, _port_grads, scene  # noqa: F401
from torch_parity import SDF, jax_params, one_torch_thread, port_model, port_nets, rel_l2  # noqa: F401
from vdnerf_tpu.models import fields as jf
from vdnerf_tpu.models import layers as jl
from vdnerf_tpu.models import precision
from vdnerf_tpu.train import SceneStatic
from vdnerf_tpu.train.step import make_loss_fn
from vdnerf_tpu_torch.models import layers as tl
from vdnerf_tpu_torch.models.embedder import embed
from vdnerf_tpu_torch.train.step import Trainer

BF16 = torch.bfloat16
BLOCK_TOL = {"sdf": 2.0**-8, "grad": 2.0**-7, "feat": 2.0**-8}
OWN_GAP_FACTOR, OWN_GAP_ABS = 1.5, 1e-4
STEP_GAP_FACTOR = 2.0
# XLA's CPU compiler keeps f32 intermediates across a fused chain of bf16 ops
# unless told not to; the port rounds at every op, as the JAX program says
# (with the default the block's gradient moves by 3.6e-3 relative L2)
EXACT = {"xla_allow_excess_precision": False}


def _jit(fn):
    return jax.jit(fn, compiler_options=EXACT)


def _jax_policy(bf16: bool, fused: bool, fn, *args):
    """fn(*args) under the JAX package's matmul and fused-MLP switches,
    both restored after it."""
    precision.enable_bf16(bf16)
    precision.set_fused_mlp(fused)
    try:
        return fn(*args)
    finally:
        precision.enable_bf16(False)
        precision.set_fused_mlp(False)


def _bf16_model(params):
    model = port_model(NETS, params, BF16)
    model.sdf_network_fine.matmul_dtype = BF16
    return model


def test_bf16_linear_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(257, 70)).astype(np.float32)
    w = rng.normal(size=(70, 48)).astype(np.float32) / 8
    b = rng.normal(size=48).astype(np.float32)
    layer = tl.PlainLinear(70, 48)
    with torch.no_grad():
        layer.weight.copy_(torch.tensor(w.T))
        layer.bias.copy_(torch.tensor(b))
    xt = torch.tensor(x).to(BF16).requires_grad_(True)
    got = tl.linear(layer, xt, BF16)
    assert got.dtype == BF16
    want, vjp = _jax_policy(True, False, lambda: jax.vjp(
        lambda p, xx: jl.linear(p, xx), {"w": jnp.asarray(w), "b": jnp.asarray(b)},
        jnp.asarray(x).astype(jnp.bfloat16)))
    want = np.asarray(want.astype(jnp.float32))
    ulp = 2.0**-7 * np.maximum(np.abs(want), 1e-30)
    assert (np.abs(got.detach().float().numpy() - want) <= ulp).all()
    # a bf16-valued cotangent: the gradients as JAX's transpose gives them
    g = torch.tensor(rng.normal(size=(257, 48)).astype(np.float32)).to(BF16)
    got.backward(g)
    dp, dx = _jit(vjp)(jnp.asarray(g.float().numpy()).astype(jnp.bfloat16))
    assert xt.grad.dtype == BF16 and dx.dtype == jnp.bfloat16
    for mine, theirs in ((xt.grad, dx), (layer.weight.grad.t(), dp["w"]), (layer.bias.grad,
                                                                          dp["b"])):
        theirs = np.asarray(jnp.asarray(theirs, jnp.float32))
        assert rel_l2(mine.float().numpy(), theirs) <= 2.0**-8
    # the weight's gradient is bf16-rounded before it reaches the f32 weight
    assert torch.equal(layer.weight.grad, layer.weight.grad.to(BF16).float())


def test_bf16_softplus_matches_jax():
    x = np.random.default_rng(1).normal(scale=0.05, size=50000).astype(np.float32)
    xb = torch.tensor(x).to(BF16)
    got = tl.softplus_beta(xb, 100.0)
    want = _jit(jl.softplus_beta)(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def _block_inputs(n=2048, seed=0):
    pts = np.random.default_rng(seed).uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)
    return pts, jax_params(NETS)


def test_sdf_block_matches_jax_under_bf16():
    pts, params = _block_inputs()
    def fn(p, x):  # traced anew under each policy: JAX reads it at trace time
        return _jit(lambda pp, xx: jf.sdf_value_grad_feat(SDF, pp, xx))(p, x)

    sdf_w, grad_w, feat_w = _jax_policy(True, False, fn, params["sdf"], jnp.asarray(pts))
    assert feat_w.dtype == jnp.bfloat16 and sdf_w.dtype == jnp.float32
    net = _bf16_model(params).sdf_network_fine
    x = torch.tensor(pts).requires_grad_(True)
    with torch.no_grad():
        sdf, grad, feat = net.sdf_value_grad_feat(x)
    assert (sdf.dtype, grad.dtype, feat.dtype) == (torch.float32, torch.float32, BF16)
    gaps = {"sdf": rel_l2(sdf.numpy(), np.asarray(sdf_w)),
            "grad": rel_l2(grad.numpy(), np.asarray(grad_w)),
            "feat": rel_l2(feat.float().numpy(), np.asarray(feat_w.astype(jnp.float32)))}
    # against the f32 block, the size of bf16's own error
    f32 = [np.asarray(a, np.float32) for a in fn(params["sdf"], jnp.asarray(pts))]
    own = {k: rel_l2(np.asarray(w, np.float32), f) for (k, w), f in
           zip((("sdf", sdf_w), ("grad", grad_w), ("feat", feat_w.astype(jnp.float32))), f32)}
    print(f"\nbf16 SDF block, port vs JAX relative L2: {gaps}; JAX bf16 vs f32: {own}")
    for k, tol in BLOCK_TOL.items():
        assert gaps[k] <= tol, (k, gaps[k])


def _f32_ladder(monkeypatch):
    """JAX's up-sample ladder traced under the f32 policy, as the port's
    ladder runs K1 in f32 (the policy is read at trace time)."""
    from vdnerf_tpu.ops import renderer as jr

    value = jr.sdf_value

    def sdf_value_f32(cfg, params, pts):
        dt = precision.get_matmul_dtype()
        precision.set_matmul_dtype(None)
        try:
            return value(cfg, params, pts)
        finally:
            precision.set_matmul_dtype(dt)

    monkeypatch.setattr(jr, "sdf_value", sdf_value_f32)


@pytest.fixture(scope="module")
def jax_steps(scene):
    """JAX's step 30 on one batch, (loss, gradients by port name): f32,
    bf16 as shipped, and bf16 with the ladder in f32."""
    jcfg, _ = _cfgs(scene)
    params = jax_params(NETS)
    (jb,), _ = _batches(scene, 1)
    out = {name: _jax_step(jcfg, scene["jcams"], params, jb, 30, bf16=name != "f32")
           for name in ("f32", "bf16")}
    with pytest.MonkeyPatch.context() as mp:
        _f32_ladder(mp)
        out["bf16_f32_ladder"] = _jax_step(jcfg, scene["jcams"], params, jb, 30, bf16=True)
    return out


def _jax_step(jcfg, jcams, params, batch, step, bf16: bool):
    """(loss, gradients by port name) of JAX's fused step, bf16 or f32 SDF block."""
    fn = _jit(jax.value_and_grad(make_loss_fn(NETS, jcfg, SceneStatic(H=H, W=W)),
                                 has_aux=True))
    (loss, _), (g, _) = _jax_policy(bf16, True, fn, (params, jcams), batch, step,
                                    jax.random.PRNGKey(0))
    return float(loss), _jax_tree_as_port(g)


def _gap_rows(got: dict, want: dict, own_ref: dict) -> list[tuple[str, float, float]]:
    """Per tensor: (name, |got - want|, |own_ref - want|), relative L2 against want."""
    assert set(got) == set(want)
    return [(n, rel_l2(g, want[n].reshape(g.shape)),
             rel_l2(own_ref[n].reshape(g.shape), want[n].reshape(g.shape)))
            for n, g in got.items()]


def _print_rows(title, rows):
    print(f"\n{title}")
    for n, mine, own in rows:
        print(f"  {n}: {mine:.3e} / {own:.3e}")
    worst = max(rows, key=lambda r: r[1] / r[2])
    print(f"  largest ratio {worst[1] / worst[2]:.2f} at {worst[0]}")


def test_bf16_step_stays_within_jax_bf16_gap(scene, jax_steps):
    """The port's bf16 step against JAX's bf16 step given the port's f32
    ladder, per tensor against JAX's own bf16-to-f32 gap: within 2x for every
    tensor and within 1.5x for all but one."""
    _, tcfg = _cfgs(scene)
    tcfg = dataclasses.replace(tcfg, bf16=True)
    (_,), (tb,) = _batches(scene, 1)
    loss32, want32 = jax_steps["f32"]
    loss16, want16 = jax_steps["bf16_f32_ladder"]
    model = _bf16_model(jax_params(NETS))
    assert model.color_network_fine.mm_dtype == model.nerf.mm_dtype == BF16
    got = Trainer(tcfg, model, scene["tcams"], None).gradients(port_nets(NETS), tb, 30)
    rows = _gap_rows(_port_grads(model), want16, want32)
    loss_gap, own_loss_gap = abs(float(got["loss"]) - loss16), abs(loss32 - loss16)
    _print_rows(f"bf16 step, per tensor: port to JAX bf16 (f32 ladder) / JAX f32 to it "
                f"(relative L2); loss {loss_gap:.3e} / {own_loss_gap:.3e}", rows)
    assert loss_gap <= OWN_GAP_FACTOR * own_loss_gap + OWN_GAP_ABS * abs(loss16)
    for n, mine, own in rows:
        assert mine <= STEP_GAP_FACTOR * own + OWN_GAP_ABS, (n, mine, own)
    beyond = [n for n, mine, own in rows if mine > OWN_GAP_FACTOR * own + OWN_GAP_ABS]
    assert len(beyond) <= 1, beyond


def test_ladder_in_f32_step_gap(jax_steps):
    """The port's ladder runs K1 in f32 where JAX's runs in bf16 under the
    policy: that difference alone, JAX's bf16 step with an f32 ladder against
    JAX's as shipped, per tensor against JAX's own bf16-to-f32 gap: measured
    largest ratio 0.97, the loss 8.3e-6 relative; held at 1.5x + 1e-4."""
    _, want32 = jax_steps["f32"]
    loss16, want16 = jax_steps["bf16"]
    loss_l, got = jax_steps["bf16_f32_ladder"]
    rows = _gap_rows(got, want16, want32)
    _print_rows(f"JAX bf16 step, f32 ladder to bf16 ladder / JAX f32 to bf16 (relative L2); "
                f"loss {abs(loss_l - loss16) / loss16:.3e}", rows)
    assert any(mine > 0 for _, mine, _ in rows)
    for n, mine, own in rows:
        assert mine <= OWN_GAP_FACTOR * own + OWN_GAP_ABS, (n, mine, own)


def _plain_f32_forward_split(net, pts):
    """The f32 SDF chain written out: embed, linears, softplus(100), skip."""
    cfg = net.cfg
    inputs = embed(pts * cfg.scale, cfg.multires)
    x = inputs
    for l in range(net.n_linear):
        layer = getattr(net, f"lin{l}")
        if l in cfg.skip_in:
            x = torch.cat([x, inputs], dim=-1) * (1.0 / math.sqrt(2.0))
        x = torch.nn.functional.linear(x, layer.effective_weight(), layer.bias)
        if l < net.n_linear - 1:
            bx = 100.0 * x
            x = (torch.clamp(bx, min=0) + torch.log1p(torch.exp(-bx.abs()))) / 100.0
    return x[:, :1] / cfg.scale, x[:, 1:]


def test_bf16_false_is_the_f32_step_bit_for_bit(scene, monkeypatch):
    jcfg, tcfg = _cfgs(scene)
    assert tcfg.bf16 is False
    params = jax_params(NETS)
    (_,), (tb,) = _batches(scene, 1, seed=6)
    got = port_model(NETS, params, BF16)
    assert got.sdf_network_fine.matmul_dtype is None
    ref = port_model(NETS, params, BF16)
    net = ref.sdf_network_fine
    monkeypatch.setattr(net, "forward_split", lambda x: _plain_f32_forward_split(net, x))
    pts = torch.tensor(_block_inputs(512)[0])
    with torch.no_grad():
        for a, b in zip(got.sdf_network_fine.sdf_value_grad_feat(pts),
                        net.sdf_value_grad_feat(pts)):
            assert a.dtype == torch.float32 and torch.equal(a, b)
    t_got = Trainer(tcfg, got, scene["tcams"], None)
    t_ref = Trainer(tcfg, ref, scene["tcams"], None)
    m_got = t_got.step(port_nets(NETS), tb, 30)
    m_ref = t_ref.step(port_nets(NETS), tb, 30)
    assert all(torch.equal(m_got[k], m_ref[k]) for k in m_ref)
    for (n, a), b in zip(got.named_parameters(), ref.parameters()):
        assert torch.equal(a.grad, b.grad) and torch.equal(a, b), n


def test_downstream_of_the_bf16_block_is_f32(scene):
    from vdnerf_tpu_torch.data.dataset import near_far_from_sphere
    from vdnerf_tpu_torch.ops.renderer import render
    from vdnerf_tpu_torch.train.step import rays_from_batch

    model = _bf16_model(jax_params(NETS))
    (_,), (tb,) = _batches(scene, 1)
    o, d = rays_from_batch(scene["tcams"], tb, "cpu")
    out = render(port_nets(NETS), model, o, d, *near_far_from_sphere(o, d),
                 background_rgb=torch.ones(1, 3), cos_anneal_ratio=0.5)
    floats = {k: v.dtype for k, v in out.items() if v.is_floating_point()}
    assert set(floats.values()) == {torch.float32}, floats
    # the colour head's backward hands the bf16 feature a bf16 cotangent
    net = model.sdf_network_fine
    pts = torch.tensor(_block_inputs(256)[0])
    sdf, grad, feat = net.sdf_value_grad_feat(pts)
    assert feat.dtype == BF16 and feat.requires_grad
    dirs = torch.nn.functional.normalize(torch.ones_like(pts), dim=-1)
    color = model.color_network_fine(pts, grad, dirs, feat)
    assert color.dtype == torch.float32
    (d_feat,) = torch.autograd.grad(color.sum(), feat, retain_graph=True)
    assert d_feat.dtype == BF16 and d_feat.abs().max() > 0
    color.sum().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in net.parameters() if p.requires_grad)


def test_runner_policy_follows_train_bf16_and_env(tmp_path, monkeypatch):
    from vdnerf_tpu.data.synthetic import make_synthetic_scene, write_synthetic_conf
    from vdnerf_tpu_torch.runner import Runner

    make_synthetic_scene(str(tmp_path), n_images=2, H=16, W=16)
    conf = os.path.join(tmp_path, "s.conf")
    write_synthetic_conf(conf, data_dir=str(tmp_path), exp_dir=str(tmp_path / "exp"))
    with open(conf) as f:
        text = f.read()
    bf16_conf = os.path.join(tmp_path, "s_bf16.conf")
    with open(bf16_conf, "w") as f:
        f.write(text.replace("train {", "train {\n    bf16 = true", 1))

    def policy(path, mode):
        return Runner(path, device="cpu", mode=mode).model.sdf_network_fine.matmul_dtype

    monkeypatch.delenv("VDNERF_BF16", raising=False)
    assert policy(bf16_conf, "train") is BF16
    assert policy(conf, "train") is None
    assert policy(bf16_conf, "valimg") is None  # serving stays f32, as in JAX
    monkeypatch.setenv("VDNERF_BF16", "1")
    assert policy(conf, "valimg") is BF16
    assert policy(conf, "train") is BF16
