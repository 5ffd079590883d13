"""The port under JAX's default precision: K2-K5 in the f32 operand mode.

Under the f32 policy with ``VDNERF_FUSED`` unset, the JAX package runs the
colour head, the depth head and the background NeRF through f32 ``linear``s
(``vdnerf_tpu/models/precision.py``). The port takes its operand mode from
the same two settings (``models/precision.py`` ``mlp_operand_dtype``), with
no monkeypatch: on the CPU its plain versions then compute with unrounded
operands, on the card the split-operand mode of the kernels.

- One step against JAX's default step, on ``tests/test_torch_train.py``'s
  mask-free scene, the masked recipe on the same scene
  (``tests/test_torch_masked.py``'s nets: no outside samples, a resampled
  core, the mask BCE), ``tests/test_torch_wdepth.py``'s wdepth scene past
  the distillation ramp, and ``tests/test_torch_learned.py``'s learned
  cameras with their gradients, without and with the distillation term:
  loss and metrics within 1e-5 relative, every gradient within 1e-4 of its
  tensor's largest entry (the tolerances of those files' f32 tests).
- ``depth_before_color`` (the colour head reading the depth features): one
  wdepth step against JAX's default step at the same tolerances, and in the
  bf16 operand mode against JAX's fused path (Pallas in interpret mode):
  loss 1e-5 relative, every gradient within 2e-4 relative L2
  (``tests/test_torch_precision_gap.py``'s bf16-against-bf16 tolerances).
- ``VDNERF_FUSED=1`` gives the bf16 operand mode, and its step, with the SDF
  block on autograd's route as it then ran, is the bf16 step of the port
  before the f32 mode existed, bit for bit: the loss and every gradient hash
  to the digest that step gave on the same scene and weights
  (``PARENT_BF16_STEP``). Through the SDF block's Function (the f32 policy's
  block since) the step is the same within f32 rounding: the loss within
  1e-6 relative, every gradient within 1e-5 of its largest entry (the
  measured gaps: the loss 0, the gradients under 6e-7). The runner takes the
  mode from the policy and the variable.
- The split mode's launch schedules (``fused_mlp.split_render``,
  ``split_nerf``: which product each launch computes, on which views of which
  buffers, with which epilogue) run here with a torch stand-in for each
  launch, and give the plain versions' outputs and gradients within 1e-5 of
  each tensor's largest entry (f32 summation order), for the three colour
  head modes with sigmoid and relu outputs, and the NeRF with and without
  the dpt head, one or two skips. The kernels themselves run only on the
  card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib

import jax
import numpy as np
import pytest
import torch

from test_torch_learned import SCENE as LEARN_SCENE
from test_torch_learned import WDEPTH_NETS as LEARN_WDEPTH_NETS
from test_torch_learned import _cams, _learn_scene
from test_torch_masked import MASK
from test_torch_masked import CORES as MASK_CORES
from test_torch_train import NETS, H, W, _batches, _cfgs, _close_rel, _jax_tree_as_port, _port_grads, scene  # noqa: F401
from test_torch_wdepth import STEP_NETS as WDEPTH_NETS
from test_torch_wdepth import make_scene as make_wdepth_scene
from test_torch_wdepth import wdepth_nets
from torch_parity import jax_params, one_torch_thread, port_model, port_nets  # noqa: F401
from vdnerf_tpu.models import precision as jprecision
from vdnerf_tpu.train import SceneStatic
from vdnerf_tpu.train.step import make_loss_fn
from vdnerf_tpu_torch.models.embedder import embed
from vdnerf_tpu_torch.models.fields import SDFNetwork
from vdnerf_tpu_torch.models.precision import env_fused, env_matmul_dtype, mlp_operand_dtype
from vdnerf_tpu_torch.ops.kernels import fused_mlp
from vdnerf_tpu_torch.train.step import Trainer

CPU = torch.device("cpu")
DBC_NETS = wdepth_nets(True, perturb=0.0, skip_bg_inside=True)
# the port's bf16 step (K2-K5's operands rounded to bf16, on the CPU their
# plain versions) on test_torch_train's scene and JAX's seed-0 weights at
# step 30, as the port computed it before the operand mode became a value
# (every model then ran bf16 operands): the loss (float.hex) and the SHA-256
# of the f32 loss and every gradient in name order (_step_digest), one torch
# thread
PARENT_BF16_STEP = ("0x1.9a220e0000000p+0",
                    "387d6877722ae1ddab9e01f720133e958537355750916af7126cd5cf28652d63")


@pytest.fixture
def f32_policy(monkeypatch):
    """JAX's default (f32 policy, no fused path) -> the port's operand mode
    for it, read from the environment as the entry points read it."""
    monkeypatch.delenv("VDNERF_FUSED", raising=False)
    monkeypatch.delenv("VDNERF_BF16", raising=False)
    assert not jprecision.use_fused_mlp() and jprecision.get_matmul_dtype() is None
    mode = mlp_operand_dtype(env_matmul_dtype(), env_fused())
    assert mode == torch.float32
    return mode


@pytest.fixture(scope="module")
def wdepth_scene(tmp_path_factory):
    return make_wdepth_scene(str(tmp_path_factory.mktemp("f32_wdepth")))


@pytest.fixture(scope="module")
def learn_scene(tmp_path_factory):
    return _learn_scene(str(tmp_path_factory.mktemp("f32_learn")))


@pytest.fixture(scope="module")
def learn_wdepth_scene(tmp_path_factory):
    return _learn_scene(str(tmp_path_factory.mktemp("f32_learn_wdepth")), wdepth=True)


def _jax_value_and_grad(nets, jcfg, static, params, jcams, batch, step, fused=False):
    fn = jax.jit(jax.value_and_grad(make_loss_fn(nets, jcfg, static), has_aux=True))
    jprecision.set_fused_mlp(fused)
    try:
        (loss, metrics), (g, gc) = fn((params, jcams), batch, step, jax.random.PRNGKey(0))
    finally:
        jprecision.set_fused_mlp(False)
    return float(loss), {k: float(v) for k, v in metrics.items()}, g, gc


def _check_step(got, model, loss, metrics, g):
    assert set(got) == set(metrics)
    for k, v in metrics.items():
        assert abs(float(got[k]) - v) <= 1e-5 * max(abs(v), 1e-3), (k, float(got[k]), v)
    assert abs(float(got["loss"]) - loss) <= 1e-5 * abs(loss)
    grads, want = _port_grads(model), _jax_tree_as_port(g)
    assert set(grads) == set(want)
    for name in want:
        _close_rel(grads[name], want[name].reshape(grads[name].shape), 1e-4, name)
    return grads


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("regime", ["womsk", "wdepth", "wmask"])
def test_f32_policy_step_matches_jax_default(request, f32_policy, regime):
    if regime == "womsk":
        sc, nets, step = request.getfixturevalue("scene"), NETS, 30
        jcfg, tcfg = _cfgs(sc)
    elif regime == "wmask":  # no background NeRF, the mask BCE
        sc, nets, step = request.getfixturevalue("scene"), MASK_CORES["faithful"], 30
        jcfg, tcfg = _cfgs(sc, **MASK)
    else:  # past depth_start_iter 5 and the 10-step ramp
        sc, nets, step = request.getfixturevalue("wdepth_scene"), WDEPTH_NETS, 30
        jcfg, tcfg = sc["jcfg"], sc["tcfg"]
    params = jax_params(nets)
    (jb,), (tb,) = _batches(sc, 1)
    loss, metrics, g, _ = _jax_value_and_grad(nets, jcfg, SceneStatic(H=H, W=W), params,
                                              sc["jcams"], jb, step)
    model = port_model(nets, params, f32_policy)
    got = Trainer(tcfg, model, sc["tcams"], None).gradients(port_nets(nets), tb, step)
    grads = _check_step(got, model, loss, metrics, g)
    if regime == "wdepth":
        assert all(grads[n].any() for n in grads
                   if n.startswith("depth_network_fine.") or ".dpt_linear." in n)


def test_f32_policy_wmask_resampled_step_matches_jax_default(scene, f32_policy):
    """The masked recipe's resampled core (after resample_from). The
    up-sample ladder amplifies f32 summation order in the gradients of a
    resampled core (ROADMAP section 3, ``tests/test_torch_masked.py``): the
    loss and metrics are held at 1e-5 relative, every gradient at that
    file's 2e-3 relative L2 (the bar of 1e-4 of the largest entry is missed:
    9.5e-5 against 2.4e-5 on ``sdf_network_fine.lin0.weight_v``)."""
    nets = MASK_CORES["resampled"]
    jcfg, tcfg = _cfgs(scene, **MASK)
    params = jax_params(nets)
    (jb,), (tb,) = _batches(scene, 1)
    loss, metrics, g, _ = _jax_value_and_grad(nets, jcfg, SceneStatic(H=H, W=W), params,
                                              scene["jcams"], jb, 30)
    model = port_model(nets, params, f32_policy)
    got = Trainer(tcfg, model, scene["tcams"], None).gradients(port_nets(nets), tb, 30)
    assert set(got) == set(metrics)
    for k, v in metrics.items():
        assert abs(float(got[k]) - v) <= 1e-5 * max(abs(v), 1e-3), (k, float(got[k]), v)
    grads, want = _port_grads(model), _jax_tree_as_port(g)
    assert set(grads) == set(want)
    for name in want:
        rel = _rel_l2(grads[name], want[name].reshape(grads[name].shape))
        assert rel <= 2e-3, f"{name}: relative L2 error {rel:.3e}"


@pytest.mark.parametrize("wdepth", [False, True], ids=["learn", "learn_wdepth"])
def test_f32_policy_learned_camera_step_matches_jax_default(request, f32_policy, wdepth):
    # with the distillation term: past depth_start_iter 5 and the 10-step ramp
    if wdepth:
        learn_scene, nets, step = request.getfixturevalue("learn_wdepth_scene"), \
            LEARN_WDEPTH_NETS, 30
        assert learn_scene["tcfg"].extract_depth
    else:
        learn_scene, nets, step = request.getfixturevalue("learn_scene"), NETS, 7
    jcams, cams = _cams(learn_scene, moved=True)
    params = jax_params(nets)
    (jb,), (tb,) = _batches(learn_scene, 1, seed=3)
    loss, metrics, g, gc = _jax_value_and_grad(nets, learn_scene["jcfg"], LEARN_SCENE, params,
                                               jcams, jb, step)
    model = port_model(nets, params, f32_policy)
    got = Trainer(learn_scene["tcfg"], model, cams, None).gradients(port_nets(nets), tb, step)
    grads = _check_step(got, model, loss, metrics, g)
    if wdepth:
        assert all(grads[n].any() for n in grads
                   if n.startswith("depth_network_fine.") or ".dpt_linear." in n)
    for name, got_g, want_g in (("r", cams.r.grad, gc["pose"]["r"]),
                                ("t", cams.t.grad, gc["pose"]["t"]),
                                ("fx", cams.fx.grad, gc["focal"]["fx"])):
        assert float(np.abs(np.asarray(want_g)).max()) > 0, name
        _close_rel(got_g.numpy(), np.asarray(want_g).reshape(got_g.shape), 1e-4, name)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_depth_before_color_step_matches_jax(wdepth_scene, monkeypatch, mode):
    monkeypatch.delenv("VDNERF_BF16", raising=False)
    monkeypatch.setenv("VDNERF_FUSED", "1") if mode == "bf16" else monkeypatch.delenv(
        "VDNERF_FUSED", raising=False)
    mm = mlp_operand_dtype(env_matmul_dtype(), env_fused())
    assert mm == (torch.bfloat16 if mode == "bf16" else torch.float32)
    jcfg, tcfg = (dataclasses.replace(wdepth_scene[k], depth_before_color=True)
                  for k in ("jcfg", "tcfg"))
    params = jax_params(DBC_NETS)
    (jb,), (tb,) = _batches(wdepth_scene, 1)
    loss, metrics, g, _ = _jax_value_and_grad(DBC_NETS, jcfg, SceneStatic(H=H, W=W), params,
                                              wdepth_scene["jcams"], jb, 30, mode == "bf16")
    model = port_model(DBC_NETS, params, mm)
    got = Trainer(tcfg, model, wdepth_scene["tcams"], None).gradients(port_nets(DBC_NETS), tb, 30)
    # the colour head reads the depth features: its first layer is 8 wider
    assert model.color_network_fine.lin0.weight_v.shape[1] == 64 + 8 + 9 + 24
    if mode == "f32":
        _check_step(got, model, loss, metrics, g)
        return
    assert abs(float(got["loss"]) - loss) <= 1e-5 * abs(loss)
    grads, want = _port_grads(model), _jax_tree_as_port(g)
    gaps = {n: _rel_l2(gr, want[n].reshape(gr.shape)) for n, gr in grads.items()}
    worst = max(gaps, key=gaps.get)
    print(f"\nbf16 depth_before_color: worst gradient relative L2 gap {gaps[worst]:.3e} ({worst})")
    assert gaps[worst] <= 2e-4, (worst, gaps[worst])


def _step_digest(loss: float, grads: dict) -> str:
    h = hashlib.sha256(np.float32(loss).tobytes())
    for n in sorted(grads):
        h.update(n.encode())
        h.update(np.ascontiguousarray(grads[n], np.float32).tobytes())
    return h.hexdigest()


def test_fused_env_reproduces_the_bf16_step_bit_for_bit(scene, monkeypatch):
    monkeypatch.delenv("VDNERF_BF16", raising=False)
    monkeypatch.setenv("VDNERF_FUSED", "1")
    mm = mlp_operand_dtype(env_matmul_dtype(), env_fused())
    assert mm == torch.bfloat16
    assert mlp_operand_dtype(torch.bfloat16, False) == torch.bfloat16  # the bf16 policy
    assert torch.get_num_threads() == 1
    _, tcfg = _cfgs(scene)
    params = jax_params(NETS)
    (_,), (tb,) = _batches(scene, 1)
    model = port_model(NETS, params, mm)
    with monkeypatch.context() as m:  # the SDF block on autograd's route, as it was then
        m.setattr(SDFNetwork, "sdf_value_grad_feat", SDFNetwork._value_grad_feat_autograd)
        got = Trainer(tcfg, model, scene["tcams"], None).gradients(port_nets(NETS), tb, 30)
    loss, want = float(got["loss"]), _port_grads(model)
    assert (loss.hex(), _step_digest(loss, want)) == PARENT_BF16_STEP
    # through ops/sdf_block.py's Function (the f32 policy's block since): the
    # same step within f32 rounding
    model = port_model(NETS, params, mm)
    got = Trainer(tcfg, model, scene["tcams"], None).gradients(port_nets(NETS), tb, 30)
    assert abs(float(got["loss"]) - loss) <= 1e-6 * abs(loss)
    for name, g in _port_grads(model).items():
        err = float(np.abs(g - want[name]).max())
        assert err <= 1e-5 * float(np.abs(want[name]).max()), name
    model = port_model(NETS, params, torch.float32)
    got = Trainer(tcfg, model, scene["tcams"], None).gradients(port_nets(NETS), tb, 30)
    assert float(got["loss"]) != loss  # the f32 mode is another step


def test_runner_takes_the_mode_from_the_policy(tmp_path, monkeypatch):
    from vdnerf_tpu_torch.data.synthetic import make_synthetic_scene, write_synthetic_conf
    from vdnerf_tpu_torch.runner import Runner

    make_synthetic_scene(str(tmp_path), n_images=2, H=16, W=16)
    conf = str(tmp_path / "synthetic.conf")
    write_synthetic_conf(conf, data_dir=str(tmp_path), exp_dir=str(tmp_path / "exp"))
    monkeypatch.delenv("VDNERF_BF16", raising=False)
    for fused, bf16, want in (("", "", torch.float32), ("1", "", torch.bfloat16),
                              ("", "1", torch.bfloat16)):
        monkeypatch.setenv("VDNERF_FUSED", fused)
        monkeypatch.setenv("VDNERF_BF16", bf16)
        r = Runner(conf, mode="train", device="cpu")
        nets = (r.model.color_network_fine, r.model.nerf)
        assert r.mlp_dtype == want and all(m.mm_dtype == want for m in nets), (fused, bf16)


# ---------------------------------------------------------------------------
# the split mode's launch schedules, each launch stood in for by torch
# ---------------------------------------------------------------------------


class TorchLaunches:
    """What each launch of ``fused_mlp._SplitOps`` computes, in torch."""

    def images(self, pairs):
        return [fused_mlp.SplitImage(None, 0, w, trans, fused_mlp.split_tile(
            w.shape[0] if trans else w.shape[1])) for w, trans in pairs]

    def mm(self, A, img, C, *, bias=None, epi=fused_mlp.EPI_NONE, aux=None, aux_n=0,
           n_store=None, C2=None, n_store2=0):
        assert A.shape[1] == img.K
        z = A @ (img.w.t() if img.trans else img.w)
        if bias is not None:
            z = z + bias
        g = torch.zeros_like(z)
        if aux is not None:
            g[:, :aux_n] = aux[:, :aux_n]
        if epi == fused_mlp.EPI_RELU:
            v = torch.relu(z)
        elif epi == fused_mlp.EPI_SIGMOID:
            v = torch.sigmoid(z)
        elif epi == fused_mlp.EPI_MASK:
            keep = torch.ones_like(z, dtype=torch.bool)
            keep[:, :aux_n] = aux[:, :aux_n] > 0
            v = torch.where(keep, z, torch.zeros_like(z))
        elif epi == fused_mlp.EPI_DSIGMOID:
            y = torch.sigmoid(z)
            v = g * y * (1.0 - y)
        elif epi == fused_mlp.EPI_DRELU:
            v = g * (torch.relu(z) > 0).float()
        else:
            v = z
        ns = v.shape[1] if n_store is None else n_store
        C[:, :ns] = v[:, :ns]
        if n_store2:
            C2[:, :n_store2] = v[:, ns:ns + n_store2]

    def embed(self, src, freqs, dst):
        e = embed(src, freqs)
        dst[:, :e.shape[1]] = e
        dst[:, e.shape[1]:] = 0.0

    def embed_vjp(self, srcs, x, freqs, out):
        total = srcs[0]
        for s in srcs[1:]:
            total = total + s
        out.copy_(fused_mlp._d_embed(total, x, freqs) if freqs else total)

    def dw(self, pairs, layers):
        return (torch.cat([(x.t() @ d).reshape(-1) for x, d in pairs]),
                torch.cat([d.sum(0) for _, d in pairs]))


def _close(got, want, what):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= 1e-5 * scale, f"{what}: {err:.3e} > 1e-5 x {scale:.3e}"


@pytest.mark.parametrize("squeeze_out", [True, False])
@pytest.mark.parametrize("mode", ["idr", "no_view_dir", "no_normal"])
def test_split_render_schedule_matches_plain(mode, squeeze_out):
    gen = torch.Generator().manual_seed(3)
    n, d_feat, d_out = 37, 20, 5
    k0 = 3 + d_feat + (27 if mode != "no_view_dir" else 0) + (3 if mode != "no_normal" else 0)
    dims = [(k0, 48), (48, 48), (48, d_out)]
    ws = [torch.randn(k, m, generator=gen) / k ** 0.5 for k, m in dims]
    bs = [torch.randn(m, generator=gen) * 0.1 for _, m in dims]
    x = [torch.randn(n, c, generator=gen) for c in (3, 3, 3, d_feat)]
    plan = (mode, 4, squeeze_out)
    packed = fused_mlp._render_meta(plan, x[3], ws, bs, CPU, torch.float32)
    _close(fused_mlp.split_render(TorchLaunches(), plan, *x, packed),
           fused_mlp.render_net_plain(plan, *x, ws, bs, mm=torch.float32), "forward")
    g = torch.randn(n, d_out, generator=gen)
    *got, grads = fused_mlp.split_render(TorchLaunches(), plan, *x, packed, g=g)
    want = fused_mlp.render_net_bwd_plain(plan, *x, ws, bs, g, mm=torch.float32)
    for i, name in enumerate(("d_pts", "d_normals", "d_dirs", "d_feat")):
        _close(got[i], want[i], name)
    for l, (dw, db) in enumerate(grads):
        _close(dw, want[4][l], f"dW{l}")
        _close(db, want[5][l], f"db{l}")


@pytest.mark.parametrize("skips", [(2,), (1, 2)])
@pytest.mark.parametrize("has_dpt", [False, True])
def test_split_nerf_schedule_matches_plain(has_dpt, skips):
    gen = torch.Generator().manual_seed(4)
    n, D, w = 41, 4, 32
    plan = (4, 2, skips, D, has_dpt)
    e_a, e_b = 4 * 9, 3 * 5
    tdims = [(e_a, w)] + [(w + (e_a if i - 1 in skips else 0), w) for i in range(1, D)]
    hdims = [(w, 1), (w, w), (w + e_b, w // 2), (w // 2, 3)] + ([(w // 2, 7)] if has_dpt else [])
    tw = [torch.randn(k, m, generator=gen) / k ** 0.5 for k, m in tdims]
    tb = [torch.randn(m, generator=gen) * 0.1 for _, m in tdims]
    hw = [torch.randn(k, m, generator=gen) / k ** 0.5 for k, m in hdims]
    hb = [torch.randn(m, generator=gen) * 0.1 for _, m in hdims]
    pts, views = torch.randn(n, 4, generator=gen), torch.randn(n, 3, generator=gen)
    packed = fused_mlp._nerf_meta(plan, 4, tw, tb, hw, hb, CPU, torch.float32)
    got = fused_mlp.split_nerf(TorchLaunches(), pts, views, packed)
    want = fused_mlp.nerf_plain(plan, pts, views, tw, tb, hw, hb, mm=torch.float32)
    assert (got[2] is None) == (not has_dpt)
    for a, b, name in zip(got, want, ("alpha", "rgb", "dpt")):
        if b is not None:
            _close(a, b, name)
    gs = (torch.randn(n, 1, generator=gen), torch.randn(n, 3, generator=gen),
          torch.randn(n, 7, generator=gen) if has_dpt else None)
    d_pts, d_views, grads = fused_mlp.split_nerf(TorchLaunches(), pts, views, packed, gs)
    want = fused_mlp.nerf_bwd_plain(plan, pts, views, tw, tb, hw, hb, *gs, mm=torch.float32)
    _close(d_pts, want[0], "d_pts")
    _close(d_views, want[1], "d_views")
    for k, (group, wgroup) in enumerate(zip(fused_mlp.nerf_grads_from_packed(packed[2], grads),
                                            want[2:])):
        for i, (a, b) in enumerate(zip(group, wgroup)):
            _close(a, b, f"group {k} #{i}")


def test_split_dw_plan():
    """At most two work items per SM over every layer's 128 x 128 output
    tiles, each split a multiple of 32 rows covering every row once."""
    layers = [(K, N, -(-K // 16) * 16, -(-N // 16) * 16, 0, 0)
              for K, N in [(289, 256), (256, 256), (256, 256), (256, 256), (256, 3)]]
    tiles = 6 + 4 + 4 + 4 + 2
    for n in (1, 37, 65_536, 65_573):
        splits, rows = fused_mlp.split_dw_plan(n, layers, 132)
        assert rows % 32 == 0 and (splits - 1) * rows < n <= splits * rows
        assert splits <= max(1, 2 * 132 // tiles)
    assert fused_mlp.split_dw_plan(65_536, layers, 132) == (13, 5_056)


# ---------------------------------------------------------------------------
# split_gemm_kernel's arithmetic and layout, mirrored in torch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [37, 4133])
def test_split_contraction_arithmetic_emulated(n):
    """The contraction as the kernel sums it: per row split of
    ``split_dw_plan``, each 32-row slab's small*big + big*small + big*big
    from zero (exact products, the slab's sum rounded to f32), slab sums
    added in f32 in row order; db the deltas' column sums taken serially in
    f32 in row order in the same pass; the splits summed in split order.
    Within the contraction's 1e-4 relative L2 of the f64 product."""
    gen = torch.Generator().manual_seed(6)
    x = torch.relu(torch.randn(n, 48, generator=gen))
    d = torch.randn(n, 32, generator=gen)
    layers = [(48, 32, 48, 32, 0, 0)]
    splits, rows = fused_mlp.split_dw_plan(n, layers, 8)
    assert splits > 1 and (splits - 1) * rows < n <= splits * rows
    xb, xs = fused_mlp.split_tf32(x)
    db_, ds = fused_mlp.split_tf32(d)
    dW = torch.zeros(48, 32)
    dB = torch.zeros(32)
    for s in range(splits):
        acc, col = torch.zeros(48, 32), torch.zeros(32)
        for k0 in range(s * rows, min(n, (s + 1) * rows), 32):
            sl = slice(k0, min(n, (s + 1) * rows, k0 + 32))
            part = (xs[sl].double().t() @ db_[sl].double() + xb[sl].double().t() @ ds[sl].double()
                    + xb[sl].double().t() @ db_[sl].double())
            acc = acc + part.float()
            for r in range(sl.start, sl.stop):
                col = col + d[r]
        dW, dB = dW + acc, dB + col
    want_w, want_b = x.double().t() @ d.double(), d.double().sum(0)
    assert float((dW.double() - want_w).norm() / want_w.norm()) <= 1e-4
    assert float((dB.double() - want_b).norm() / want_b.norm()) <= 1e-4


def test_split_converted_b_layout_is_what_wgmma_reads():
    """The producer's store of split B element (n, k) of a 128 x 32 slab,
    (n / 8) * 256 + (k / 4) * 32 + (n % 8) * 4 + k % 4 words, is a bijection
    onto the 4,096 words of a tile, and is the byte wgmma's K-major
    no-swizzle descriptor of 8-deep step k / 8 addresses: start 256 bytes a
    step, K-adjacent core matrices (8 rows x 16 bytes) LBO = 128 bytes apart,
    8-row groups SBO = 1,024 bytes apart."""
    n, k = torch.meshgrid(torch.arange(128), torch.arange(32), indexing="ij")
    stored = (n // 8) * 256 + (k // 4) * 32 + (n % 8) * 4 + k % 4
    assert sorted(stored.flatten().tolist()) == list(range(128 * 32))
    read = (k // 8) * 256 + ((k % 8) // 4) * 128 + (n // 8) * 1024 + (n % 8) * 16 + (k % 4) * 4
    assert torch.equal(4 * stored, read)


@pytest.mark.parametrize("K,N,trans", [(304, 256, False), (256, 16, False), (16, 256, True),
                                       (256, 304, True), (340, 256, False), (256, 272, True),
                                       (283, 128, False), (96, 256, True), (400, 256, False)])
def test_split_weight_image_is_what_wgmma_reads(K, N, trans):
    """The weight path's image of B (W [K, N], or W^T for a dx product): in
    the tile width ``split_tile`` picks, block (column tile j, slab s) holds
    B's big tf32 tile then its small one, and the bytes each 8-deep step's
    K-major no-swizzle wgmma descriptor addresses (start 256 bytes a step,
    K-adjacent core matrices LBO = 128 bytes apart, 8-column groups SBO =
    1,024 apart) are B's split elements, zero past K and N; the image's
    length is ``image_words``."""
    gen = torch.Generator().manual_seed(K * 7 + N)
    w = torch.randn(*((N, K) if trans else (K, N)), generator=gen) * 3.0
    bn = fused_mlp.split_tile(N)
    img = fused_mlp.split_image_plain(w, trans, bn)
    assert img.numel() == fused_mlp.image_words(K, N, bn)
    tiles, slabs = -(-N // bn), -(-K // 32)
    B = torch.zeros(slabs * 32, tiles * bn)
    B[:K, :N] = w.t() if trans else w
    big, small = fused_mlp.split_tf32(B)
    assert bool(((big + small) - B).abs().le(B.abs() * 2.0 ** -20).all())  # two tf32 terms
    k, n = torch.meshgrid(torch.arange(slabs * 32), torch.arange(tiles * bn), indexing="ij")
    block = (n // bn) * slabs + k // 32
    kl, nl = k % 32, n % bn
    byte = (kl // 8) * 256 + ((kl % 8) // 4) * 128 + (nl // 8) * 1024 + (nl % 8) * 16 + (kl % 4) * 4
    at = block * 2 * bn * 32 + byte // 4
    assert torch.equal(img[at], big) and torch.equal(img[at + bn * 32], small)
    assert sorted(torch.cat([at.flatten(), (at + bn * 32).flatten()]).tolist()) == \
        list(range(img.numel()))


@pytest.mark.parametrize("n,bn", [(1, 16), (3, 16), (16, 16), (17, 32), (96, 96), (99, 128),
                                  (112, 128), (128, 128), (256, 128), (272, 96), (288, 96),
                                  (304, 128), (352, 128)])
def test_split_tile_fits_the_output(n, bn):
    """The weight path's tile width: the narrowest wgmma width that holds a
    narrow output; past 128 columns the one of 96 and 128 that pads least."""
    assert fused_mlp.split_tile(n) == bn


def test_profile_split_refuses_to_run_without_a_card(capsys):
    """The launch-by-launch profile of the split mode measures the card
    only: without one it exits non-zero and prints no result."""
    from vdnerf_tpu_torch.tools import profile_split

    assert profile_split.main([]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "needs a CUDA device" in out.err
