"""The wdepth regime (``confs/womsk_white_wdepth_tpu.conf``) of the port
against vdnerf_tpu: the depth-feature store, the depth head (``d_out`` 8 here,
96 in the conf) with the background NeRF's dpt head, the sigmoid-ramped
distillation loss, checkpoints and the CLI, at small widths.

The scene is ``tests/test_torch_train.py``'s synthetic one (its sizes and
its ``_batches``) with numpy-seeded feature maps written per view as ``image/00/<stem>.npy``. Every
comparison except the bf16 render runs both sides' fused-MLP operands in f32
(``f32_matmuls``) on the JAX fused path (Pallas in interpret mode), as
``test_torch_train.py`` does.

Tolerances:

- store: ``depth_feats`` byte-identical (the same numpy and cv2 calls), for
  8-channel maps at half resolution, 1-channel [h, w] maps at half
  resolution, and 8-channel maps at full resolution (no resize); one seed's
  ``sample_pixels`` batches identical;
- render, deterministic, on the conf's renderer (``skip_bg_inside``, the
  24-of-48 resampled core at frac 1.0): ``render_feats`` within 1e-5 of JAX's
  default f32 path (f32 summation order), within 5e-3 of JAX's fused bf16
  path (an activation's bf16 rounding can land on the other side); with and
  without ``depth_before_color``;
- one step past ``depth_start_iter`` (and past the ramp): loss and metrics,
  ``depth_loss`` and ``psnr_dfeat`` included, within 1e-5 relative, every
  gradient within 1e-4 of its largest entry (``test_torch_train.py``'s
  tolerances); at a step at ``depth_start_iter`` the depth head's gradient is
  exactly zero on both sides;
- 20 steps with ``depth_start_iter`` 2 and ``depth_ramp_iters`` 10: each
  step's loss within 1e-4 relative;
- checkpoint: the unmodified ``import_torch_checkpoint(extract_depth=True,
  with_optimizer=True)`` reads the port's parameters and Adam moments exactly
  (``from_jax_params`` maps them back bit for bit), and JAX renders the same
  ``render_feats`` from them within 1e-5 (f32);
- CLI: 4 training steps of a wdepth conf, then ``valimg_4`` and
  ``getfeats_4``, all finite, the depth head in the checkpoint; a resumed
  runner holds the checkpoint's depth head and its Adam moments.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import BATCH, N_IMAGES, H, W, _batches, _close_rel, _jax_tree_as_port, _port_grads, fused  # noqa: F401
from torch_parity import f32_matmuls, jax_nets, jax_params, one_torch_thread, port_model, port_nets, rays  # noqa: F401
from vdnerf_tpu.data.dataset import SceneData as JSceneData
from vdnerf_tpu.data.dataset import near_far_from_sphere
from vdnerf_tpu.data.rays import RayStore as JRayStore
from vdnerf_tpu.data.synthetic import make_synthetic_scene, write_synthetic_conf
from vdnerf_tpu.models import fields as jf
from vdnerf_tpu.models import precision
from vdnerf_tpu.ops.renderer import render as jax_render
from vdnerf_tpu.train import SceneStatic, init_state, make_train_step
from vdnerf_tpu.train.config import TrainConfig as JTrainConfig
from vdnerf_tpu.train.step import make_loss_fn
from vdnerf_tpu.utils.hocon import load_conf as jload_conf
from vdnerf_tpu_torch.data.dataset import SceneData as TSceneData
from vdnerf_tpu_torch.data.dataset import near_far_from_sphere as port_near_far
from vdnerf_tpu_torch.data.rays import RayStore as TRayStore
from vdnerf_tpu_torch.ops.renderer import render as port_render
from vdnerf_tpu_torch.train.config import TrainConfig as TTrainConfig
from vdnerf_tpu_torch.train.step import Trainer
from vdnerf_tpu_torch.utils.hocon import load_conf as tload_conf

D_FEAT = 8
DEPTH = jf.RenderConfig(d_feature=64, d_hidden=64, n_layers=2, multires_view=4, d_out=D_FEAT)
DEPTH_KEYS = dict(extract_depth=True, depth_start_iter=5, depth_ramp_iters=10,
                  depth_loss_scale=10.0)
# (shape of one view's .npy) per store case
FEATURE_MAPS = {"c8_half": (D_FEAT, H // 2, W // 2), "c1_half": (H // 2, W // 2),
                "c8_full": (D_FEAT, H, W)}


def wdepth_nets(depth_before_color=False, **renderer):
    """The small nets of torch_parity with a depth head and the NeRF's dpt
    head; under ``depth_before_color`` the colour head reads the depth
    features after the SDF's."""
    base = jax_nets(**renderer)
    color = dataclasses.replace(base.color, d_feature=base.color.d_feature + D_FEAT) \
        if depth_before_color else base.color
    return dataclasses.replace(
        base, color=color, depth=DEPTH,
        nerf=dataclasses.replace(base.nerf, gen_depth_feats=True, dpt_dim=D_FEAT))


STEP_NETS = wdepth_nets(perturb=0.0, skip_bg_inside=True)
RENDER_RENDERER = dict(skip_bg_inside=True, n_render_samples=24, resample_uniform_frac=1.0)


def _write_features(data_dir, shape, seed=0):
    """One seeded .npy per view under image/00 (the synthetic conf's
    depth_dir), returned as the stacked array."""
    rng = np.random.default_rng(seed)
    out = os.path.join(data_dir, "image", "00")
    os.makedirs(out, exist_ok=True)
    stems = sorted(os.path.splitext(n)[0] for n in os.listdir(os.path.join(data_dir, "image"))
                   if n.endswith(".png"))
    maps = []
    for stem in stems:
        f = (rng.normal(size=shape) * 2.0 + 1.0).astype(np.float32)
        np.save(os.path.join(out, f"{stem}.npy"), f)
        maps.append(f)
    return np.stack(maps)


def make_scene(d: str) -> dict:
    """The synthetic scene with 8-channel half-resolution features in ``d``:
    both packages' configs (with DEPTH_KEYS), stores and cameras."""
    make_synthetic_scene(d, n_images=N_IMAGES, H=H, W=W)
    _write_features(d, FEATURE_MAPS["c8_half"])
    conf = os.path.join(d, "synthetic.conf")
    write_synthetic_conf(conf, data_dir=d, exp_dir=os.path.join(d, "exp"), batch_size=BATCH)
    jconf, tconf = jload_conf(conf), tload_conf(conf)
    jsd, tsd = JSceneData(jconf["dataset"]), TSceneData(tconf["dataset"])
    return {
        "dir": d,
        "jcfg": dataclasses.replace(JTrainConfig.from_conf(jconf), **DEPTH_KEYS),
        "tcfg": dataclasses.replace(TTrainConfig.from_conf(tconf), **DEPTH_KEYS),
        "jstore": JRayStore(jsd.images_lis, jsd.masks_lis, jsd.depth_lis, with_depth=True),
        "tstore": TRayStore(tsd.images_lis, tsd.masks_lis, tsd.depth_lis, with_depth=True),
        "jcams": {"pose_all": jnp.asarray(jsd.pose_all),
                  "intrin_inv_all": jnp.asarray(jsd.intrinsics_all_inv)},
        "tcams": {"pose_all": torch.as_tensor(tsd.pose_all),
                  "intrin_inv_all": torch.as_tensor(tsd.intrinsics_all_inv)},
    }


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_scene(str(tmp_path_factory.mktemp("torch_wdepth")))


# ---------------------------------------------------------------------------
# the depth-feature store
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(FEATURE_MAPS))
def test_depth_feature_store_matches_jax(tmp_path, case):
    d = str(tmp_path)
    make_synthetic_scene(d, n_images=N_IMAGES, H=H, W=W)
    maps = _write_features(d, FEATURE_MAPS[case], seed=7)
    conf = os.path.join(d, "synthetic.conf")
    write_synthetic_conf(conf, data_dir=d, exp_dir=os.path.join(d, "exp"))
    jsd, tsd = JSceneData(jload_conf(conf)["dataset"]), TSceneData(tload_conf(conf)["dataset"])
    assert tsd.depth_lis == jsd.depth_lis
    want = JRayStore(jsd.images_lis, jsd.masks_lis, jsd.depth_lis, with_depth=True)
    got = TRayStore(tsd.images_lis, tsd.masks_lis, tsd.depth_lis, with_depth=True)
    c = maps.shape[1] if maps.ndim == 4 else 1
    assert got.depth_feats.dtype == np.float16 and got.depth_feats.shape == (N_IMAGES, H, W, c)
    assert got.feat_dim == want.feat_dim == c
    assert got.depth_feats.tobytes() == want.depth_feats.tobytes()
    batches = []
    for store in (want, got):
        rng = np.random.default_rng(11)
        batches.append([store.sample_pixels(i, BATCH, rng) for i in range(N_IMAGES)])
    for jb, tb in zip(*batches):
        assert jb.keys() == tb.keys()
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        assert tb["feats"].dtype == np.float32 and tb["feats"].shape == (BATCH, c)


def test_store_without_depth_gives_zero_feats(scene):
    tsd = TSceneData(tload_conf(os.path.join(scene["dir"], "synthetic.conf"))["dataset"])
    store = TRayStore(tsd.images_lis, tsd.masks_lis)
    b = store.sample_pixels(0, 5, np.random.default_rng(0))
    assert store.feat_dim == 1 and b["feats"].shape == (5, 1) and not b["feats"].any()


# ---------------------------------------------------------------------------
# render
# ---------------------------------------------------------------------------


def _renders(nets, dbc, policy):
    params = jax_params(nets, seed=3)
    o, d = rays(64, seed=5)

    @jax.jit
    def go(params, o, d):
        near, far = near_far_from_sphere(o, d)
        return jax_render(nets, params, o, d, near, far, perturb_overwrite=0,
                          background_rgb=jnp.ones((1, 3)), cos_anneal_ratio=0.5,
                          depth_before_color=dbc)

    precision.set_fused_mlp(policy == "bf16")
    try:
        want = {k: np.asarray(v) for k, v in go(params, jnp.asarray(o), jnp.asarray(d)).items()
                if v is not None}
    finally:
        precision.set_fused_mlp(False)
    mm = torch.float32 if policy == "f32" else torch.bfloat16
    return _port_render_np(nets, port_model(nets, params, mm), o, d, dbc), want, params


def _port_render_np(nets, model, o, d, dbc):
    ro, rd = torch.from_numpy(o), torch.from_numpy(d)
    with torch.no_grad():
        out = port_render(port_nets(nets), model, ro, rd, *port_near_far(ro, rd),
                          perturb_overwrite=0, background_rgb=torch.ones(1, 3),
                          cos_anneal_ratio=0.5, depth_before_color=dbc)
    return {k: v.numpy() for k, v in out.items()}


FEAT_TOL = {"f32": 1e-5, "bf16": 5e-3}


@pytest.mark.parametrize("dbc", [False, True], ids=["depth_after_color", "depth_before_color"])
@pytest.mark.parametrize("policy", ["f32", "bf16"])
def test_wdepth_render_matches_jax(request, policy, dbc):
    if policy == "f32":
        request.getfixturevalue("f32_matmuls")
    nets = wdepth_nets(dbc, **RENDER_RENDERER)
    got, want, _ = _renders(nets, dbc, policy)
    assert got["render_feats"].shape == (64, D_FEAT) and np.isfinite(got["render_feats"]).all()
    err = float(np.abs(got["render_feats"] - want["render_feats"]).max())
    print(f"\n{policy} depth_before_color={dbc}: render_feats max abs err {err:.3e}")
    assert err <= FEAT_TOL[policy]
    np.testing.assert_allclose(got["color_fine"], want["color_fine"], atol=5e-3, rtol=0)


def test_render_without_depth_head_has_no_render_feats():
    nets = jax_nets(perturb=0.0)
    o, d = rays(8)
    out = _port_render_np(nets, port_model(nets, jax_params(nets), torch.bfloat16), o, d, False)
    assert "render_feats" not in out


# ---------------------------------------------------------------------------
# the step and the trajectory
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _jax_value_and_grad(jcfg):
    """One jitted JAX loss-and-gradient for every step of the tests (the step
    is a traced argument)."""
    loss_fn = make_loss_fn(STEP_NETS, jcfg, SceneStatic(H=H, W=W))
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _jax_step(scene, params, batch, step):
    fn = _jax_value_and_grad(scene["jcfg"])
    (loss, metrics), (g, _) = fn((params, scene["jcams"]), batch, step, jax.random.PRNGKey(0))
    return float(loss), {k: float(v) for k, v in metrics.items()}, g


@pytest.mark.parametrize("step", [5, 30], ids=["at_depth_start", "past_the_ramp"])
def test_wdepth_step_matches_jax(scene, f32_matmuls, fused, step):
    params = jax_params(STEP_NETS)
    (jb,), (tb,) = _batches(scene, 1)
    loss, metrics, g = _jax_step(scene, params, jb, step)
    model = port_model(STEP_NETS, params, f32_matmuls)
    got = Trainer(scene["tcfg"], model, scene["tcams"], None).gradients(
        port_nets(STEP_NETS), tb, step)
    assert {"depth_loss", "psnr_dfeat"} <= set(got) and set(got) == set(metrics)
    for k, v in metrics.items():
        assert abs(float(got[k]) - v) <= 1e-5 * max(abs(v), 1e-3), (k, float(got[k]), v)
    assert abs(float(got["loss"]) - loss) <= 1e-5 * abs(loss)
    grads, want = _port_grads(model), _jax_tree_as_port(g)
    assert set(grads) == set(want)
    assert any(n.startswith("depth_network_fine.") for n in grads) and "nerf.dpt_linear.weight" in grads
    for name in want:
        _close_rel(grads[name], want[name].reshape(grads[name].shape), 1e-4, name)
    depth = [n for n in grads if n.startswith("depth_network_fine.") or ".dpt_linear." in n]
    if step <= scene["tcfg"].depth_start_iter:
        # the gate is off: the depth head and the dpt head get exactly nothing
        assert not any(grads[n].any() or want[n].any() for n in depth)
    else:
        assert all(grads[n].any() for n in depth)


def test_wdepth_twenty_step_trajectory_matches_jax(scene, f32_matmuls, fused):
    kw = dict(warm_up_end=5, depth_start_iter=2, depth_ramp_iters=10)
    jcfg, tcfg = (dataclasses.replace(scene[k], **kw) for k in ("jcfg", "tcfg"))
    params = jax_params(STEP_NETS)
    jbs, tbs = _batches(scene, 20, seed=4)
    state = init_state(params, jcfg, scene["jcams"], jax.random.PRNGKey(0))
    step_fn = jax.jit(make_train_step(STEP_NETS, jcfg, SceneStatic(H=H, W=W)))
    want = []
    for b in jbs:
        state, m = step_fn(state, b)
        want.append((float(m["loss"]), float(m["depth_loss"])))
    trainer = Trainer(tcfg, port_model(STEP_NETS, params, f32_matmuls), scene["tcams"], None)
    got = []
    for i, b in enumerate(tbs):
        m = trainer.step(port_nets(STEP_NETS), b, i)
        got.append((float(m["loss"]), float(m["depth_loss"])))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    assert want[-1][1] < want[2][1]  # the distillation loss falls once it is on


# ---------------------------------------------------------------------------
# checkpoint and CLI
# ---------------------------------------------------------------------------


def test_wdepth_checkpoint_reads_into_jax_and_renders_the_same(scene, tmp_path, f32_matmuls):
    from vdnerf_tpu.io.checkpoints import import_torch_checkpoint
    from vdnerf_tpu_torch.io.checkpoints import from_jax_params, save_training_checkpoint

    model = port_model(STEP_NETS, jax_params(STEP_NETS), f32_matmuls)
    tcfg = dataclasses.replace(scene["tcfg"], depth_start_iter=0)
    trainer = Trainer(tcfg, model, scene["tcams"], None)
    _, tbs = _batches(scene, 3, seed=6)
    for i, b in enumerate(tbs):
        trainer.step(port_nets(STEP_NETS), b, i + 100)  # past warm-up and the gate
    path = os.path.join(tmp_path, "ckpt_000003.pth")
    save_training_checkpoint(path, model, 3, trainer.optimizer)
    assert "depth_network_fine" in torch.load(path, weights_only=True)
    params, step, moments = import_torch_checkpoint(path, STEP_NETS, True, with_optimizer=True)
    assert step == 3 and moments is not None and "depth" in params
    mu, nu, count = moments
    assert count == 3
    opt_state = trainer.optimizer.state
    for tree, get in ((params, lambda p: p.detach()),
                      (mu, lambda p: opt_state[p]["exp_avg"]),
                      (nu, lambda p: opt_state[p]["exp_avg_sq"])):
        want = from_jax_params(jax.tree_util.tree_map(np.asarray, tree))
        assert set(want) == {n for n, _ in model.named_parameters()}
        for name, p in model.named_parameters():
            torch.testing.assert_close(want[name].reshape(p.shape), get(p), rtol=0, atol=0)

    o, d = rays(32, seed=8)

    @jax.jit
    def go(params, o, d):
        near, far = near_far_from_sphere(o, d)
        return jax_render(STEP_NETS, params, o, d, near, far, perturb_overwrite=0,
                          background_rgb=jnp.ones((1, 3)), cos_anneal_ratio=0.5)["render_feats"]

    got = _port_render_np(STEP_NETS, model, o, d, False)["render_feats"]
    want = np.asarray(go(params, jnp.asarray(o), jnp.asarray(d)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _wdepth_conf(data_dir, name, **train) -> str:
    """The synthetic conf turned into a wdepth one: the depth head, the
    NeRF's dpt head and the distillation keys of the shipped recipe."""
    path = os.path.join(data_dir, f"{name}.conf")
    write_synthetic_conf(path, data_dir=data_dir, exp_dir=os.path.join(data_dir, name),
                         batch_size=BATCH, **train)
    with open(path) as f:
        text = f.read()
    subs = [
        ("extract_depth = False", "extract_depth = True\n    depth_start_iter = 1\n"
         "    depth_loss_scale = 10\n    only_depth = False\n    depth_before_color = False\n"
         "    depth_weight = 0.2"),
        ("use_viewdirs = True,", f"use_viewdirs = True,\n        gen_depth_feats = True,\n"
         f"        dpt_dim = {D_FEAT},"),
        ("    neus_renderer {", "    depth_extract_network {\n        d_feature = 64\n"
         "        mode = idr\n        d_in = 9\n        d_out = 8\n        d_hidden = 64\n"
         "        n_layers = 2\n        weight_norm = True\n        multires_view = 4\n"
         "        squeeze_out = True\n    }\n\n    neus_renderer {"),
        ("perturb = 1.0", "perturb = 1.0\n        skip_bg_inside = True"),
    ]
    for old, new in subs:
        text, n = re.subn(re.escape(old), new, text)
        assert n == 1, old
    with open(path, "w") as f:
        f.write(text)
    return path


def test_cli_trains_and_serves_a_wdepth_conf(scene):
    from vdnerf_tpu_torch.cli import main

    d = scene["dir"]
    conf = _wdepth_conf(d, "wdepth_cli", end_iter=4, save_freq=4)
    summary = main(["--conf", conf, "--mode", "train"], device="cpu")
    assert summary is not None and all(np.isfinite(v) for v in summary.values())
    with open(os.path.join(d, "wdepth_cli", "logs", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert all(np.isfinite(r["depth_loss"]) and np.isfinite(r["psnr_dfeat"]) for r in recs)
    ckpt = torch.load(os.path.join(d, "wdepth_cli", "checkpoints", "ckpt_000004.pth"),
                      weights_only=True)
    assert ckpt["depth_network_fine"]["lin2.weight_v"].shape == (D_FEAT, 64)
    assert ckpt["nerf"]["dpt_linear.weight"].shape == (D_FEAT, 32)
    # resuming loads the depth head and its Adam moments with the rest
    from vdnerf_tpu_torch.runner import Runner

    resumed = Runner(conf, mode="train", is_continue=True, device="cpu")
    assert resumed.iter_step == 4
    depth = resumed.model.depth_network_fine
    for name, p in depth.named_parameters():
        torch.testing.assert_close(p.detach(), ckpt["depth_network_fine"][name], rtol=0, atol=0)
        assert resumed.trainer.optimizer.state[p]["exp_avg"].any(), name
    served = main(["--conf", conf, "--mode", "valimg_4"], device="cpu")
    # the same weights and the deterministic render as the run's closing validation
    assert served.keys() == summary.keys()
    assert max(abs(served[k] - summary[k]) for k in summary) <= 1e-6
    feats = main(["--conf", conf, "--mode", "getfeats_4"], device="cpu")
    assert all(np.isfinite(v) for v in feats.values())
    depth = os.path.join(d, "image", "depth_from_sdf")
    assert len([n for n in os.listdir(depth) if n.endswith(".npy")]) == N_IMAGES
