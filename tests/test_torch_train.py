"""The port's training step against vdnerf_tpu's on one synthetic scene.

The same parameters (``from_jax_params``), the same pixel batches
(``RayStore.sample_pixels`` from one numpy seed in both packages), the
deterministic render (``perturb = 0``), the JAX fused-MLP path (Pallas in
interpret mode) and both sides' fused-MLP matmul operands in f32
(``f32_matmuls``; the SDF block is f32 on both sides anyway).

Tolerances:

- loss and metrics: 1e-5 relative, f32 summation order;
- each parameter's gradient: 1e-4 of the tensor's largest entry. The
  gradients are sums over thousands of samples and reach the SDF through a
  second-order path (the eikonal term and the normals the colour head reads),
  where f32 rounding in another order accumulates further;
- Adam with ``neus_lr_schedule``: parameters within 1e-6 (the update is
  lr-sized, lr <= 5e-4, and the schedule agrees to an f32 ulp);
- the 20-step trajectory: each step's loss within 1e-4 relative. From the
  first update on, a gradient entry near zero moves its parameter by about
  +-lr on its sign alone (Adam's first step is lr * g / |g|), so the two sides
  drift apart by rounding; the tolerance states how little that moves the
  loss over 20 steps.
"""

from __future__ import annotations

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import one_torch_thread, f32_matmuls, jax_nets, jax_params, port_model, port_nets  # noqa: F401
from vdnerf_tpu.data.dataset import SceneData as JSceneData
from vdnerf_tpu.data.rays import RayStore as JRayStore
from vdnerf_tpu.data.synthetic import make_synthetic_scene, write_synthetic_conf
from vdnerf_tpu.models import precision
from vdnerf_tpu.train import SceneStatic, init_state, make_train_step
from vdnerf_tpu.train.config import TrainConfig as JTrainConfig
from vdnerf_tpu.train.step import make_loss_fn, make_optimizers
from vdnerf_tpu.utils.hocon import load_conf as jload_conf
from vdnerf_tpu_torch.data.dataset import SceneData as TSceneData
from vdnerf_tpu_torch.data.rays import RayStore as TRayStore
from vdnerf_tpu_torch.io.checkpoints import from_jax_params
from vdnerf_tpu_torch.train.config import TrainConfig as TTrainConfig
from vdnerf_tpu_torch.train.step import Trainer
from vdnerf_tpu_torch.utils.hocon import load_conf as tload_conf

N_IMAGES, H, W, BATCH = 3, 32, 40, 64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_train"))
    make_synthetic_scene(d, n_images=N_IMAGES, H=H, W=W)
    conf = os.path.join(d, "synthetic.conf")
    write_synthetic_conf(conf, data_dir=d, exp_dir=os.path.join(d, "exp"), batch_size=BATCH)
    jconf, tconf = jload_conf(conf), tload_conf(conf)
    jsd, tsd = JSceneData(jconf["dataset"]), TSceneData(tconf["dataset"])
    return {
        "jcfg": JTrainConfig.from_conf(jconf), "tcfg": TTrainConfig.from_conf(tconf),
        "jstore": JRayStore(jsd.images_lis, jsd.masks_lis),
        "tstore": TRayStore(tsd.images_lis, tsd.masks_lis),
        "jcams": {"pose_all": jnp.asarray(jsd.pose_all),
                  "intrin_inv_all": jnp.asarray(jsd.intrinsics_all_inv)},
        "tcams": {"pose_all": torch.as_tensor(tsd.pose_all),
                  "intrin_inv_all": torch.as_tensor(tsd.intrinsics_all_inv)},
    }


@pytest.fixture
def fused():
    precision.set_fused_mlp(True)
    yield
    precision.set_fused_mlp(False)


NETS = jax_nets(perturb=0.0, skip_bg_inside=True)


def _cfgs(scene, **kw):
    return dataclasses.replace(scene["jcfg"], **kw), dataclasses.replace(scene["tcfg"], **kw)


def _batches(scene, n, seed=0):
    """n pixel batches from one numpy seed in each package."""
    out = []
    for key in ("jstore", "tstore"):
        rng = np.random.default_rng(seed)
        out.append([scene[key].sample_pixels(i % N_IMAGES, BATCH, rng) for i in range(n)])
    for jb, tb in zip(*out):
        np.testing.assert_array_equal(jb["pixels_x"], tb["pixels_x"])
        np.testing.assert_array_equal(jb["color"], tb["color"])
    return out


def _close_rel(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: max abs err {err:.3e} > {rel:.0e} x {scale:.3e}"


def _port_grads(model) -> dict[str, np.ndarray]:
    return {n: p.grad.numpy() for n, p in model.named_parameters()}


def _jax_tree_as_port(tree) -> dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in from_jax_params(jax.tree_util.tree_map(np.asarray, tree)).items()}


def _compare_grads(got: dict, want: dict):
    assert set(got) == set(want)
    for name in want:
        _close_rel(got[name], want[name].reshape(got[name].shape), 1e-4, name)


def _jax_value_and_grad(scene, jcfg, params, batch, step, loss_fn=None):
    loss_fn = loss_fn or make_loss_fn(NETS, jcfg, SceneStatic(H=H, W=W))
    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (loss, metrics), (g, _) = fn((params, scene["jcams"]), batch, step, jax.random.PRNGKey(0))
    return float(loss), {k: float(v) for k, v in metrics.items()}, g


@pytest.mark.parametrize("step", [0, 30])
def test_one_step_loss_metrics_and_gradients_match_jax(scene, f32_matmuls, fused, step):
    jcfg, tcfg = _cfgs(scene)
    params = jax_params(NETS)
    (jb,), (tb,) = _batches(scene, 1)
    loss, metrics, g = _jax_value_and_grad(scene, jcfg, params, jb, step)

    model = port_model(NETS, params)
    got = Trainer(tcfg, model, scene["tcams"], None).gradients(port_nets(NETS), tb, step)
    for k, v in metrics.items():
        assert abs(float(got[k]) - v) <= 1e-5 * max(abs(v), 1e-3), (k, float(got[k]), v)
    assert abs(float(got["loss"]) - loss) <= 1e-5 * abs(loss)
    _compare_grads(_port_grads(model), _jax_tree_as_port(g))


def test_eikonal_gradient_reaches_the_sdf_through_the_second_order_path(scene, f32_matmuls, fused):
    """d(eikonal)/d(SDF params) alone: the term reads only the SDF's spatial
    gradient, so this is the double-backward path by itself."""
    from vdnerf_tpu.train import step as jstep

    jcfg, tcfg = _cfgs(scene)
    params = jax_params(NETS)
    (jb,), (tb,) = _batches(scene, 1, seed=1)
    full = jstep.make_loss_fn(NETS, jcfg, SceneStatic(H=H, W=W))

    def eik_only(trainables, batch, step, key):
        _, m = full(trainables, batch, step, key)
        return m["eikonal_loss"], m

    want_loss, _, g = _jax_value_and_grad(scene, jcfg, params, jb, 5, eik_only)
    model = port_model(NETS, params)
    loss = _eikonal_loss(model, tcfg, scene, tb)
    sdf_params = list(model.sdf_network_fine.named_parameters())
    # the last bias does not reach the spatial gradient: its gradient is 0
    grads = torch.autograd.grad(loss, [p for _, p in sdf_params], materialize_grads=True)
    want = _jax_tree_as_port(g)
    for (name, _), gr in zip(sdf_params, grads):
        _close_rel(gr.numpy(), want[f"sdf_network_fine.{name}"].reshape(gr.shape), 1e-4, name)
    assert abs(float(loss) - want_loss) <= 1e-5 * want_loss


def _eikonal_loss(model, tcfg, scene, batch):
    from vdnerf_tpu_torch.data.dataset import near_far_from_sphere
    from vdnerf_tpu_torch.ops.renderer import render
    from vdnerf_tpu_torch.train.step import cos_anneal_ratio, rays_from_batch

    o, d = rays_from_batch(scene["tcams"], batch, "cpu")
    out = render(port_nets(NETS), model, o, d, *near_far_from_sphere(o, d),
                 background_rgb=torch.ones(1, 3),
                 cos_anneal_ratio=cos_anneal_ratio(5, tcfg.anneal_end))
    return out["gradient_error_num"].sum() / (out["gradient_error_den"].sum() + 1e-5)


def _adam_mu_as_grads(opt_state) -> dict[str, np.ndarray]:
    """After one optax.adam update from zero, mu = (1 - b1) g."""
    mu = next(s.mu for s in opt_state if hasattr(s, "mu"))
    return {k: v / 0.1 for k, v in _jax_tree_as_port(mu).items()}


def test_grad_accum_2_matches_jax(scene, f32_matmuls, fused):
    jcfg, tcfg = _cfgs(scene, grad_accum=2)
    params = jax_params(NETS)
    (jb,), (tb,) = _batches(scene, 1, seed=2)
    state = init_state(params, jcfg, scene["jcams"], jax.random.PRNGKey(0))
    step_fn = jax.jit(make_train_step(NETS, jcfg, SceneStatic(H=H, W=W), grad_accum=2))
    state, metrics = step_fn(state, jb)

    model = port_model(NETS, params)
    got = Trainer(tcfg, model, scene["tcams"], None).step(port_nets(NETS), tb, 0)
    for k, v in metrics.items():
        assert abs(float(got[k]) - float(v)) <= 1e-5 * max(abs(float(v)), 1e-3), k
    _compare_grads(_port_grads(model), _adam_mu_as_grads(state["opt_state"]))


@pytest.mark.parametrize("warm_up_end", [0, 3])
def test_adam_and_schedule_match_optax(scene, warm_up_end):
    jcfg, tcfg = _cfgs(scene, warm_up_end=warm_up_end, end_iter=8)
    params = jax_params(NETS)
    opt = make_optimizers(jcfg)[0]
    opt_state = opt.init(params)
    model = port_model(NETS, params)
    trainer = Trainer(tcfg, model, scene["tcams"], None)
    rng = np.random.default_rng(3)
    for step in range(5):
        g = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32) * 1e-2), params)
        updates, opt_state = opt.update(g, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        g_port = _jax_tree_as_port(g)
        for name, p in model.named_parameters():
            p.grad = torch.tensor(g_port[name]).reshape(p.shape)
        trainer.apply(step)
    want = _jax_tree_as_port(params)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].reshape(p.shape), atol=1e-6,
                                   rtol=0, err_msg=name)
    if warm_up_end:
        # the first update under warm-up has lr = 0: Adam's moments move, the
        # parameters do not
        first = Trainer(tcfg, port_model(NETS, jax_params(NETS)), scene["tcams"], None)
        before = [p.detach().clone() for p in first.params]
        for p in first.params:
            p.grad = torch.ones_like(p)
        first.apply(0)
        assert all(torch.equal(a, p.detach()) for a, p in zip(before, first.params))


def test_twenty_step_trajectory_matches_jax(scene, f32_matmuls, fused):
    jcfg, tcfg = _cfgs(scene, warm_up_end=5)
    params = jax_params(NETS)
    jbs, tbs = _batches(scene, 20, seed=4)
    state = init_state(params, jcfg, scene["jcams"], jax.random.PRNGKey(0))
    step_fn = jax.jit(make_train_step(NETS, jcfg, SceneStatic(H=H, W=W)))
    want = []
    for b in jbs:
        state, m = step_fn(state, b)
        want.append(float(m["loss"]))

    model = port_model(NETS, params)
    trainer = Trainer(tcfg, model, scene["tcams"], None)
    got = [float(trainer.step(port_nets(NETS), b, i)["loss"]) for i, b in enumerate(tbs)]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    assert want[-1] < want[0]


@pytest.mark.parametrize("conf", sorted(glob.glob(os.path.join(ROOT, "confs", "*.conf"))),
                         ids=os.path.basename)
def test_train_config_matches_jax_for_every_conf(conf):
    want = dataclasses.asdict(JTrainConfig.from_conf(jload_conf(conf, "x")))
    assert dataclasses.asdict(TTrainConfig.from_conf(tload_conf(conf, "x"))) == want


@pytest.mark.parametrize("batch_size,grad_accum", [(4096, 1), (6144, 1), (8192, 2), (512, 4)])
def test_train_config_auto_split_matches_jax(batch_size, grad_accum):
    kw = dict(batch_size=batch_size, grad_accum=grad_accum)
    assert TTrainConfig(**kw).grad_accum == JTrainConfig(**kw).grad_accum
