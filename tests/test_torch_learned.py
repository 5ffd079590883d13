"""Learned cameras (``confs/womsk_learn_white_colmap.conf`` and its wdepth
variant) in the port against vdnerf_tpu, at small widths on the synthetic
scene of ``tests/test_torch_train.py``.

The learn confs' renderer: the background NeRF over every merged sample
(``skip_bg_inside`` off), no resampled core; ``perturb`` 0 so that both
sides render the same samples. Both sides' fused-MLP operands run in f32 on
JAX's fused path (Pallas in interpret mode), as ``test_torch_train.py``
does. The cameras start where training starts them (r = t = 0, fx from the
scene's focal), or at a seeded moved state.

Tolerances:

- one step against ``jax.value_and_grad`` over ``(params, cams)``: loss and
  metrics 1e-5 relative, each network gradient within 1e-4 of its largest
  entry (``test_torch_train.py``), the r, t and fx gradients within 1e-4
  relative L2 (each is a sum over the batch's rays and samples, where f32
  rounding in another order cancels unevenly);
- 20 steps against ``make_train_step`` with ``start_refine_pose_iter`` 5:
  each step's loss within 1e-4 relative, the final t, fx and every network
  tensor within 1e-4 relative L2, the final r within 5e-4 (measured 1.5e-4):
  past the gate r sits at 1e-4 to 1e-3, where ``so3_exp``'s f32 formula,
  copied from JAX, loses up to 6e-5 of its VJP to the cancellation in
  1 - cos on both sides (``test_torch_cameras.py`` holds that against f64),
  and the two packages' last-ulp cos differ; the cameras exactly at their
  initial values through step 5 on both sides;
- a K = 4 window against ``make_train_scan_step`` across the refine gate,
  the wdepth-learn step: as above;
- ``Runner.train`` writes ``pnf_<it>.pth`` that the unmodified
  ``import_torch_pnf_checkpoint`` reads back exactly; a resumed runner's
  next steps equal the uninterrupted runner's bit for bit;
- ``valimg_<it>`` from a JAX ``ckpt_<it>.npz`` of a learned state: PSNR
  within 0.01 dB of the JAX CLI's, L1 within 1e-4.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import BATCH, N_IMAGES, H, W, _batches, _close_rel, _jax_tree_as_port, _port_grads, fused  # noqa: F401
from test_torch_wdepth import make_scene, wdepth_nets
from torch_parity import f32_matmuls, jax_nets, jax_params, one_torch_thread, port_model, port_nets  # noqa: F401
from vdnerf_tpu.data.dataset import SceneData as JSceneData
from vdnerf_tpu.data.rays import RayStore as JRayStore
from vdnerf_tpu.data.synthetic import make_synthetic_scene, write_synthetic_conf
from vdnerf_tpu.train import SceneStatic, init_state, make_train_scan_step, make_train_step
from vdnerf_tpu.train.config import TrainConfig as JTrainConfig
from vdnerf_tpu.train.step import make_loss_fn
from vdnerf_tpu.utils.hocon import load_conf as jload_conf
from vdnerf_tpu_torch.data.cameras import LearnedCameras
from vdnerf_tpu_torch.data.dataset import SceneData as TSceneData
from vdnerf_tpu_torch.data.rays import RayStore as TRayStore
from vdnerf_tpu_torch.io.checkpoints import from_jax_cams
from vdnerf_tpu_torch.train.config import TrainConfig as TTrainConfig
from vdnerf_tpu_torch.train.dispatch import StepDispatch
from vdnerf_tpu_torch.train.step import Trainer
from vdnerf_tpu_torch.utils.hocon import load_conf as tload_conf

# the learn confs' camera keys, with a pose/focal milestone every 5 steps
LEARN = dict(learnable=True, focal_lr=5e-4, pose_lr=5e-4, focal_lr_gamma=0.9,
             pose_lr_gamma=0.9, step_size=5, start_refine_pose_iter=-1,
             start_refine_focal_iter=-1)
NETS = jax_nets(perturb=0.0)
WDEPTH_NETS = wdepth_nets(perturb=0.0)
SCENE = SceneStatic(H=H, W=W, focal_order=2, learnable=True)


def _learn_scene(d: str, wdepth: bool = False) -> dict:
    if wdepth:
        base = make_scene(d)
    else:
        make_synthetic_scene(d, n_images=N_IMAGES, H=H, W=W)
        conf = os.path.join(d, "synthetic.conf")
        write_synthetic_conf(conf, data_dir=d, exp_dir=os.path.join(d, "exp"),
                             batch_size=BATCH)
        jconf, tconf = jload_conf(conf), tload_conf(conf)
        jsd, tsd = JSceneData(jconf["dataset"]), TSceneData(tconf["dataset"])
        base = {"jcfg": JTrainConfig.from_conf(jconf), "tcfg": TTrainConfig.from_conf(tconf),
                "jstore": JRayStore(jsd.images_lis, jsd.masks_lis),
                "tstore": TRayStore(tsd.images_lis, tsd.masks_lis)}
    sd = TSceneData(tload_conf(os.path.join(d, "synthetic.conf"))["dataset"])
    return {**base, "jcfg": dataclasses.replace(base["jcfg"], warm_up_end=5, **LEARN),
            "tcfg": dataclasses.replace(base["tcfg"], warm_up_end=5, **LEARN),
            "pose_all": sd.pose_all, "focal": float(sd.focal)}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return _learn_scene(str(tmp_path_factory.mktemp("torch_learned")))


def _cams(scene, moved: bool, seed: int = 9):
    """(JAX cams tree, the port's LearnedCameras) at the start of training
    or at a seeded moved state."""
    port = LearnedCameras(scene["pose_all"], scene["focal"], H, W)
    if moved:
        rng = np.random.default_rng(seed)
        with torch.no_grad():
            port.r.copy_(torch.tensor(rng.normal(scale=0.02, size=(N_IMAGES, 3)),
                                      dtype=torch.float32))
            port.t.copy_(torch.tensor(rng.normal(scale=0.02, size=(N_IMAGES, 3)),
                                      dtype=torch.float32))
            port.fx.mul_(1.01)
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    jcams = {"pose": {"r": jnp.asarray(sd["r"]), "t": jnp.asarray(sd["t"])},
             "focal": {"fx": jnp.asarray(sd["fx"])}, "init_c2w": jnp.asarray(sd["init_c2w"])}
    return jcams, port


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _compare_cams(port: LearnedCameras, jcams, tol_r=1e-4):
    got = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    want = {k: v.numpy() for k, v in from_jax_cams(jax.tree_util.tree_map(np.asarray,
                                                                          jcams)).items()}
    errs = {k: _rel_l2(got[k], want[k]) for k in ("r", "t", "fx")}
    print(f"\ncameras rel L2 vs JAX: {errs}")
    assert errs["r"] <= tol_r and errs["t"] <= 1e-4 and errs["fx"] <= 1e-4, errs


def _one_step(scene, nets, step, moved):
    jcams, cams = _cams(scene, moved)
    params = jax_params(nets)
    (jb,), (tb,) = _batches(scene, 1, seed=3)
    loss_fn = make_loss_fn(nets, scene["jcfg"], SCENE)
    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (loss, metrics), (g, gc) = fn((params, jcams), jb, step, jax.random.PRNGKey(0))
    model = port_model(nets, params)
    got = Trainer(scene["tcfg"], model, cams, None).gradients(port_nets(nets), tb, step)
    for k, v in metrics.items():
        assert abs(float(got[k]) - float(v)) <= 1e-5 * max(abs(float(v)), 1e-3), k
    assert abs(float(got["loss"]) - float(loss)) <= 1e-5 * abs(float(loss))
    grads, want = _port_grads(model), _jax_tree_as_port(g)
    assert set(grads) == set(want)
    for name in want:
        _close_rel(grads[name], want[name].reshape(grads[name].shape), 1e-4, name)
    errs = {}
    for name, got_g, want_g in (("r", cams.r.grad, gc["pose"]["r"]),
                                ("t", cams.t.grad, gc["pose"]["t"]),
                                ("fx", cams.fx.grad, gc["focal"]["fx"])):
        assert got_g is not None and got_g.shape == tuple(np.shape(want_g))
        assert float(np.abs(np.asarray(want_g)).max()) > 0, name
        errs[name] = _rel_l2(got_g.numpy(), want_g)
    print(f"\ncamera gradients rel L2 vs JAX: {errs}")
    assert all(e <= 1e-4 for e in errs.values()), errs
    # dense: the cameras the batch did not see get zero rows
    seen = int(tb["img_idx"])
    assert not cams.r.grad[[i for i in range(N_IMAGES) if i != seen]].any()


@pytest.mark.parametrize("moved", [False, True], ids=["initial_cams", "moved_cams"])
def test_one_step_with_camera_gradients_matches_jax(scene, f32_matmuls, fused, moved):
    _one_step(scene, NETS, 7, moved)


def test_wdepth_learn_step_matches_jax(tmp_path_factory, f32_matmuls, fused):
    wscene = _learn_scene(str(tmp_path_factory.mktemp("torch_learned_wdepth")), wdepth=True)
    assert wscene["tcfg"].extract_depth and wscene["tcfg"].depth_start_iter == 5
    _one_step(wscene, WDEPTH_NETS, 30, True)


def _jax_run(scene, nets, jbs, jcams, scan=False):
    params = jax_params(nets)
    state = init_state(params, scene["jcfg"], jcams, jax.random.PRNGKey(0))
    if scan:
        stacked = {k: jnp.asarray(np.stack([b[k] for b in jbs])) for k in jbs[0]}
        state, m = jax.jit(make_train_scan_step(nets, scene["jcfg"], SCENE))(state, stacked)
        return state, [float(x) for x in m["loss"]], []
    step_fn = jax.jit(make_train_step(nets, scene["jcfg"], SCENE))
    losses, cams = [], []
    for b in jbs:
        state, m = step_fn(state, b)
        losses.append(float(m["loss"]))
        cams.append(jax.tree_util.tree_map(np.asarray, state["cams"]))
    return state, losses, cams


def _check_final(state, model, cams, tol_r=1e-4):
    _compare_cams(cams, state["cams"], tol_r)
    want = _jax_tree_as_port(state["params"])
    for name, p in model.named_parameters():
        err = _rel_l2(p.detach().numpy(), want[name].reshape(p.shape))
        assert err <= 1e-4, (name, err)


def test_twenty_step_trajectory_across_the_refine_gate_matches_jax(scene, f32_matmuls, fused):
    sc = {**scene, "jcfg": dataclasses.replace(scene["jcfg"], start_refine_pose_iter=5),
          "tcfg": dataclasses.replace(scene["tcfg"], start_refine_pose_iter=5)}
    jcams, cams = _cams(sc, False)
    init = {k: v.clone() for k, v in cams.state_dict().items()}
    jbs, tbs = _batches(sc, 20, seed=4)
    state, want, jax_cams = _jax_run(sc, NETS, jbs, jcams)

    model = port_model(NETS, jax_params(NETS))
    trainer = Trainer(sc["tcfg"], model, cams, None)
    got = []
    for i, b in enumerate(tbs):
        got.append(float(trainer.step(port_nets(NETS), b, i)["loss"]))
        moved = any(not torch.equal(v, init[k]) for k, v in cams.state_dict().items())
        jax_moved = any(np.any(jax_cams[i]["pose"][k] != 0) for k in ("r", "t"))
        # the gate: no camera update through step 5 (0-based), then every step
        assert moved == jax_moved == (i > 5), i
        if i <= 5:
            assert trainer.pose_optimizer.state == {} and trainer.focal_optimizer.state == {}
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    _check_final(state, model, cams, tol_r=5e-4)
    assert float(trainer.pose_optimizer.state[cams.r]["step"]) == 14


def test_window_across_the_refine_gate_matches_jax_scan(scene, f32_matmuls):
    sc = {**scene, "jcfg": dataclasses.replace(scene["jcfg"], start_refine_pose_iter=1),
          "tcfg": dataclasses.replace(scene["tcfg"], start_refine_pose_iter=1)}
    jcams, cams = _cams(sc, True)
    jbs, tbs = _batches(sc, 4, seed=7)
    state, want, _ = _jax_run(sc, NETS, jbs, jcams, scan=True)
    model = port_model(NETS, jax_params(NETS))
    trainer = Trainer(sc["tcfg"], model, cams, None)
    got = [m["loss"] for m in StepDispatch(trainer).run(range(4), [port_nets(NETS)] * 4,
                                                          tbs).read()]
    assert [trainer.refines(s) for s in range(4)] == [False, False, True, True]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    _check_final(state, model, cams)


# ---------------------------------------------------------------------------
# the runner: pnf checkpoints, resume, renders through the learned cameras
# ---------------------------------------------------------------------------

LEARN_CONF_KEYS = ("\n    focal_learnable = True\n    poses_learnable = True"
                   "\n    start_refine_pose_iter = {refine}\n    start_refine_focal_iter = -1"
                   "\n    focal_lr = 5e-4\n    pose_lr = 5e-4\n    focal_lr_gamma = 0.9"
                   "\n    pose_lr_gamma = 0.9\n    step_size = 5000")


def _learn_conf(d, name, end_iter, save_freq, refine=-1, perturb=1.0) -> str:
    """The synthetic conf with the learn confs' camera keys."""
    path = os.path.join(d, f"{name}.conf")
    write_synthetic_conf(path, data_dir=d, exp_dir=os.path.join(d, name), end_iter=end_iter,
                         batch_size=32, save_freq=save_freq)
    with open(path) as f:
        text = f.read()
    for old, new in (("extract_depth = False",
                      "extract_depth = False" + LEARN_CONF_KEYS.format(refine=refine)),
                     ("perturb = 1.0", f"perturb = {perturb}")):
        text, n = re.subn(re.escape(old), new, text)
        assert n == 1, old
    with open(path, "w") as f:
        f.write(text)
    return path


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("learned_runs"))
    make_synthetic_scene(d, n_images=3, H=24, W=32)
    return d


def test_runner_writes_a_pnf_checkpoint_the_jax_importer_reads(run_dir):
    from vdnerf_tpu.io.checkpoints import import_torch_pnf_checkpoint
    from vdnerf_tpu_torch.cli import main
    from vdnerf_tpu_torch.runner import Runner

    conf = _learn_conf(run_dir, "pnf", end_iter=6, save_freq=3, refine=2)
    summary = main(["--conf", conf, "--mode", "train"], device="cpu")
    assert summary is not None and all(np.isfinite(v) for v in summary.values())
    pnf_dir = os.path.join(run_dir, "pnf", "pnf_checkpoints")
    assert sorted(os.listdir(pnf_dir)) == ["pnf_000003.pth", "pnf_000006.pth"]
    cams = {}
    for it in (3, 6):
        jcams, poses_iter = import_torch_pnf_checkpoint(
            os.path.join(pnf_dir, f"pnf_{it:06d}.pth"))
        assert poses_iter == it
        cams[it] = {k: v.numpy() for k, v in from_jax_cams(
            jax.tree_util.tree_map(np.asarray, jcams)).items()}
    # before the gate (steps 0-2) nothing moved; by step 6 r, t and fx did
    runner = Runner(conf, mode="valimg", device="cpu")
    init = {k: v.detach().numpy() for k, v in runner.cams.state_dict().items()}
    assert all(np.array_equal(cams[3][k], init[k]) for k in init)
    assert all(not np.array_equal(cams[6][k], init[k]) for k in ("r", "t", "fx"))
    np.testing.assert_array_equal(cams[6]["init_c2w"], init["init_c2w"])
    # the camera Adams ride along in keys the importer ignores
    saved = torch.load(os.path.join(pnf_dir, "pnf_000006.pth"), weights_only=True)
    assert saved["optimizer_pose"]["state"] and saved["optimizer_focal"]["state"]
    # valimg_6 renders through the saved cameras: the run's closing summary
    served = main(["--conf", conf, "--mode", "valimg_6"], device="cpu")
    assert max(abs(served[k] - summary[k]) for k in summary) <= 1e-6


def test_resume_continues_the_cameras_and_their_adams(run_dir):
    from vdnerf_tpu_torch.runner import Runner

    conf = _learn_conf(run_dir, "resume", end_iter=6, save_freq=3, perturb=0.0)
    first = Runner(conf, mode="train", device="cpu")
    rng = np.random.default_rng(2)
    batches = [first.store.sample_pixels(s % 3, 32, rng) for s in range(6)]
    for s in range(3):
        first.trainer.step(first.nets, batches[s], s)
    first.iter_step = 3
    first.save_checkpoint()
    resumed = Runner(conf, mode="train", device="cpu", is_continue=True)
    assert resumed.iter_step == 3
    for s in range(3, 6):
        first.trainer.step(first.nets, batches[s], s)
        resumed.trainer.step(resumed.nets, batches[s], s)
    for (name, p), q in zip(first.cams.named_parameters(), resumed.cams.parameters()):
        assert torch.equal(p, q), name
    for (name, p), q in zip(first.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(p, q), name
    for oa, ob in zip(first.trainer.camera_optimizers(), resumed.trainer.camera_optimizers()):
        for p, q in zip(oa.param_groups[0]["params"], ob.param_groups[0]["params"]):
            for k in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(oa.state[p][k], ob.state[q][k]), k


def test_valimg_from_a_jax_learned_checkpoint_matches_jax_cli(run_dir, f32_matmuls, capsys):
    from vdnerf_tpu.cli import main as jax_main
    from vdnerf_tpu.runner import Runner as JRunner
    from vdnerf_tpu_torch.cli import main as port_main

    conf = _learn_conf(run_dir, "jaxckpt", end_iter=6, save_freq=3)
    runner = JRunner(conf, mode="valimg_7", seed=3)
    rng = np.random.default_rng(11)
    cams = runner.state["cams"]
    runner.state["cams"] = dict(
        cams, pose={"r": jnp.asarray(rng.normal(scale=0.03, size=(3, 3)), jnp.float32),
                    "t": jnp.asarray(rng.normal(scale=0.03, size=(3, 3)), jnp.float32)},
        focal={"fx": cams["focal"]["fx"] * 1.02})
    runner.state["step"] = jnp.asarray(7, jnp.int32)
    runner.save_checkpoint()
    argv = ["--conf", conf, "--mode", "valimg_7"]
    capsys.readouterr()
    jax_main(argv)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    want = ast.literal_eval(lines[-1])
    got = port_main(argv, device="cpu")
    assert set(got) == set(want)
    for key in ("psnr", "psnr_unmasked"):
        assert abs(got[key] - want[key]) <= 0.01, (key, got[key], want[key])
    for key in ("l1", "l1_unmasked"):
        assert abs(got[key] - want[key]) <= 1e-4, (key, got[key], want[key])
    # and the cameras did matter: the initial ones render another image
    from vdnerf_tpu_torch.runner import Runner

    fixed = Runner(conf, mode="valimg", device="cpu")
    fixed.load_checkpoint_iter(7)
    fixed.cams.load_state_dict({**fixed.cams.state_dict(),
                                "r": torch.zeros(3, 3), "t": torch.zeros(3, 3)})
    assert abs(fixed.val_all_imgs(2, both_mask=True)["psnr"] - got["psnr"]) > 1e-3
