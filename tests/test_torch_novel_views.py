"""The port's novel-view and camera-pose modes against vdnerf_tpu.

A synthetic sphere scene (3 views of 32x40) and its conf at small widths
with the ``womsk_white_tpu`` renderer features (``skip_bg_inside``, the
24-of-48 resampled core), once with fixed cameras and once with the learn
confs' camera keys. The JAX runner writes ``ckpt_000007.npz`` (for the
learned conf with moved poses and focal); the port loads it and writes the
``.pth`` (and ``pnf_000007.pth``) its ``-c`` resumes. Both sides' fused-MLP
operands run in f32 (``f32_matmuls``).

Tolerances:

- ``interpolate_pose`` and ``rays_between`` at 5 ratios: 1e-5;
- ``render_between`` colour, fixed and learned cameras: 1e-4, the f32
  tolerance of the whole render (``test_torch_render.py``): fed JAX's own
  rays, the port's render differs from JAX's by up to 8e-5 on a few rays
  (the ladder's data-dependent sample positions amplify f32 summation
  order), so this is the renderer's gap and not the sweep's, whose rays
  agree within 1e-5;
- ``interpolate_frames`` (2 frames): the uint8 frames equal on at least
  99.9% of the values and never more than 1 level apart (a colour within
  f32 noise of a level boundary may round the other way);
- ``interpolate_0_1 -c`` through both CLIs: videos with the same number of
  frames of the same size, decoded (codec bytes differ between cv2 builds);
- ``showcam_7``: the npz keys of JAX's, ``init_c2w`` and ``gt_c2w`` within
  1e-6, ``learned_c2w`` and ``learned_K`` within 1e-5; the PNG non-empty;
- ``frustum_corners``: 1e-12.
"""

from __future__ import annotations

import functools
import os
import re

import cv2 as cv
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import f32_matmuls, one_torch_thread  # noqa: F401
from vdnerf_tpu.data.synthetic import make_synthetic_scene, write_synthetic_conf

N_IMAGES, H, W, IT = 3, 32, 40, 7
LEARN_KEYS = ("\n    focal_learnable = True\n    poses_learnable = True"
              "\n    start_refine_pose_iter = -1\n    start_refine_focal_iter = -1"
              "\n    focal_lr = 5e-4\n    pose_lr = 5e-4\n    focal_lr_gamma = 0.9"
              "\n    pose_lr_gamma = 0.9\n    step_size = 5000")


def _conf(d: str, name: str, learn: bool) -> str:
    path = os.path.join(d, f"{name}.conf")
    write_synthetic_conf(path, data_dir=d, exp_dir=os.path.join(d, name), batch_size=64)
    with open(path) as f:
        text = f.read()
    subs = [("perturb = 1.0", "perturb = 1.0\n        skip_bg_inside = True"
             "\n        n_render_samples = 24\n        resample_uniform_frac = 1.0")]
    if learn:
        subs.append(("extract_depth = False", "extract_depth = False" + LEARN_KEYS))
    for old, new in subs:
        text, n = re.subn(re.escape(old), new, text)
        assert n == 1, old
    with open(path, "w") as f:
        f.write(text)
    return path


def _setup(d: str, name: str, learn: bool) -> dict:
    """The JAX runner's ckpt_000007.npz, and the port runner loaded from it,
    which writes the .pth (and pnf) that the port's -c resumes."""
    from vdnerf_tpu.runner import Runner as JRunner
    from vdnerf_tpu_torch.io.checkpoints import (
        checkpoint_path,
        pnf_path,
        save_pnf_checkpoint,
        save_training_checkpoint,
    )
    from vdnerf_tpu_torch.runner import Runner

    conf = _conf(d, name, learn)
    jrunner = JRunner(conf, mode=f"valimg_{IT}", seed=3)
    if learn:
        rng = np.random.default_rng(11)
        cams = jrunner.state["cams"]
        jrunner.state["cams"] = dict(
            cams,
            pose={"r": jnp.asarray(rng.normal(scale=0.03, size=(N_IMAGES, 3)), jnp.float32),
                  "t": jnp.asarray(rng.normal(scale=0.03, size=(N_IMAGES, 3)), jnp.float32)},
            focal={"fx": cams["focal"]["fx"] * 1.02})
    jrunner.state["step"] = jnp.asarray(IT, jnp.int32)
    jrunner.save_checkpoint()
    port = Runner(conf, mode="interpolate", device="cpu")
    port.load_checkpoint_iter(IT)
    base = os.path.join(d, name)
    save_training_checkpoint(checkpoint_path(base, IT), port.model, IT)
    if learn:
        save_pnf_checkpoint(pnf_path(base, IT), port.cams, IT)
    return {"conf": conf, "jax": jrunner, "port": port, "exp": base}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("novel_views"))
    make_synthetic_scene(d, n_images=N_IMAGES, H=H, W=W)
    return {"fixed": _setup(d, "fixed", False), "learned": _setup(d, "learned", True)}


@pytest.mark.parametrize("ratio", [0.0, 0.2, 0.5, 0.8, 1.0])
def test_interpolate_pose_and_rays_between_match_jax(runs, ratio):
    from vdnerf_tpu.data import cameras as jcam
    from vdnerf_tpu_torch.data import cameras as tcam

    sd = runs["fixed"]["port"].scene_data
    p0, p1, k_inv = sd.pose_all[0], sd.pose_all[2], sd.intrinsics_all_inv[0]
    want = np.asarray(jcam.interpolate_pose(jnp.asarray(p0), jnp.asarray(p1), ratio))
    got = tcam.interpolate_pose(torch.from_numpy(p0), torch.from_numpy(p1), ratio)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    if ratio in (0.0, 1.0):
        np.testing.assert_allclose(got.numpy(), (p0, p1)[int(ratio)], atol=1e-5, rtol=0)
    jo, jd = jcam.rays_between(jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(k_inv), ratio,
                               H, W, 4)
    to, td = tcam.rays_between(torch.from_numpy(p0), torch.from_numpy(p1),
                               torch.from_numpy(k_inv), ratio, H, W, 4)
    assert to.shape == td.shape == (H // 4, W // 4, 3)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["fixed", "learned"])
def test_render_between_matches_jax(runs, kind, f32_matmuls):
    run = runs[kind]
    jr, port = run["jax"], run["port"]
    want = np.asarray(jr.renderer.render_between(jr.state["params"], jr.state["cams"], 0, 1,
                                                 0.3, 2, IT))
    poses, intrin_inv = port.resolved_cams()
    got = port.renderer.render_between(port.model, poses, intrin_inv, 0, 1, 0.3, 2, IT)
    assert got.shape == want.shape == (H // 2, W // 2, 3)
    err = float(np.abs(got - want).max())
    print(f"\n{kind}: render_between colour max abs err {err:.3e}")
    assert err <= 1e-4, err
    if kind == "learned":
        # the learned cameras mattered: the initial ones render another image
        plain = port.renderer.render_between(port.model, port.scene_data.pose_all,
                                             port.scene_data.intrinsics_all_inv, 0, 1, 0.3, 2,
                                             IT)
        assert np.abs(plain - got).max() > 1e-3


def test_interpolate_frames_match_jax(runs, f32_matmuls):
    from vdnerf_tpu.train.validate import interpolate_frames as jax_frames
    from vdnerf_tpu_torch.train.validate import interpolate_frames

    run = runs["fixed"]
    jr, port = run["jax"], run["port"]
    want = jax_frames(jr.renderer, jr.state["params"], jr.state["cams"], 0, 1, n_frames=2,
                      resolution_level=4, step=IT)
    got = interpolate_frames(port.renderer, port.model, *port.resolved_cams(), 0, 1, n_frames=2,
                             resolution_level=4, step=IT)
    assert len(got) == len(want) == 4
    assert got[0] is got[3] and got[1] is got[2]
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == w.shape == (H // 4, W // 4, 3)
        diff = np.abs(g.astype(int) - w.astype(int))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, (diff.max(), (diff == 0).mean())


def _read_video(path: str) -> list[np.ndarray]:
    cap = cv.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames


def test_cli_interpolate_writes_the_jax_video(runs, f32_matmuls, monkeypatch):
    import vdnerf_tpu.runner as jrunner_mod
    from vdnerf_tpu.cli import main as jax_main
    from vdnerf_tpu_torch.cli import main as port_main

    run = runs["fixed"]
    argv = ["--conf", run["conf"], "--mode", "interpolate_0_1", "-c"]
    # the JAX renderer pads every chunk to 4096 rays; 80 rays a frame do
    monkeypatch.setattr(jrunner_mod, "ImageRenderer",
                        functools.partial(jrunner_mod.ImageRenderer, chunk=80))
    path = os.path.join(run["exp"], "render", f"{IT:08d}_0_1.mp4")
    jax_main(argv)
    want = _read_video(path)
    os.remove(path)
    assert port_main(argv, device="cpu") == path
    got = _read_video(path)
    assert len(got) == len(want) == 120
    assert got[0].shape == want[0].shape == (H // 4, W // 4, 3)


@pytest.mark.parametrize("kind", ["fixed", "learned"])
def test_showcam_matches_jax(runs, kind):
    from vdnerf_tpu.cli import main as jax_main
    from vdnerf_tpu_torch.cli import main as port_main

    run = runs[kind]
    argv = ["--conf", run["conf"], "--mode", f"showcam_{IT}"]
    path = os.path.join(run["exp"], "cam_poses", f"pose_{IT:06d}.npz")
    jax_main(argv)
    with np.load(path) as f:
        want = dict(f)
    os.remove(path)
    assert port_main(argv, device="cpu") == path
    with np.load(path) as f:
        got = dict(f)
    keys = {"init_c2w", "gt_c2w"} | ({"learned_c2w", "learned_K"} if kind == "learned" else set())
    assert set(got) == set(want) == keys
    for key in keys:
        tol = 1e-5 if key.startswith("learned") else 1e-6
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], atol=tol, rtol=0, err_msg=key)
    assert got["init_c2w"].shape == (N_IMAGES, 4, 4)
    png = cv.imread(path.replace(".npz", ".png"))
    assert png is not None and png.ndim == 3 and png.shape[2] == 3 and (png < 250).any()
    if kind == "learned":
        assert np.abs(got["learned_c2w"] - got["init_c2w"]).max() > 1e-3
        # bare showcam on what -c resumed: the same dump
        os.remove(path)
        port_main(["--conf", run["conf"], "--mode", "showcam", "-c"], device="cpu")
        with np.load(path) as f:
            again = dict(f)
        assert all(np.array_equal(again[k], got[k]) for k in keys)


def test_gt_poses_by_index_and_without_scale_mat(runs, tmp_path):
    port = runs["fixed"]["port"]
    sd = port.scene_data
    stems = [os.path.splitext(os.path.basename(f))[0] for f in sd.images_lis]
    cams = sd.camera_dict
    by_index = {f"world_mat_{i}": cams[f"world_mat_{s}"] @ cams[f"scale_mat_{s}"]
                for i, s in enumerate(stems)}
    np.savez(tmp_path / "by_index.npz", **by_index)
    np.testing.assert_allclose(port.get_gt_poses(str(tmp_path / "by_index.npz")), sd.pose_all,
                               atol=1e-5, rtol=0)
    np.savez(tmp_path / "short.npz", world_mat_0=by_index["world_mat_0"])
    assert port.get_gt_poses(str(tmp_path / "short.npz")) is None
    assert port.get_gt_poses(str(tmp_path / "missing.npz")) is None


def test_frustum_corners_match_jax():
    from scipy.spatial.transform import Rotation

    from vdnerf_tpu.utils.camvis import frustum_corners as jax_corners
    from vdnerf_tpu_torch.utils.camvis import frustum_corners

    rng = np.random.default_rng(5)
    for _ in range(5):
        c2w = np.eye(4)
        c2w[:3, :3] = Rotation.from_rotvec(rng.normal(size=3)).as_matrix()
        c2w[:3, 3] = rng.normal(size=3) * 3
        got = frustum_corners(c2w, 300, 400, 350.0, 0.4)
        assert got.shape == (5, 3)
        np.testing.assert_allclose(got, jax_corners(c2w, 300, 400, 350.0, 0.4), atol=1e-12,
                                   rtol=0)


def test_plot_cam_poses_draws_each_set_in_its_colour(tmp_path):
    from vdnerf_tpu_torch.utils.camvis import COLORS, plot_cam_poses

    poses = np.stack([np.eye(4)] * 2)
    poses[1, :3, 3] = [1.0, 0.5, 0.0]
    path = plot_cam_poses(str(tmp_path / "p.png"), {"init": poses, "learned": poses + 0.1,
                                                   "gt": poses - 0.1}, 30, 40, 35.0)
    img = cv.imread(path)
    assert img.shape == (1080, 1080, 3)
    for color in COLORS.values():
        assert (np.abs(img.astype(int) - color).sum(-1) == 0).sum() > 50, color
    assert (img.sum(-1) == 0).any()  # the origin marker


def test_write_video_raises_when_the_writer_cannot_open(tmp_path):
    from vdnerf_tpu_torch.train.validate import write_video

    frames = [np.zeros((8, 10, 3), np.uint8)] * 2
    with pytest.raises(RuntimeError, match="could not open"):
        write_video(str(tmp_path / "clip.notavideo"), frames)
    write_video(str(tmp_path / "clip.mp4"), frames)
    assert len(_read_video(str(tmp_path / "clip.mp4"))) == 2
