"""``vdnerf_tpu_torch.tools.vdn_cycle_run`` against ``tools/vdn_cycle_run.py``.

The JAX tool is loaded by path (``torch_vdn_cycle.jax_tool``); nothing of it
changes. Held:

- the ``.conf`` text: both tools write the same bytes, and each package's
  hocon parses them to the same tree, for the base leg, wdepth, wdepth with
  the resampled core and ``resample_from``, learn, learn with wdepth, and
  the ``lr_end_iter``, ``depth_start_iter``, ``anneal_end``/``warm_up_end``
  and ``igr_weight`` overrides;
- ``make_noisy_cameras``: both npz files array-equal to JAX's, and the
  returned poses and world matrices;
- ``pose_recovery_stats`` within 1e-6 of JAX's on cameras carried across by
  ``from_jax_cams``, before the reports' rounding, the angles in radians
  (the f32 learned rotations differ by a few ulps: measured 2.6e-7 rad on
  the rotation errors, under 1e-8 on the rest);
- on a 4-view 32^2 compound scene with small nets, JAX's runner writes
  ``ckpt_000010.npz`` and the port's runner loads it (fixed cameras, and a
  learnable conf with moved poses and focal); with both sides' fused-MLP
  operands in f32 and deterministic renders: ``object_masked_psnr`` within
  0.01 dB and its eikonal within 1e-4 relative (measured 3e-7 dB and 4e-7);
  ``depth_export_qc`` with and without a similarity: the view count equal,
  every statistic within 1e-4 relative (measured at most 2.3e-6, the
  median; the argmax-weight depth can flip between near-equal weights on a
  few rays, ROADMAP §3, which these renders do not show); ``geometry_qc``
  at 48^3 with and without a similarity: Chamfer within 1e-4 of JAX's
  (5,000 surface samples a side; measured 4e-6), the vertex counts within
  1% (measured equal);
- the tool refuses to run without CUDA unless given ``device="cpu"``, and
  refuses a reused ``--out``, before it writes anything.
"""

from __future__ import annotations

import functools
import os
import shutil
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import f32_matmuls, one_torch_thread  # noqa: F401
from torch_vdn_cycle import jax_tool, shrink
from vdnerf_tpu.utils.hocon import load_conf as jax_load_conf
from vdnerf_tpu_torch.data.cameras import LearnedCameras
from vdnerf_tpu_torch.data.synthetic import make_compound_scene
from vdnerf_tpu_torch.io.checkpoints import from_jax_cams
from vdnerf_tpu_torch.tools import vdn_cycle_run as port_tool
from vdnerf_tpu_torch.utils.hocon import load_conf as port_load_conf

N_VIEWS, RES, IT = 4, 32, 10

CONF_CASES = {
    "base": dict(wdepth=False),
    "wdepth": dict(wdepth=True, depth_weight_scale=10.0),
    "wdepth_resample": dict(wdepth=True, render_samples=96, resample_frac=1.0,
                            resample_from=4170),
    "learn": dict(wdepth=False, learn=True, cam_npz="cameras_sphere_noisy.npz"),
    "learn_wdepth": dict(wdepth=True, learn=True, cam_npz="cameras_sphere_noisy.npz",
                         dpt_dim=32),
    "lr_end_iter": dict(wdepth=True, lr_end_iter=12000, igr_weight=1.0),
    "depth_start_iter": dict(wdepth=True, depth_start_iter=1200),
    "anneal_warm_up": dict(wdepth=True, anneal_end=3000, warm_up_end=240),
    "resample_no_from": dict(wdepth=True, render_samples=64),
}


@pytest.fixture(scope="module")
def jtool():
    return jax_tool()


@pytest.mark.parametrize("case", list(CONF_CASES))
def test_conf_text_and_tree_equal_the_jax_tools(jtool, tmp_path, case):
    kw = CONF_CASES[case]
    paths = []
    for name, m in (("jax", jtool), ("port", port_tool)):
        paths.append(m.write_conf_file(str(tmp_path / f"{name}.conf"), "/x/exp", "/x/scene",
                                       12000, 512, **kw))
    texts = [open(p).read() for p in paths]
    assert texts[0] == texts[1]
    jtree = jax_load_conf(paths[0]).to_dict()
    ptree = port_load_conf(paths[1]).to_dict()
    assert jtree == ptree
    assert ("depth_extract_network" in ptree["model"]) is kw["wdepth"]
    assert "bf16" not in ptree["train"]  # the policy reaches the runners through VDNERF_BF16


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("vdn_cycle_scene"))
    make_compound_scene(d, n_images=N_VIEWS, H=RES, W=RES, background="textured",
                        shading="camlight")
    return d


def test_noisy_cameras_equal_the_jax_tools(jtool, scene, tmp_path):
    dirs = {k: str(tmp_path / k) for k in ("jax", "port")}
    for d in dirs.values():
        shutil.copytree(scene, d)
    want = jtool.make_noisy_cameras(dirs["jax"])
    got = port_tool.make_noisy_cameras(dirs["port"])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for rel in ("image/cameras_sphere_noisy.npz", "cameras_sphere_noisy.npz"):
        with np.load(os.path.join(dirs["jax"], rel)) as a, \
                np.load(os.path.join(dirs["port"], rel)) as b:
            assert sorted(a.files) == sorted(b.files) and len(a.files) == 2 * N_VIEWS
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])


def test_pose_recovery_stats_match_the_jax_tools(jtool, scene, monkeypatch):
    # compared before the reports' rounding (4-5 decimals)
    for m in (jtool, port_tool):
        monkeypatch.setattr(m, "round", lambda x, n=None: x, raising=False)
    rng = np.random.default_rng(3)
    sd = port_tool.SceneData(port_tool.Config({
        "data_dir": scene, "img_dir": "image", "depth_dir": "00",
        "render_cameras_name": "image/cameras_sphere.npz",
        "object_cameras_name": "image/cameras_sphere.npz"}))
    gt = np.asarray(sd.pose_all, np.float64)
    noisy = port_tool.perturb_poses(gt, np.random.default_rng(5)).astype(np.float32)
    jcams = {"pose": {"r": rng.normal(scale=0.02, size=(N_VIEWS, 3)).astype(np.float32),
                      "t": rng.normal(scale=0.02, size=(N_VIEWS, 3)).astype(np.float32)},
             "focal": {"fx": np.float32(1.3)}, "init_c2w": noisy}
    jrunner = types.SimpleNamespace(state={"cams": {
        "pose": {k: jnp.asarray(v) for k, v in jcams["pose"].items()},
        "init_c2w": jnp.asarray(noisy)}})
    cams = LearnedCameras(noisy, float(sd.focal), RES, RES)
    cams.load_state_dict(from_jax_cams(jcams))
    want, (s_w, R_w, t_w) = jtool.pose_recovery_stats(jrunner, gt)
    got, (s_g, R_g, t_g) = port_tool.pose_recovery_stats(types.SimpleNamespace(cams=cams), gt)
    assert set(got) == set(want)
    for k in want:
        # angles in radians: the f32 learned rotations differ by a few ulps
        # (measured 2.6e-7 rad, 1.5e-5 degrees)
        scale = np.pi / 180 if k.endswith("_deg") else 1.0
        assert abs(got[k] - want[k]) * scale <= 1e-6, (k, got[k], want[k])
    assert got["init_rot_err_deg"] > 0.5 and got["raw_rot_err_deg"] > 0.5
    assert s_g == pytest.approx(s_w, abs=1e-6)
    np.testing.assert_allclose(R_g, R_w, atol=1e-6)
    np.testing.assert_allclose(t_g, t_w, atol=1e-6)


def _runners(jtool, scene: str, root: str, learn: bool):
    """JAX's eval runner, which writes ckpt_000010.npz (with moved cameras
    for a learnable conf), and the port's, loaded from it."""
    from vdnerf_tpu.runner import Runner as JRunner
    from vdnerf_tpu_torch.runner import Runner

    name = "learn" if learn else "fixed"
    conf = port_tool.write_conf_file(os.path.join(root, f"{name}.conf"),
                                     os.path.join(root, f"exp_{name}"), scene, IT, 64, False,
                                     learn=learn)
    jr = JRunner(conf, mode="eval", seed=3)
    if learn:
        rng = np.random.default_rng(11)
        cams = jr.state["cams"]
        jr.state["cams"] = dict(
            cams,
            pose={"r": jnp.asarray(rng.normal(scale=0.03, size=(N_VIEWS, 3)), jnp.float32),
                  "t": jnp.asarray(rng.normal(scale=0.03, size=(N_VIEWS, 3)), jnp.float32)},
            focal={"fx": cams["focal"]["fx"] * 1.02})
    jr.state["step"] = jnp.asarray(IT, jnp.int32)
    jr.save_checkpoint()
    port = Runner(conf, mode="eval", device="cpu")
    port.load_checkpoint_iter(IT)
    return jr, port


@pytest.fixture(scope="module")
def runners(jtool, scene, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vdn_cycle_runners"))
    with pytest.MonkeyPatch.context() as mp:
        shrink(mp, jtool, port_tool)
        return {k: _runners(jtool, scene, root, k == "learn") for k in ("fixed", "learn")}


# a similarity of the kind pose_recovery_stats returns (learned -> true frame)
SIM = (1.02, np.array([[0.9998, -0.0175, 0.0087], [0.0176, 0.9998, -0.0052],
                       [-0.0086, 0.0054, 0.9999]]), np.array([0.01, -0.02, 0.015]))


def _orthonormal(R):
    u, _, vt = np.linalg.svd(R)
    return u @ vt


SIM = (SIM[0], _orthonormal(SIM[1]), SIM[2])


@pytest.mark.parametrize("kind", ["fixed", "learn"])
def test_object_masked_psnr_matches_the_jax_tools(jtool, scene, runners, kind, f32_matmuls):
    jr, port = runners[kind]
    want = jtool.object_masked_psnr(jr, scene)
    got = port_tool.object_masked_psnr(port, scene)
    assert got[0] == pytest.approx(want[0], abs=0.01)
    assert got[1] == pytest.approx(want[1], rel=1e-4)


@pytest.mark.parametrize("kind,sim", [("fixed", None), ("fixed", SIM), ("learn", SIM)])
def test_depth_export_qc_matches_the_jax_tools(jtool, scene, runners, kind, sim, f32_matmuls):
    jr, port = runners[kind]
    jtool._GEOMETRY = "compound"
    want = jtool.depth_export_qc(jr, scene, sim=sim)
    got = port_tool.depth_export_qc(port, scene, "compound", sim=sim)
    assert set(got) == set(want) and got["n_views"] == want["n_views"] > 0
    assert got["res_level"] == want["res_level"] == 2
    for k in ("abs_mean", "abs_median", "abs_p95", "rel_mean"):
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-5), k


@pytest.mark.parametrize("sim", [None, SIM], ids=["no_sim", "sim"])
def test_geometry_qc_matches_the_jax_tools(jtool, scene, runners, sim, f32_matmuls,
                                          monkeypatch):
    from vdnerf_tpu.mesh import qc as jax_qc

    # the Chamfer's surface samples: 5,000 a side (100,000 in the tools)
    for m, fn in ((jax_qc, jax_qc.geometry_qc), (port_tool, port_tool.run_qc)):
        monkeypatch.setattr(m, "geometry_qc" if m is jax_qc else "run_qc",
                            functools.partial(fn, n_points=5000))
    jr, port = runners["fixed"]
    jtool._GEOMETRY = "compound"
    world_mats = None
    if sim is not None:
        world_mats = np.stack(port.scene_data.world_mats_np)
    want = jtool.geometry_qc(jr, scene, 48, sim=sim, world_mats=world_mats)
    got = port_tool.geometry_qc(port, scene, "compound", 48, sim=sim, world_mats=world_mats)
    assert set(got) == set(want)
    assert set(got["clean"]) == set(want["clean"])
    assert got["n_verts"] == pytest.approx(want["n_verts"], rel=1e-2)
    assert got["chamfer"] == pytest.approx(want["chamfer"], abs=1e-4)
    assert got["mesh_res"] == 48


SMALL_RUN = ["--iters", "10", "--views", "3", "--img-res", "32", "--wavelet-epochs", "1",
             "--encoder", "mobilenet_light", "--mesh-res", "16", "--batch", "32"]


def test_tool_refuses_to_run_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_tool.main(SMALL_RUN + ["--out", str(out)])
    assert not out.exists()


@pytest.mark.parametrize("stale", ["exp_base", "exp_wdepth", "wavelet_log", "arch"])
def test_tool_refuses_a_reused_out(tmp_path, stale):
    (tmp_path / stale).mkdir()
    before = sorted(os.listdir(tmp_path))
    geometry = ["--geometry", "arch"] if stale == "arch" else []
    with pytest.raises(SystemExit, match="already contains"):
        port_tool.main(SMALL_RUN + geometry + ["--out", str(tmp_path)], device="cpu")
    assert sorted(os.listdir(tmp_path)) == before
    assert not os.listdir(tmp_path / stale)


def test_learn_refuses_cycle2_and_eik_boost(tmp_path):
    for mode in (["--cycle2"], ["--eik-boost", "1.0"]):
        with pytest.raises(SystemExit, match="--learn composes"):
            port_tool.main(SMALL_RUN + ["--learn", "--out", str(tmp_path)] + mode,
                           device="cpu")
    assert not os.listdir(tmp_path)
