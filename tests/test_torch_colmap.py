"""The port's COLMAP preparation (``vdnerf_tpu_torch.colmap``) against
``vdnerf_tpu.colmap`` on generated sparse models.

Each test writes its own COLMAP model (binary, or text) of a ring of cameras
around a point cloud, with a copy of the writer in ``tests/test_colmap.py``,
and runs both packages on copies of it:

- every record of ``read_model`` (cameras, images, points3D; binary and
  text) equals JAX's, field for field;
- ``load_colmap_data`` equals JAX's; ``save_poses`` writes byte-equal
  ``poses.npy`` and ``sparse_points.ply``; ``gen_cameras`` an npz whose every
  array equals JAX's; ``gen_poses`` with ``minify`` writes equal images;
- ``run_colmap`` raises without the binary;
- capture to training: the port's two CLIs, then the port's ``Runner``
  trains a few steps at small widths on the npz they wrote.
"""

from __future__ import annotations

import json
import os
import shutil
import struct

import cv2 as cv
import numpy as np
import pytest

from torch_parity import one_torch_thread  # noqa: F401
from vdnerf_tpu.colmap import pipeline as jpipe
from vdnerf_tpu.colmap import read_model as jread
from vdnerf_tpu.data.synthetic import look_at_pose
from vdnerf_tpu_torch.colmap import pipeline as tpipe
from vdnerf_tpu_torch.colmap import read_model as tread

N_VIEWS, F, W, H = 6, 420.0, 64, 48


def write_colmap_binary(sparse_dir, poses_c2w, f, W, H, points):
    """cameras.bin (one SIMPLE_PINHOLE), images.bin (one keypoint each, the
    names 000.png...), points3D.bin (each seen by image 1)."""
    os.makedirs(sparse_dir, exist_ok=True)
    with open(os.path.join(sparse_dir, "cameras.bin"), "wb") as fo:
        fo.write(struct.pack("<Q", 1))
        fo.write(struct.pack("<iiQQ", 1, 0, W, H))
        fo.write(struct.pack("<3d", f, W / 2, H / 2))
    with open(os.path.join(sparse_dir, "images.bin"), "wb") as fo:
        fo.write(struct.pack("<Q", len(poses_c2w)))
        for i, c2w in enumerate(poses_c2w):
            w2c = np.linalg.inv(c2w)
            fo.write(struct.pack("<i", i + 1))
            fo.write(struct.pack("<4d", *tread.rotmat2qvec(w2c[:3, :3])))
            fo.write(struct.pack("<3d", *w2c[:3, 3]))
            fo.write(struct.pack("<i", 1))
            fo.write(f"{i:03d}.png".encode() + b"\x00")
            fo.write(struct.pack("<Q", 1))
            fo.write(struct.pack("<2dq", 10.5 + i, 20.25, i % 3))
    with open(os.path.join(sparse_dir, "points3D.bin"), "wb") as fo:
        fo.write(struct.pack("<Q", len(points)))
        for j, p in enumerate(points):
            fo.write(struct.pack("<Q", j + 1))
            fo.write(struct.pack("<3d", *p))
            fo.write(struct.pack("<3B", 128, 64 + j % 64, 32))
            fo.write(struct.pack("<d", 0.5 + 0.01 * j))
            fo.write(struct.pack("<Q", 2))
            fo.write(struct.pack("<iiii", 1, j, 2, j + 1))


def write_colmap_text(sparse_dir, poses_c2w, f, W, H, points):
    """The same model in COLMAP's text format."""
    os.makedirs(sparse_dir, exist_ok=True)
    with open(os.path.join(sparse_dir, "cameras.txt"), "w") as fo:
        fo.write("# Camera list\n")
        fo.write(f"1 SIMPLE_PINHOLE {W} {H} {f!r} {W / 2!r} {H / 2!r}\n")
    with open(os.path.join(sparse_dir, "images.txt"), "w") as fo:
        fo.write("# Image list with two lines of data per image\n")
        for i, c2w in enumerate(poses_c2w):
            w2c = np.linalg.inv(c2w)
            q = tread.rotmat2qvec(w2c[:3, :3])
            vals = " ".join(repr(float(v)) for v in (*q, *w2c[:3, 3]))
            fo.write(f"{i + 1} {vals} 1 {i:03d}.png\n")
            fo.write(f"{10.5 + i!r} 20.25 {i % 3} 3.0 4.5 -1\n")
    with open(os.path.join(sparse_dir, "points3D.txt"), "w") as fo:
        fo.write("# 3D point list\n")
        for j, p in enumerate(points):
            xyz = " ".join(repr(float(v)) for v in p)
            fo.write(f"{j + 1} {xyz} 128 {64 + j % 64} 32 {0.5 + 0.01 * j!r} 1 {j} 2 {j + 1}\n")


def ring_poses(n: int = N_VIEWS) -> list[np.ndarray]:
    poses = []
    for i in range(n):
        th = 2 * np.pi * i / n
        eye = 3.0 * np.array([np.cos(th), np.sin(th), 0.3 + 0.1 * (i % 2)])
        poses.append(look_at_pose(eye, np.zeros(3)).astype(np.float64))
    return poses


def cloud(n: int = 150, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, 3)) * 0.4


@pytest.fixture
def model_dir(tmp_path):
    """A scene dir with a binary sparse/0 and four RGB images under images/."""
    d = tmp_path / "scene"
    write_colmap_binary(str(d / "sparse" / "0"), ring_poses(), F, W, H, cloud())
    rng = np.random.default_rng(3)
    os.makedirs(d / "images")
    for i in range(4):
        cv.imwrite(str(d / "images" / f"{i:03d}.png"),
                   rng.integers(0, 256, size=(H, W, 3), dtype=np.uint8))
    return d


def _copy(src, dst) -> str:
    shutil.copytree(src, dst)
    return str(dst)


def _records_equal(got: dict, want: dict):
    assert list(got) == list(want)
    for key in want:
        g, w = got[key], want[key]
        assert type(g).__name__ == type(w).__name__ and g._fields == w._fields
        for field, gv, wv in zip(w._fields, g, w):
            if isinstance(wv, np.ndarray):
                assert gv.dtype == wv.dtype and np.array_equal(gv, wv), (key, field)
            else:
                assert gv == wv, (key, field)


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_read_model_records_equal_jax(tmp_path, ext):
    sparse = str(tmp_path / "sparse")
    writer = write_colmap_binary if ext == ".bin" else write_colmap_text
    writer(sparse, ring_poses(), F, W, H, cloud(40))
    got, want = tread.read_model(sparse, ext), jread.read_model(sparse, ext)
    for g, w in zip(got, want):
        _records_equal(g, w)
    cams, images, points = got
    assert cams[1].model == "SIMPLE_PINHOLE" and (cams[1].width, cams[1].height) == (W, H)
    assert len(images) == N_VIEWS and len(points) == 40
    np.testing.assert_allclose(images[1].qvec2rotmat(),
                               np.linalg.inv(ring_poses()[0])[:3, :3], atol=1e-12)


def test_quaternion_conversions_equal_jax():
    rng = np.random.default_rng(4)
    for _ in range(20):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        R = tread.qvec2rotmat(q)
        assert np.array_equal(R, jread.qvec2rotmat(q))
        assert np.array_equal(tread.rotmat2qvec(R), jread.rotmat2qvec(R))
        np.testing.assert_allclose(tread.rotmat2qvec(R), q * np.sign(q[0]), atol=1e-12)


def test_pipeline_writes_what_jax_writes(model_dir, tmp_path):
    jd, td = _copy(model_dir, tmp_path / "jax"), _copy(model_dir, tmp_path / "port")
    want, got = jpipe.load_colmap_data(jd), tpipe.load_colmap_data(td)
    for g, w in zip(got[::2], want[::2]):  # poses, perm
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert np.array_equal(got[3], want[3])  # names
    _records_equal(got[1], want[1])  # points3D
    assert got[0].shape == (3, 5, N_VIEWS)

    jpipe.save_poses(jd, *[want[i] for i in (0, 1, 2)])
    tpipe.save_poses(td, *[got[i] for i in (0, 1, 2)])
    for name in ("poses.npy", "sparse_points.ply"):
        with open(os.path.join(jd, name), "rb") as a, open(os.path.join(td, name), "rb") as b:
            assert a.read() == b.read(), name
    # the user's crop step: keep the points inside a box
    for d in (jd, td):
        verts, _ = tpipe.load_ply(os.path.join(d, "sparse_points.ply"))
        keep = verts[np.abs(verts).max(-1) < 0.8]
        tpipe.save_ply(os.path.join(d, "sparse_points_interest.ply"), keep,
                       np.zeros((0, 3), np.int64))
    with np.load(jpipe.gen_cameras(jd)) as w, np.load(tpipe.gen_cameras(td)) as g:
        assert sorted(g.files) == sorted(w.files) and len(g.files) == 6 * N_VIEWS
        for key in w.files:
            assert g[key].dtype == w[key].dtype and np.array_equal(g[key], w[key]), key


def test_gen_poses_and_minify_equal_jax(model_dir, tmp_path, capsys):
    jd, td = _copy(model_dir, tmp_path / "jax"), _copy(model_dir, tmp_path / "port")
    assert jpipe.gen_poses(jd, factors=[2]) and tpipe.gen_poses(td, factors=[2])
    assert "Don't need to run COLMAP" in capsys.readouterr().out
    np.testing.assert_array_equal(np.load(os.path.join(td, "poses.npy")),
                                  np.load(os.path.join(jd, "poses.npy")))
    names = sorted(os.listdir(os.path.join(td, "images_2")))
    assert names == sorted(os.listdir(os.path.join(jd, "images_2"))) and len(names) == 4
    for name in names:
        g = cv.imread(os.path.join(td, "images_2", name), -1)
        w = cv.imread(os.path.join(jd, "images_2", name), -1)
        assert g.shape == (H // 2, W // 2, 3) and np.array_equal(g, w), name
    # explicit resolutions, and a set already there is left alone
    tpipe.minify(td, resolutions=[(16, 12)])
    jpipe.minify(jd, resolutions=[(16, 12)])
    for name in names:
        g = cv.imread(os.path.join(td, "images_16x12", name), -1)
        assert g.shape == (12, 16, 3)
        assert np.array_equal(g, cv.imread(os.path.join(jd, "images_16x12", name), -1))


def test_run_colmap_raises_without_the_binary(tmp_path, monkeypatch):
    monkeypatch.setattr(tpipe.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="COLMAP binary not found"):
        tpipe.run_colmap(str(tmp_path))
    # and gen_poses reaches it when sparse/0 is missing
    with pytest.raises(RuntimeError, match="COLMAP binary not found"):
        tpipe.gen_poses(str(tmp_path))


def test_cli_argument_errors():
    from vdnerf_tpu_torch.colmap.gen_cameras_cli import main as gen_cameras_main
    from vdnerf_tpu_torch.colmap.imgs2poses import main as imgs2poses_main

    with pytest.raises(SystemExit, match="usage"):
        gen_cameras_main([])
    with pytest.raises(SystemExit):
        imgs2poses_main(["--match_type", "bogus_matcher", "x"])


CONF = """
general {{
    base_exp_dir = {exp}
    recording = []
}}
dataset {{
    data_dir = {data}
    img_dir = image
    depth_dir = 00
    render_cameras_name = cameras_sphere_colmap.npz
    object_cameras_name = cameras_sphere_colmap.npz
}}
train {{
    learning_rate = 5e-4
    learning_rate_alpha = 0.05
    end_iter = 6
    batch_size = 32
    validate_resolution_level = 4
    warm_up_end = 2
    anneal_end = 4
    use_white_bkgd = True
    save_freq = 6
    val_freq = 100
    val_mesh_freq = 100
    report_freq = 3
    igr_weight = 0.1
    mask_weight = 0.1
}}
model {{
    nerf {{
        D = 2, d_in = 4, d_in_view = 3, W = 32,
        multires = 4, multires_view = 2, output_ch = 4, skips = [4],
        rgb_dims = 3, use_viewdirs = True
    }}
    sdf_network {{
        d_out = 33, d_in = 3, d_hidden = 32, n_layers = 2,
        skip_in = [1], multires = 4, bias = 0.5, scale = 1.0,
        geometric_init = True, weight_norm = True
    }}
    variance_network {{
        init_val = 0.3
    }}
    rendering_network {{
        d_feature = 32, mode = idr, d_in = 9, d_out = 3,
        d_hidden = 32, n_layers = 2, weight_norm = True,
        multires_view = 2, squeeze_out = True
    }}
    neus_renderer {{
        n_samples = 12, n_importance = 8, n_outside = 4,
        up_sample_steps = 4, perturb = 1.0
    }}
}}
"""


def test_capture_to_training_through_the_port(tmp_path):
    """imgs2poses (the COLMAP run skipped: sparse/0 is there), the crop
    step, gen_cameras, then the port's Runner training on the npz."""
    from vdnerf_tpu_torch.colmap.gen_cameras_cli import main as gen_cameras_main
    from vdnerf_tpu_torch.colmap.imgs2poses import main as imgs2poses_main
    from vdnerf_tpu_torch.data.dataset import load_K_Rt_from_P
    from vdnerf_tpu_torch.data.synthetic import make_synthetic_scene
    from vdnerf_tpu_torch.mesh import load_ply, save_ply
    from vdnerf_tpu_torch.runner import Runner

    d = str(tmp_path)
    meta = make_synthetic_scene(d, n_images=3, H=24, W=24)
    sph = np.random.default_rng(1).normal(size=(200, 3))
    sph = 0.5 * sph / np.linalg.norm(sph, axis=-1, keepdims=True)
    poses = [p.astype(np.float64) for p in meta["poses"]]
    write_colmap_binary(os.path.join(d, "sparse", "0"), poses, float(meta["K"][0, 0]),
                        meta["W"], meta["H"], sph)
    imgs2poses_main([d])
    assert np.load(os.path.join(d, "poses.npy")).shape == (3, 3, 5)
    verts, _ = load_ply(os.path.join(d, "sparse_points.ply"))
    save_ply(os.path.join(d, "sparse_points_interest.ply"), verts, np.zeros((0, 3), np.int64))
    gen_cameras_main([d])
    cams = np.load(os.path.join(d, "cameras_sphere_colmap.npz"))
    scale = cams["scale_mat_000"]
    for i, pose in enumerate(poses):
        K, got = load_K_Rt_from_P(None, (cams[f"world_mat_{i:03d}"] @ scale)[:3, :4])
        np.testing.assert_allclose(K[0, 0], meta["K"][0, 0], rtol=1e-4)
        np.testing.assert_allclose(got[:3, :3], pose[:3, :3], atol=1e-4)
        np.testing.assert_allclose(got[:3, 3], (pose[:3, 3] - scale[:3, 3]) / scale[0, 0],
                                   atol=1e-4)

    conf = os.path.join(d, "colmap_e2e.conf")
    with open(conf, "w") as f:
        f.write(CONF.format(exp=os.path.join(d, "exp"), data=d))
    runner = Runner(conf, mode="train", device="cpu")
    assert runner.scene_data.n_images == 3
    summary = runner.train()
    assert runner.iter_step == 6 and all(np.isfinite(v) for v in summary.values())
    assert os.path.exists(os.path.join(d, "exp", "checkpoints", "ckpt_000006.pth"))
    with open(os.path.join(d, "exp", "logs", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    assert recs and all(np.isfinite(r["loss"]) for r in recs)
