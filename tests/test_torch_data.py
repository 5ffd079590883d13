"""vdnerf_tpu_torch.data against vdnerf_tpu.data on one synthetic scene.

The scene from ``make_synthetic_scene`` (RGBA images, ``cameras_sphere.npz``),
plus an RGB copy with separate mask files. Host-side parts (camera
decomposition, image/mask store) must agree exactly; the ray math in f32
within 1e-6.
"""

from __future__ import annotations

import os
import shutil

import cv2 as cv
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdnerf_tpu.data import cameras as jcam
from vdnerf_tpu.data import dataset as jds
from vdnerf_tpu.data.rays import RayStore as JRayStore
from vdnerf_tpu.data.synthetic import make_synthetic_scene
from vdnerf_tpu.utils.hocon import parse_string
from vdnerf_tpu_torch.data import cameras as tcam
from vdnerf_tpu_torch.data import dataset as tds
from vdnerf_tpu_torch.data.rays import RayStore as TRayStore

H, W = 24, 30


def _conf(data_dir: str, img_dir: str):
    return parse_string(f"""
        data_dir = {data_dir}
        img_dir = {img_dir}
        depth_dir = 00
        render_cameras_name = {img_dir}/cameras_sphere.npz
        object_cameras_name = {img_dir}/cameras_sphere.npz
    """)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_data"))
    make_synthetic_scene(d, n_images=3, H=H, W=W)
    # an RGB copy of the scene with the alpha as separate mask files
    rgb_dir = os.path.join(d, "image_rgb")
    os.makedirs(os.path.join(rgb_dir, "mask"))
    shutil.copy(os.path.join(d, "image", "cameras_sphere.npz"), rgb_dir)
    for i in range(3):
        rgba = cv.imread(os.path.join(d, "image", f"{i:03d}.png"), -1)
        cv.imwrite(os.path.join(rgb_dir, f"{i:03d}.png"), rgba[..., :3])
        cv.imwrite(os.path.join(rgb_dir, "mask", f"{i:03d}.png"),
                   np.repeat(rgba[..., 3:], 3, axis=-1))
    return d


@pytest.mark.parametrize("img_dir", ["image", "image_rgb"])
def test_scene_data_and_ray_store_match(scene, img_dir):
    conf = _conf(scene, img_dir)
    j, t = jds.SceneData(conf), tds.SceneData(conf)
    assert (t.H, t.W, t.n_images) == (j.H, j.W, j.n_images) == (H, W, 3)
    assert t.images_lis == j.images_lis and t.masks_lis == j.masks_lis
    np.testing.assert_array_equal(t.pose_all, np.asarray(j.pose_all))
    np.testing.assert_array_equal(t.intrinsics_all_inv, np.asarray(j.intrinsics_all_inv))

    js, ts = JRayStore(j.images_lis, j.masks_lis), TRayStore(t.images_lis, t.masks_lis)
    for idx in range(3):
        for level in (1, 2):
            np.testing.assert_array_equal(ts.image_at(idx, level), js.image_at(idx, level))
            np.testing.assert_array_equal(ts.mask_at(idx, level), js.mask_at(idx, level))


def test_load_K_Rt_from_P_matches():
    rng = np.random.default_rng(0)
    K = np.array([[80.0, 0.3, 15.0], [0.0, 82.0, 12.0], [0.0, 0.0, 1.0]])
    R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    R *= np.sign(np.linalg.det(R))
    P = K @ np.concatenate([R, rng.normal(size=(3, 1))], axis=1)
    for a, b in zip(tds.load_K_Rt_from_P(None, P), jds.load_K_Rt_from_P(None, P)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("level", [1, 2, 4])
def test_rays_grid_and_near_far_match(scene, level):
    j = jds.SceneData(_conf(scene, "image"))
    pose, inv = j.pose_all[1], j.intrinsics_all_inv[1]
    jo, jd = jcam.rays_grid(jnp.asarray(pose), jnp.asarray(inv), H, W, level)
    to, td = tcam.rays_grid(torch.from_numpy(np.asarray(pose)),
                            torch.from_numpy(np.asarray(inv)), H, W, level)
    assert to.shape == (H // level, W // level, 3)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    jn, jf = jds.near_far_from_sphere(jo.reshape(-1, 3), jd.reshape(-1, 3))
    tn, tf = tds.near_far_from_sphere(to.reshape(-1, 3), td.reshape(-1, 3))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-5)
