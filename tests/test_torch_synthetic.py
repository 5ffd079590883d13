"""The port's synthetic scene generator against vdnerf_tpu's.

``vdnerf_tpu_torch/data/synthetic.py`` copies the numpy half of the JAX
package's generator, so the same call writes the same files: images, masks,
``eval_mask/`` and ``cameras_sphere.npz`` byte for byte, at a few views of
32^2 for the sphere scene and for the compound scenes (white and textured
backdrops, ``fixed``, ``camlight`` and ``glossy`` shading, the ``compound``
and ``arch`` geometries). The conf template writes the same text. The torch
SDFs of the Chamfer ground truth match the numpy ones within 1e-6 in f32
(and 1e-12 in f64) over points in and around the unit sphere, and
:data:`GEOMETRIES` pairs each geometry's numpy SDF with its torch twin.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from vdnerf_tpu.data import synthetic as js
from vdnerf_tpu_torch.data import synthetic as ts

VIEWS, RES = 3, 32


def _files(root: str) -> dict[str, bytes]:
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            path = os.path.join(dirpath, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _same_tree(a: str, b: str) -> dict[str, bytes]:
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb)
    for name in fa:
        if name.endswith(".npz"):
            # the archive's zip headers carry timestamps: compare its arrays' bytes
            za, zb = np.load(os.path.join(a, name)), np.load(os.path.join(b, name))
            assert sorted(za.files) == sorted(zb.files), name
            for k in za.files:
                assert za[k].dtype == zb[k].dtype and za[k].tobytes() == zb[k].tobytes(), (name, k)
        else:
            assert fa[name] == fb[name], name
    return fa


def test_sphere_scene_is_byte_identical(tmp_path):
    want = js.make_synthetic_scene(str(tmp_path / "jax"), n_images=VIEWS, H=RES, W=RES)
    got = ts.make_synthetic_scene(str(tmp_path / "port"), n_images=VIEWS, H=RES, W=RES)
    files = _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert sum(n.endswith(".png") for n in files) == VIEWS
    np.testing.assert_array_equal(got["poses"], want["poses"])
    np.testing.assert_array_equal(got["K"], want["K"])


@pytest.mark.parametrize("background,shading,geometry", [
    ("white", "fixed", "compound"),
    ("textured", "fixed", "compound"),
    ("textured", "camlight", "compound"),
    ("white", "glossy", "arch"),
    ("textured", "glossy", "arch"),
])
def test_compound_scene_is_byte_identical(tmp_path, background, shading, geometry):
    kw = dict(n_images=VIEWS, H=RES, W=RES, background=background, shading=shading,
              geometry=geometry)
    want = js.make_compound_scene(str(tmp_path / "jax"), **kw)
    got = ts.make_compound_scene(str(tmp_path / "port"), **kw)
    files = _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    if background == "textured":
        # womsk layout: 3-channel images, dummy masks, true masks for metrics
        assert sum(n.startswith(os.path.join("image", "eval_mask")) for n in files) == VIEWS
        assert sum(n.startswith(os.path.join("image", "mask")) for n in files) == VIEWS
    np.testing.assert_array_equal(got["poses"], want["poses"])
    assert got["geometry"] == want["geometry"] == geometry


def test_render_compound_image_is_identical():
    K = np.eye(4)
    K[0, 0] = K[1, 1] = 1.4 * RES
    K[0, 2] = K[1, 2] = RES / 2.0
    c2w = ts.look_at_pose(np.array([2.2, 0.3, 0.5]), np.zeros(3))
    np.testing.assert_array_equal(c2w, js.look_at_pose(np.array([2.2, 0.3, 0.5]), np.zeros(3)))
    for shading in ("fixed", "camlight", "glossy"):
        got = ts.render_compound_image(c2w, K, RES, RES, "textured", shading=shading)
        want = js.render_compound_image(c2w, K, RES, RES, "textured", shading=shading)
        np.testing.assert_array_equal(got, want)
        assert got[..., 3].any() and not got[..., 3].all()  # object and backdrop in view


def test_synthetic_conf_text_is_equal(tmp_path):
    kw = dict(data_dir="/data/x", exp_dir="/exp/x", end_iter=40, batch_size=64, save_freq=20,
              val_freq=10, val_mesh_freq=30)
    assert ts.SYNTHETIC_CONF_TEMPLATE == js.SYNTHETIC_CONF_TEMPLATE
    a = js.write_synthetic_conf(str(tmp_path / "jax.conf"), **kw)
    b = ts.write_synthetic_conf(str(tmp_path / "port.conf"), **kw)
    with open(a) as fa, open(b) as fb:
        assert fa.read() == fb.read()


def _points(n: int = 20000) -> np.ndarray:
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1.1, 1.1, size=(n, 3))
    # and points on or near each surface, where the min() switches branches
    return np.concatenate([pts, pts[:2000] * 0.4, np.zeros((1, 3))])


@pytest.mark.parametrize("geometry", ["compound", "arch"])
def test_torch_sdf_matches_numpy(geometry):
    np_sdf, torch_sdf = ts.GEOMETRIES[geometry]
    assert np_sdf is getattr(ts, f"{geometry}_sdf")
    assert torch_sdf is getattr(ts, f"{geometry}_sdf_torch")
    pts = _points()
    want = np_sdf(pts)
    np.testing.assert_array_equal(want, js.GEOMETRIES[geometry][0](pts))
    got32 = torch_sdf(torch.tensor(pts, dtype=torch.float32)).numpy()
    got64 = torch_sdf(torch.tensor(pts, dtype=torch.float64)).numpy()
    assert got32.dtype == np.float32 and got32.shape == want.shape
    np.testing.assert_allclose(got32, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got64, want, rtol=0, atol=1e-12)
    assert (want < 0).any() and (want > 0).any()
