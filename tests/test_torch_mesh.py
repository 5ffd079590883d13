"""The port's mesh path against vdnerf_tpu.mesh and the JAX runner, on the CPU.

- Grid values: ``extract_fields`` of the port's SDF (the plain version of
  K1 on the CPU) against the JAX one of ``sdf_value`` from the same
  parameters (``from_jax_params``), on a 32^3 grid in chunks of 5,000 points
  (a ragged last chunk): atol 1e-5 (f32 summation order).
- Marching and PLY: the port's ``marching_cubes`` on the JAX field returns the
  JAX arrays bit for bit (the same source, built by each package); the PLY
  bytes are the JAX writer's, and each reader reads the other's file back.
- Mesh tools: ``mesh_components``, ``hull_membership``, ``clean_mesh``,
  ``edge_stats``, ``mesh_chamfer`` and ``geometry_qc`` equal the JAX functions
  within 1e-6 on generated meshes (the JAX mesh tests' cube and camera
  fixtures, and marched sphere fields).
- The runner: ``validate_mesh`` in world space through a non-identity
  ``scale_mat`` gives the JAX runner's vertices within 1e-4 and the same
  triangles, from one checkpoint at a small resolution; the CLI modes
  ``validate_mesh_<it>`` and ``validate_mesh -c`` run (the 512^3 of the CLI is
  lowered by a monkeypatch) and the bare mode exits; the training loop's
  cadence is the JAX runner's: both runners, resumed before the 50,000th and
  150,000th steps, ask for the same meshes.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_mesh_clean import _scene, cube_mesh
from torch_parity import jax_nets, jax_params, one_torch_thread, port_model  # noqa: F401
from vdnerf_tpu import mesh as jmesh
from vdnerf_tpu.data.synthetic import make_synthetic_scene, write_synthetic_conf
from vdnerf_tpu.mesh import clean as jclean
from vdnerf_tpu.mesh import qc as jqc
from vdnerf_tpu.models.fields import sdf_value
from vdnerf_tpu_torch import mesh as tmesh
from vdnerf_tpu_torch.mesh import clean as tclean
from vdnerf_tpu_torch.mesh import qc as tqc

NETS = jax_nets()
BBOX = ([-1.01] * 3, [1.01] * 3)
TOOL_TOL = 1e-6


@pytest.fixture(scope="module")
def net_fields():
    """The JAX and port fields (-sdf) of one small SDF on a 32^3 grid."""
    params = jax_params(NETS, seed=2)
    model = port_model(NETS, params, torch.bfloat16)

    def jq(pts):
        return -sdf_value(NETS.sdf, params["sdf"], pts)[..., 0]

    def tq(pts):
        return -model.sdf_network_fine.sdf_value(pts)[:, 0]

    want = jmesh.extract_fields(*BBOX, 32, jq, chunk=5000)
    got = tmesh.extract_fields(*BBOX, 32, tq, chunk=5000, device="cpu")
    return want, got


def test_grid_values_match_jax(net_fields):
    want, got = net_fields
    assert got.shape == want.shape == (32, 32, 32) and got.dtype == np.float32
    assert want.min() < 0.0 < want.max()  # the zero set lies inside the grid
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _sphere_field(res=40, radius=0.55):
    g = np.linspace(-1, 1, res, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    return radius - np.sqrt(x**2 + y**2 + z**2)


@pytest.mark.parametrize("field", ["net", "sphere", "empty"])
def test_marching_is_bit_identical_to_jax(net_fields, field):
    u = {"net": net_fields[0], "sphere": _sphere_field(),
         "empty": np.full((8, 8, 8), -1.0, np.float32)}[field]
    verts, tris = tmesh.marching_cubes(u, 0.0)
    jverts, jtris = jmesh.marching_cubes(u, 0.0)
    assert verts.dtype == jverts.dtype == np.float32 and tris.dtype == jtris.dtype == np.int64
    assert verts.shape == jverts.shape and tris.shape == jtris.shape
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(tris, jtris)
    if field == "empty":
        assert verts.shape == (0, 3) and tris.shape == (0, 3)
    else:
        assert len(tris) > 100


@pytest.mark.parametrize("field", ["net", "empty"])
def test_ply_bytes_match_jax_and_read_back(net_fields, tmp_path, field):
    if field == "net":
        verts, tris = jmesh.marching_cubes(net_fields[0], 0.0)
    else:
        verts, tris = np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    port_path, jax_path = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    tmesh.save_ply(port_path, verts, tris)
    jmesh.save_ply(jax_path, verts, tris)
    with open(port_path, "rb") as a, open(jax_path, "rb") as b:
        assert a.read() == b.read()
    for load in (tmesh.load_ply, jmesh.load_ply):
        for path in (port_path, jax_path):
            v, t = load(path)
            np.testing.assert_array_equal(v, verts)
            np.testing.assert_array_equal(t, tris)
            assert v.dtype == np.float32 and t.dtype == np.int64


def _assert_tree_close(got, want):
    """Dicts, tuples and arrays equal within TOOL_TOL (ints and bools exactly)."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_close(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_close(g, w)
    elif want is None:
        assert got is None
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=TOOL_TOL, rtol=0)
        else:
            np.testing.assert_array_equal(g, w)


def _two_cubes():
    v1, f1 = cube_mesh([0, 0, 0], 0.25)
    v2, f2 = cube_mesh([1.6, 0, 0], 0.2)
    return np.concatenate([v1, v2]), np.concatenate([f1, f2 + 8])


def _sphere_and_blob_mesh():
    """A marched sphere (radius 0.25) with a far blob, in the cameras' frame."""
    g = np.linspace(-0.6, 0.6, 40, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    d1 = np.sqrt(x**2 + y**2 + z**2) - 0.25
    d2 = np.sqrt((x - 0.45) ** 2 + (y - 0.45) ** 2 + z**2) - 0.08
    verts, tris = jmesh.marching_cubes(-np.minimum(d1, d2), 0.0)
    return verts / 39.0 * 1.2 - 0.6, tris


@pytest.mark.parametrize("mesh", ["two_cubes", "sphere_and_blob"])
def test_clean_tools_match_jax(mesh):
    verts, tris = _two_cubes() if mesh == "two_cubes" else _sphere_and_blob_mesh()
    masks, wms = _scene()
    _assert_tree_close(tclean.mesh_components(verts, tris), jclean.mesh_components(verts, tris))
    _assert_tree_close(tclean.hull_membership(verts, masks, wms, dilate=4),
                       jclean.hull_membership(verts, masks, wms, dilate=4))
    got = tclean.clean_mesh(verts, tris, masks, wms, dilate=4)
    want = jclean.clean_mesh(verts, tris, masks, wms, dilate=4)
    assert want[2]["hull_culled_verts"] > 0  # the cleaner had something to cut
    _assert_tree_close(got, want)
    for t in (tris, tris[: len(tris) // 2], tris[:0]):
        assert tclean.edge_stats(t) == jclean.edge_stats(t)


def _sphere_mesh(res, radius):
    verts, tris = jmesh.marching_cubes(_sphere_field(res, radius), 0.0)
    return verts / (res - 1.0) * 2.0 - 1.0, tris


def test_mesh_chamfer_matches_jax():
    a, b = _sphere_mesh(40, 0.55), _sphere_mesh(32, 0.5)
    got = tmesh.mesh_chamfer(*a, *b, n_points=5000, seed=3)
    want = jmesh.mesh_chamfer(*a, *b, n_points=5000, seed=3)
    _assert_tree_close(got, want)
    assert 0.05 < want["chamfer"] < 0.2


def _jax_sphere(pts):
    return -(jnp.linalg.norm(pts, axis=-1) - 0.25)


def _torch_sphere(pts):
    return -(torch.linalg.norm(pts, dim=-1) - 0.25)


def _jax_two_blobs(pts):
    d1 = jnp.linalg.norm(pts, axis=-1) - 0.25
    d2 = jnp.linalg.norm(pts - jnp.array([0.45, 0.45, 0.0]), axis=-1) - 0.08
    return -jnp.minimum(d1, d2)


def _torch_two_blobs(pts):
    d1 = torch.linalg.norm(pts, dim=-1) - 0.25
    d2 = torch.linalg.norm(pts - torch.tensor([0.45, 0.45, 0.0]), dim=-1) - 0.08
    return -torch.minimum(d1, d2)


def _no_walls(report):
    report = dict(report)
    report.pop("wall_s")
    if report["raw"]:
        report["raw"] = {k: v for k, v in report["raw"].items() if k != "extract_wall_s"}
    return report


@pytest.mark.parametrize("fields", ["sphere", "two_blobs"])
def test_geometry_qc_matches_jax(tmp_path, fields):
    masks, wms = _scene()
    jfn, tfn = {"sphere": (_jax_sphere, _torch_sphere),
                "two_blobs": (_jax_two_blobs, _torch_two_blobs)}[fields]
    kw = dict(n_points=5000)
    want = jqc.geometry_qc(jfn, _jax_sphere, [-0.6] * 3, [0.6] * 3, 40, masks, wms,
                           ply_prefix=str(tmp_path / "jax"), **kw)
    got = tqc.geometry_qc(tfn, _torch_sphere, [-0.6] * 3, [0.6] * 3, 40, masks, wms,
                          ply_prefix=str(tmp_path / "port"), device="cpu", **kw)
    assert want["clean"]["n_verts"] > 0 and want["chamfer"]["chamfer"] is not None
    _assert_tree_close(_no_walls(got), _no_walls(want))
    for suffix in (".ply", "_clean.ply"):
        with open(tmp_path / f"port{suffix}", "rb") as a, open(tmp_path / f"jax{suffix}", "rb") as b:
            assert a.read() == b.read()


# -- the runner and the CLI ---------------------------------------------------

SCALE, CENTER = 1.5, np.array([0.3, -0.2, 0.1], np.float32)
MESH_RES = 24


@pytest.fixture(scope="module")
def mesh_scene(tmp_path_factory):
    """A synthetic scene whose cameras carry a non-identity scale_mat (the
    same projections P = world_mat @ scale_mat), and a JAX ckpt_000000.npz."""
    from vdnerf_tpu.runner import Runner as JRunner

    d = str(tmp_path_factory.mktemp("torch_mesh"))
    make_synthetic_scene(d, n_images=2, H=16, W=16)
    npz = os.path.join(d, "image", "cameras_sphere.npz")
    cams = dict(np.load(npz))
    S = np.eye(4, dtype=np.float32)
    S[:3, :3] *= SCALE
    S[:3, 3] = CENTER
    for key in [k for k in cams if k.startswith("world_mat_")]:
        cams[key] = (cams[key] @ np.linalg.inv(S)).astype(np.float32)
        cams[key.replace("world_mat_", "scale_mat_")] = S
    np.savez(npz, **cams)
    conf = write_synthetic_conf(os.path.join(d, "mesh.conf"), data_dir=d,
                                exp_dir=os.path.join(d, "exp"))
    JRunner(conf, mode="validate_mesh_0", seed=3).save_checkpoint()
    return d, conf


@pytest.fixture
def small_cli_mesh(monkeypatch):
    """Runner.validate_mesh at MESH_RES whatever the caller asks; records
    the calls."""
    from vdnerf_tpu_torch.runner import Runner

    calls, full = [], Runner.validate_mesh

    def small(self, world_space=False, resolution=256, threshold=0.0):
        calls.append((self.iter_step, world_space, resolution, threshold))
        return full(self, world_space, MESH_RES, threshold)

    monkeypatch.setattr(Runner, "validate_mesh", small)
    return calls


@pytest.mark.parametrize("threshold", [0.0, 0.05])
def test_validate_mesh_cli_matches_jax_runner_in_world_space(mesh_scene, small_cli_mesh,
                                                            threshold):
    from vdnerf_tpu.runner import Runner as JRunner
    from vdnerf_tpu_torch.cli import main

    d, conf = mesh_scene
    runner = JRunner(conf, mode="validate_mesh_0", seed=0)
    runner.load_checkpoint_iter(0)
    want = jmesh.load_ply(runner.validate_mesh(world_space=True, resolution=MESH_RES,
                                               threshold=threshold))
    got = main(["--conf", conf, "--mode", "validate_mesh_0",
                "--mcube_threshold", str(threshold)], device="cpu")
    assert small_cli_mesh == [(0, True, 512, threshold)]
    assert got["path"] == os.path.join(d, "exp", "meshes", "00000000.ply")
    verts, tris = tmesh.load_ply(got["path"])
    assert (got["n_verts"], got["n_tris"]) == (len(verts), len(tris)) and len(tris) > 100
    np.testing.assert_array_equal(tris, want[1])
    np.testing.assert_allclose(verts, want[0], atol=1e-4, rtol=0)
    # the vertices are in world space: the object frame scaled and moved
    assert np.abs(verts.mean(0) - CENTER).max() < 0.1 * SCALE


def test_validate_mesh_resumes_the_latest_checkpoint_or_exits(mesh_scene, small_cli_mesh):
    from vdnerf_tpu_torch.cli import main
    from vdnerf_tpu_torch.io.checkpoints import checkpoint_path, save_training_checkpoint
    from vdnerf_tpu_torch.runner import Runner

    d, conf = mesh_scene
    with pytest.raises(SystemExit, match="needs an iteration suffix or --is_continue"):
        main(["--conf", conf, "--mode", "validate_mesh"], device="cpu")
    runner = Runner(conf, device="cpu", mode="validate_mesh")
    assert runner.store is None  # a mesh mode loads no images
    runner.load_checkpoint_iter(0)
    exp = os.path.join(d, "exp")
    save_training_checkpoint(checkpoint_path(exp, 7), runner.model, 7)
    got = main(["--conf", conf, "--mode", "validate_mesh", "-c"], device="cpu")
    assert small_cli_mesh == [(7, True, 512, 0.0)]
    assert got["path"] == os.path.join(exp, "meshes", "00000007.ply")
    assert set(got["seconds"]) == {"grid", "to_host", "marching", "ply"}
    with open(got["path"], "rb") as f:
        resumed = f.read()
    # validate_mesh_7 from that checkpoint writes the same bytes again
    again = main(["--conf", conf, "--mode", "validate_mesh_7"], device="cpu")
    assert small_cli_mesh[-1] == (7, True, 512, 0.0) and again["path"] == got["path"]
    with open(got["path"], "rb") as f:
        assert f.read() == resumed and len(resumed) > 1000


@pytest.mark.parametrize("start", [49_999, 149_999])
def test_training_mesh_cadence_matches_the_jax_runner(tmp_path, start):
    """A JAX runner and a port runner, each resumed at ``start``, train two
    steps at the shipped val_mesh_freq of 10,000; the (step, resolution,
    world_space) of every validate_mesh call they make is the same."""
    from vdnerf_tpu.runner import Runner as JRunner
    from vdnerf_tpu_torch.runner import Runner

    d = str(tmp_path)
    make_synthetic_scene(d, n_images=2, H=16, W=16)
    calls = {}
    for name, cls in (("jax", JRunner), ("port", Runner)):
        conf = write_synthetic_conf(os.path.join(d, f"{name}.conf"), data_dir=d,
                                    exp_dir=os.path.join(d, name), end_iter=start + 2,
                                    batch_size=16, val_mesh_freq=10_000)
        kw = {"device": "cpu"} if cls is Runner else {}
        runner = cls(conf, mode="train", **kw)
        if cls is Runner:
            runner.iter_step = start
        else:
            runner.state = {**runner.state, "step": jnp.asarray(start, jnp.int32)}
        calls[name] = []

        def record(world_space=False, resolution=256, threshold=0.0, runner=runner,
                   seen=calls[name]):
            seen.append((runner.iter_step, resolution, world_space))

        runner.validate_mesh = record
        runner.val_all_imgs = lambda **_: {}
        runner.train()
    assert calls["port"] == calls["jax"] == [(start + 1, *{
        49_999: (256, False), 149_999: (512, True)}[start])]


def test_training_mesh_cadence_is_the_jax_runners():
    from vdnerf_tpu_torch.runner import mesh_resolution

    assert mesh_resolution(10_000) == (128, False)
    assert mesh_resolution(50_000) == (256, False)
    assert mesh_resolution(100_000) == (256, False)
    assert mesh_resolution(150_000) == (512, True)
    assert mesh_resolution(250_000) == (256, False)
    assert mesh_resolution(300_000) == (512, True)
    assert mesh_resolution(20) == (128, False)
