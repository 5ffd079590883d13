"""COLMAP capture preparation: the SfM wrapper, and poses and the camera
npz from a sparse model.

Counterpart of ``vdnerf_tpu/colmap/pipeline.py``:

- :func:`run_colmap`: the external COLMAP binary (feature_extractor, the
  exhaustive or sequential matcher, mapper; one camera, no colours); raises
  ``RuntimeError`` when it is not on PATH.
- :func:`load_colmap_data`: w2c -> c2w with the LLFF axis permutation
  [-u, r, -t] and a per-image hwf column.
- :func:`save_poses`: ``poses.npy`` and ``sparse_points.ply``.
- :func:`minify`: downscaled image sets (cv2).
- :func:`gen_poses`: the imgs2poses step (an existing ``sparse/0`` is
  reused).
- :func:`gen_cameras`: ``poses.npy`` and the user-cropped
  ``sparse_points_interest.ply`` -> ``cameras_sphere_colmap.npz`` with per-image
  world_mat, scale_mat and camera_mat (the unit sphere from the cropped
  cloud's bbox).

Point clouds go through the port's own PLY I/O (``mesh/extract.py``).
"""

from __future__ import annotations

import os
import shutil
import subprocess

import cv2 as cv
import numpy as np

from vdnerf_tpu_torch.colmap import read_model
from vdnerf_tpu_torch.mesh.extract import load_ply, save_ply


def run_colmap(basedir: str, match_type: str = "exhaustive_matcher") -> None:
    """Run the external COLMAP binary: features -> matches -> mapper."""
    if shutil.which("colmap") is None:
        raise RuntimeError(
            "COLMAP binary not found on PATH; install COLMAP or provide a "
            "precomputed sparse/0 model"
        )
    logfile = os.path.join(basedir, "colmap_output.txt")
    db = os.path.join(basedir, "database.db")
    img_dir = os.path.join(basedir, "images")

    def run(args):
        with open(logfile, "a") as log:
            subprocess.run(args, check=True, stdout=log, stderr=log)

    run([
        "colmap", "feature_extractor",
        "--database_path", db,
        "--image_path", img_dir,
        "--ImageReader.single_camera", "1",
        "--SiftExtraction.num_threads", "16",
    ])
    run([
        "colmap", match_type,
        "--database_path", db,
    ])
    sparse = os.path.join(basedir, "sparse")
    os.makedirs(sparse, exist_ok=True)
    run([
        "colmap", "mapper",
        "--database_path", db,
        "--image_path", img_dir,
        "--output_path", sparse,
        "--Mapper.num_threads", "16",
        "--Mapper.init_min_tri_angle", "4",
        "--Mapper.multiple_models", "0",
        "--Mapper.extract_colors", "0",
    ])


def load_colmap_data(realdir: str):
    """-> (poses [3,5,N] with hwf column and [-u,r,-t] axes, pts3d, perm,
    names)."""
    sparse = os.path.join(realdir, "sparse/0")
    camdata = read_model.read_cameras_binary(
        os.path.join(sparse, "cameras.bin")
    )
    cam = camdata[list(camdata.keys())[0]]
    h, w, f = cam.height, cam.width, cam.params[0]
    hwf = np.array([h, w, f]).reshape([3, 1])

    imdata = read_model.read_images_binary(os.path.join(sparse, "images.bin"))
    names = [imdata[k].name for k in imdata]
    perm = np.argsort(names)

    bottom = np.array([0, 0, 0, 1.0]).reshape([1, 4])
    w2c_mats = []
    for k in imdata:
        im = imdata[k]
        R = im.qvec2rotmat()
        t = im.tvec.reshape([3, 1])
        w2c_mats.append(
            np.concatenate([np.concatenate([R, t], 1), bottom], 0)
        )
    w2c_mats = np.stack(w2c_mats, 0)
    c2w_mats = np.linalg.inv(w2c_mats)

    poses = c2w_mats[:, :3, :4].transpose([1, 2, 0])
    poses = np.concatenate(
        [poses, np.tile(hwf[..., None], [1, 1, poses.shape[-1]])], 1
    )
    # [r, -u, t] -> [-u, r, -t] (the LLFF/NeRF convention the downstream
    # gen_cameras conversion expects)
    poses = np.concatenate(
        [
            poses[:, 1:2, :], poses[:, 0:1, :], -poses[:, 2:3, :],
            poses[:, 3:4, :], poses[:, 4:5, :],
        ],
        1,
    )

    pts3d = read_model.read_points3d_binary(
        os.path.join(sparse, "points3D.bin")
    )
    return poses, pts3d, perm, np.array(names, dtype=str)


def save_poses(basedir: str, poses: np.ndarray, pts3d: dict, perm) -> None:
    pts_arr = []
    for k in pts3d:
        cams = [0] * poses.shape[-1]
        visible = False
        for ind in pts3d[k].image_ids:
            if len(cams) <= ind - 1:
                continue
            visible = True
            cams[ind - 1] = 1
        if visible:
            pts_arr.append(pts3d[k].xyz)
    pts = np.stack(pts_arr, axis=0)
    save_ply(
        os.path.join(basedir, "sparse_points.ply"),
        pts.astype(np.float32), np.zeros((0, 3), np.int64),
    )

    poses = np.moveaxis(poses, -1, 0)[perm]
    np.save(os.path.join(basedir, "poses.npy"), poses)


def minify(basedir: str, factors=(), resolutions=()) -> None:
    """Write downscaled image sets ``images_<factor>/`` / ``images_<WxH>/``
    with cv2's area interpolation; a set already there is left alone."""
    img_dir = os.path.join(basedir, "images")
    names = sorted(
        f for f in os.listdir(img_dir)
        if f.lower().endswith((".png", ".jpg", ".jpeg"))
    )
    jobs = [(f"images_{r}", ("factor", r)) for r in factors]
    jobs += [(f"images_{w}x{h}", ("res", (w, h))) for (w, h) in resolutions]
    for out_name, (kind, val) in jobs:
        out_dir = os.path.join(basedir, out_name)
        if os.path.exists(out_dir):
            continue
        os.makedirs(out_dir, exist_ok=True)
        for name in names:
            img = cv.imread(os.path.join(img_dir, name), -1)
            if kind == "factor":
                h, w = img.shape[:2]
                size = (w // val, h // val)
            else:
                size = val
            out = cv.resize(img, size, interpolation=cv.INTER_AREA)
            cv.imwrite(os.path.join(out_dir, name), out)


def gen_poses(
    basedir: str, match_type: str = "exhaustive_matcher", factors=None
) -> bool:
    """The imgs2poses step: COLMAP unless ``sparse/0`` already holds a
    binary model, then ``poses.npy`` and ``sparse_points.ply``, and the
    downscaled image sets of ``factors``."""
    needed = [f"{f}.bin" for f in ("cameras", "images", "points3D")]
    sparse0 = os.path.join(basedir, "sparse/0")
    had = os.listdir(sparse0) if os.path.exists(sparse0) else []
    if not all(f in had for f in needed):
        print("Need to run COLMAP")
        run_colmap(basedir, match_type)
    else:
        print("Don't need to run COLMAP")

    poses, pts3d, perm, names = load_colmap_data(basedir)
    save_poses(basedir, poses, pts3d, perm)
    if factors:
        minify(basedir, factors=factors)
    print("Done with imgs2poses")
    return True


def gen_cameras(work_dir: str) -> str:
    """poses.npy + sparse_points_interest.ply -> cameras_sphere_colmap.npz."""
    poses_hwf = np.load(os.path.join(work_dir, "poses.npy"))  # [N, 3, 5]
    poses_raw = poses_hwf[:, :, :4]
    hwf = poses_hwf[:, :, 4]

    # LLFF [-u, r, -t] -> OpenCV [r, -u, t]
    convert_mat = np.zeros([4, 4], dtype=np.float32)
    convert_mat[0, 1] = 1.0
    convert_mat[1, 0] = 1.0
    convert_mat[2, 2] = -1.0
    convert_mat[3, 3] = 1.0

    cam_dict = {}
    n_images = len(poses_raw)
    for i in range(n_images):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :4] = poses_raw[i]
        pose = pose @ convert_mat
        h, w, f = hwf[i]
        intrinsic = np.diag([f, f, 1.0, 1.0]).astype(np.float32)
        intrinsic[0, 2] = (w - 1) * 0.5
        intrinsic[1, 2] = (h - 1) * 0.5
        world_mat = (intrinsic @ np.linalg.inv(pose)).astype(np.float32)
        cam_dict[f"camera_mat_{i:0>3d}"] = intrinsic
        cam_dict[f"camera_mat_inv_{i:0>3d}"] = np.linalg.inv(intrinsic)
        cam_dict[f"world_mat_{i:0>3d}"] = world_mat
        cam_dict[f"world_mat_inv_{i:0>3d}"] = np.linalg.inv(world_mat)

    # unit-sphere normalization from the user-cropped interest cloud
    verts, _ = load_ply(os.path.join(work_dir, "sparse_points_interest.ply"))
    bbox_max = verts.max(axis=0)
    bbox_min = verts.min(axis=0)
    center = (bbox_max + bbox_min) * 0.5
    radius = np.linalg.norm(verts - center, axis=-1).max()
    scale_mat = np.diag([radius, radius, radius, 1.0]).astype(np.float32)
    scale_mat[:3, 3] = center
    for i in range(n_images):
        cam_dict[f"scale_mat_{i:0>3d}"] = scale_mat
        cam_dict[f"scale_mat_inv_{i:0>3d}"] = np.linalg.inv(scale_mat)

    out = os.path.join(work_dir, "cameras_sphere_colmap.npz")
    np.savez(out, **cam_dict)
    print("Process done!")
    return out
