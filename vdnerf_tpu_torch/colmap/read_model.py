"""COLMAP sparse-model readers (binary and text).

Counterpart of ``vdnerf_tpu/colmap/read_model.py``, its own copy: the
cameras, images and points3D of COLMAP's ``.bin`` and ``.txt`` formats as
records, and the quaternion <-> rotation conversions (numpy, host only).
"""

from __future__ import annotations

import collections
import os
import struct

import numpy as np

CameraModel = collections.namedtuple(
    "CameraModel", ["model_id", "model_name", "num_params"]
)
Camera = collections.namedtuple(
    "Camera", ["id", "model", "width", "height", "params"]
)
BaseImage = collections.namedtuple(
    "Image", ["id", "qvec", "tvec", "camera_id", "name", "xys", "point3D_ids"]
)
Point3D = collections.namedtuple(
    "Point3D", ["id", "xyz", "rgb", "error", "image_ids", "point2D_idxs"]
)


class Image(BaseImage):
    def qvec2rotmat(self):
        return qvec2rotmat(self.qvec)


CAMERA_MODELS = [
    CameraModel(0, "SIMPLE_PINHOLE", 3),
    CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4),
    CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8),
    CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12),
    CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5),
    CameraModel(10, "THIN_PRISM_FISHEYE", 12),
]
MODEL_BY_ID = {m.model_id: m for m in CAMERA_MODELS}
MODEL_BY_NAME = {m.model_name: m for m in CAMERA_MODELS}


def qvec2rotmat(qvec) -> np.ndarray:
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rotmat2qvec(R) -> np.ndarray:
    # Shepperd via the symmetric K-matrix eigen decomposition
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = np.asarray(R).flat
    K = (
        np.array(
            [
                [Rxx - Ryy - Rzz, 0, 0, 0],
                [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(f, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path: str) -> dict[int, Camera]:
    cameras = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            model = MODEL_BY_ID[model_id]
            params = np.array(_read(f, f"<{model.num_params}d"))
            cameras[cam_id] = Camera(
                cam_id, model.model_name, width, height, params
            )
    return cameras


def read_images_binary(path: str) -> dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            image_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            camera_id = _read(f, "<i")[0]
            name = b""
            while True:
                ch = f.read(1)
                if ch == b"\x00":
                    break
                name += ch
            (n_pts,) = _read(f, "<Q")
            data = np.frombuffer(
                f.read(24 * n_pts), dtype=[("xy", "<2f8"), ("id", "<i8")]
            )
            images[image_id] = Image(
                image_id, qvec, tvec, camera_id, name.decode("utf-8"),
                data["xy"].copy(), data["id"].copy(),
            )
    return images


def read_points3d_binary(path: str) -> dict[int, Point3D]:
    points = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            pt_id = _read(f, "<Q")[0]
            xyz = np.array(_read(f, "<3d"))
            rgb = np.array(_read(f, "<3B"))
            (error,) = _read(f, "<d")
            (track_len,) = _read(f, "<Q")
            track = np.frombuffer(
                f.read(8 * track_len), dtype=[("im", "<i4"), ("pt", "<i4")]
            )
            points[pt_id] = Point3D(
                pt_id, xyz, rgb, error,
                track["im"].copy(), track["pt"].copy(),
            )
    return points


# -- text variants -----------------------------------------------------------


def _data_lines(path: str):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path: str) -> dict[int, Camera]:
    cameras = {}
    for line in _data_lines(path):
        parts = line.split()
        cam_id = int(parts[0])
        cameras[cam_id] = Camera(
            cam_id, parts[1], int(parts[2]), int(parts[3]),
            np.array(list(map(float, parts[4:]))),
        )
    return cameras


def read_images_text(path: str) -> dict[int, Image]:
    images = {}
    lines = list(_data_lines(path))
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        image_id = int(parts[0])
        qvec = np.array(list(map(float, parts[1:5])))
        tvec = np.array(list(map(float, parts[5:8])))
        camera_id = int(parts[8])
        name = parts[9]
        elems = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array(list(map(float, elems))).reshape(-1, 3)[:, :2] if elems else np.zeros((0, 2))
        ids = (
            np.array(list(map(float, elems))).reshape(-1, 3)[:, 2].astype(np.int64)
            if elems else np.zeros((0,), np.int64)
        )
        images[image_id] = Image(image_id, qvec, tvec, camera_id, name, xys, ids)
    return images


def read_points3d_text(path: str) -> dict[int, Point3D]:
    points = {}
    for line in _data_lines(path):
        parts = line.split()
        pt_id = int(parts[0])
        xyz = np.array(list(map(float, parts[1:4])))
        rgb = np.array(list(map(int, parts[4:7])))
        error = float(parts[7])
        track = np.array(list(map(int, parts[8:])))
        points[pt_id] = Point3D(
            pt_id, xyz, rgb, error, track[0::2], track[1::2]
        )
    return points


def read_model(path: str, ext: str = ".bin"):
    if ext == ".bin":
        return (
            read_cameras_binary(os.path.join(path, "cameras.bin")),
            read_images_binary(os.path.join(path, "images.bin")),
            read_points3d_binary(os.path.join(path, "points3D.bin")),
        )
    return (
        read_cameras_text(os.path.join(path, "cameras.txt")),
        read_images_text(os.path.join(path, "images.txt")),
        read_points3d_text(os.path.join(path, "points3D.txt")),
    )
