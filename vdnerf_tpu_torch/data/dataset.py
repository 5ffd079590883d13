"""Scene dataset: images, masks, cameras_sphere npz conventions.

Counterpart of ``vdnerf_tpu/data/dataset.py``:

- ``load_K_Rt_from_P`` — decompose P = K[R|t] (cv2.decomposeProjectionMatrix).
- :class:`SceneData` — image list, per-image ``world_mat_<stem>`` /
  ``scale_mat_<stem>`` from the camera npz, unit-sphere object bbox.
- :func:`near_far_from_sphere` — ray-vs-unit-sphere chord midpoint +- 1.
"""

from __future__ import annotations

import os
from glob import glob

import cv2 as cv
import numpy as np
import torch


def load_K_Rt_from_P(filename: str | None, P: np.ndarray | None = None):
    """Decompose a 3x4 projection matrix into intrinsics + c2w pose.

    Matches reference dataset.py:13-34 (K normalized by K[2,2]; pose is the
    camera-to-world transform).
    """
    if P is None:
        with open(filename) as f:
            lines = f.read().splitlines()
        if len(lines) == 4:
            lines = lines[1:]
        lines = [
            [x[0], x[1], x[2], x[3]] for x in (x.split(" ") for x in lines)
        ]
        P = np.asarray(lines).astype(np.float32).squeeze()

    K, R, t = cv.decomposeProjectionMatrix(P)[:3]
    t = (t[:3] / t[3])[:, 0]

    K = K / K[2, 2]
    intrinsics = np.eye(4)
    intrinsics[:3, :3] = K

    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.transpose()
    pose[:3, 3] = t
    return intrinsics, pose


class SceneData:
    """Camera/image metadata for one scene (host side)."""

    def __init__(self, conf):
        self.conf = conf
        self.data_dir = conf.get_string("data_dir")
        self.img_dir = conf.get_string("img_dir")
        self.depth_dir = conf.get_string("depth_dir")
        self.render_cameras_name = conf.get_string("render_cameras_name")
        self.object_cameras_name = conf.get_string("object_cameras_name")
        self.camera_outside_sphere = conf.get_bool(
            "camera_outside_sphere", default=True
        )
        self.scale_mat_scale = conf.get_float("scale_mat_scale", default=1.1)

        self.images_lis = sorted(
            glob(os.path.join(self.data_dir, self.img_dir, "*.png"))
        )
        self.n_images = len(self.images_lis)
        if self.n_images == 0:
            raise FileNotFoundError(
                f"no images in {os.path.join(self.data_dir, self.img_dir)}"
            )
        self.masks_lis = [
            os.path.join(
                self.data_dir, self.img_dir, "mask",
                f"{os.path.splitext(os.path.basename(f))[0]}.png",
            )
            for f in self.images_lis
        ]
        self.depth_lis = [
            os.path.join(
                self.data_dir, self.img_dir, self.depth_dir,
                f"{os.path.splitext(os.path.basename(f))[0]}.npy",
            )
            for f in self.images_lis
        ]
        img0 = cv.imread(self.images_lis[0])
        self.H, self.W = img0.shape[:2]
        self.image_pixels = self.H * self.W

        camera_dict = np.load(
            os.path.join(self.data_dir, self.render_cameras_name)
        )
        self.camera_dict = camera_dict
        stems = [
            os.path.splitext(os.path.basename(f))[0] for f in self.images_lis
        ]
        self.world_mats_np = [
            camera_dict[f"world_mat_{s}"].astype(np.float32) for s in stems
        ]
        self.scale_mats_np = [
            camera_dict[f"scale_mat_{s}"].astype(np.float32) for s in stems
        ]

        intrinsics_all = []
        pose_all = []
        for scale_mat, world_mat in zip(self.scale_mats_np, self.world_mats_np):
            P = (world_mat @ scale_mat)[:3, :4]
            intrinsics, pose = load_K_Rt_from_P(None, P)
            intrinsics_all.append(intrinsics.astype(np.float32))
            pose_all.append(pose.astype(np.float32))
        self.intrinsics_all = np.stack(intrinsics_all)  # [n, 4, 4]
        self.intrinsics_all_inv = np.linalg.inv(self.intrinsics_all)
        self.focal = self.intrinsics_all[0][0, 0]
        self.pose_all = np.stack(pose_all)  # [n, 4, 4]

        object_bbox_min = np.array([-1.01, -1.01, -1.01, 1.0])
        object_bbox_max = np.array([1.01, 1.01, 1.01, 1.0])
        object_scale_mat = self.scale_mats_np[0]
        inv0 = np.linalg.inv(self.scale_mats_np[0])
        object_bbox_min = inv0 @ object_scale_mat @ object_bbox_min[:, None]
        object_bbox_max = inv0 @ object_scale_mat @ object_bbox_max[:, None]
        self.object_bbox_min = object_bbox_min[:3, 0]
        self.object_bbox_max = object_bbox_max[:3, 0]


def near_far_from_sphere(
    rays_o: torch.Tensor, rays_d: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Near/far as unit-sphere chord midpoint -/+ 1 (reference
    dataset.py:111-118)."""
    a = torch.sum(rays_d**2, dim=-1, keepdim=True)
    b = 2.0 * torch.sum(rays_o * rays_d, dim=-1, keepdim=True)
    mid = 0.5 * (-b) / a
    return mid - 1.0, mid + 1.0
