"""Full-image rendering, validation metrics and the depth export.

Counterpart of ``vdnerf_tpu/train/validate.py``:

- :func:`resolve_cams`: every camera's c2w and inverse intrinsics, the
  learned ones for a learnable conf.
- :class:`ImageRenderer`: rays in chunks through :func:`render`, RGB,
  camera-frame normals and the argmax-weight depth.
- :func:`val_image_metrics`: masked L1 and PSNR.
- :func:`export_depth_from_sdf`: the ``getfeats`` output, per-pixel
  argmax-weight depth as ``.npy`` plus a percentile-normalised PNG.
- :func:`interpolate_frames`, :func:`write_video`: the novel-view sweep
  between two cameras as uint8 BGR frames, and its ``mp4v`` video.

Spans of a frame (``utils/trace.py``): ``serve.frame`` (one
:meth:`ImageRenderer.render_image` or ``render_between``, its id the
renderer's frame count), ``serve.rays`` (the ray grid, and each chunk's
near/far), ``serve.chunk``, inside it the render's spans, ``serve.outputs``
(normals, argmax depth, the chunk's eikonal sums) and ``serve.to_host`` (the
copies and reads on the host); counters ``serve.frames``, ``serve.chunks``
and ``serve.host_syncs`` (one a copy or read).
"""

from __future__ import annotations

import os

import cv2 as cv
import numpy as np
import torch

from vdnerf_tpu_torch.data.cameras import rays_between, rays_grid
from vdnerf_tpu_torch.data.dataset import near_far_from_sphere
from vdnerf_tpu_torch.ops.renderer import NeuSModel, NeuSNetworks, render
from vdnerf_tpu_torch.train.config import TrainConfig
from vdnerf_tpu_torch.utils import trace


def resolve_cams(cams, pose_all: np.ndarray,
                 intrin_inv_all: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """-> (pose_all [n, 4, 4], intrin_inv [n, 4, 4]) on the host: the fixed
    cameras given, or with :class:`LearnedCameras` ``cams`` the learned c2w
    of every camera and the inverse of the learned K."""
    if cams is None:
        return pose_all, intrin_inv_all
    with torch.no_grad():
        poses = cams.all_c2w().cpu().numpy()
        intrin_inv = cams.K_inv().cpu().numpy()
    return poses, np.tile(intrin_inv, (len(poses), 1, 1))


class ImageRenderer:
    """Chunked full-image renders on the model's device."""

    def __init__(self, nets: NeuSNetworks, tcfg: TrainConfig, H: int, W: int,
                 chunk: int | None = None):
        self.nets = nets
        self.tcfg = tcfg
        self.H, self.W = H, W
        self.chunk = chunk or max(tcfg.batch_size, 4096)
        self.frames = 0

    @torch.no_grad()
    def _render_chunk(self, model: NeuSModel, rays_o, rays_d, anneal: float) -> dict:
        with trace.span("serve.rays"):
            near, far = near_far_from_sphere(rays_o, rays_d)
            background_rgb = (
                torch.ones(1, 3, device=rays_o.device) if self.tcfg.use_white_bkgd else None
            )
        out = render(
            self.nets, model, rays_o, rays_d, near, far,
            perturb_overwrite=0, background_rgb=background_rgb,
            cos_anneal_ratio=anneal, depth_before_color=self.tcfg.depth_before_color,
        )
        with trace.span("serve.outputs"):
            inside = out["inside_sphere"]
            n_total = inside.shape[1]
            normals = torch.sum(
                out["gradients"] * out["weights"][:, :n_total, None] * inside[..., None], dim=1
            )
            w_inside = out["weights"][:, :n_total] * inside
            argmax_w = torch.argmax(w_inside, dim=-1)
            weight_depth = torch.gather(out["z_vals"], -1, argmax_w[:, None])
            return {
                "color": out["color_fine"],
                "normals": normals,
                "weight_depth": weight_depth,
                "grad_err_num": out["gradient_error_num"].sum(),
                "grad_err_den": out["gradient_error_den"].sum(),
            }

    def render_rays(self, model: NeuSModel, rays_o, rays_d, step: int = 0) -> dict:
        """Render [M, 3] rays chunk by chunk -> numpy dict."""
        anneal = float(min(1.0, step / self.tcfg.anneal_end) if self.tcfg.anneal_end > 0 else 1.0)
        outs = {"color": [], "normals": [], "weight_depth": []}
        grad_num = grad_den = 0.0
        for start in range(0, rays_o.shape[0], self.chunk):
            with trace.span("serve.chunk"):
                out = self._render_chunk(
                    model, rays_o[start:start + self.chunk], rays_d[start:start + self.chunk],
                    anneal)
                with trace.span("serve.to_host"):
                    for k in outs:
                        outs[k].append(out[k].cpu().numpy())
                    grad_num += float(out["grad_err_num"])
                    grad_den += float(out["grad_err_den"])
            trace.count("serve.chunks")
            trace.count("serve.host_syncs", len(outs) + 2)
        result = {k: np.concatenate(v, axis=0) for k, v in outs.items()}
        result["gradient_error"] = grad_num / (grad_den + 1e-5)
        return result

    def render_image(self, model: NeuSModel, pose: np.ndarray, intrin_inv: np.ndarray,
                     resolution_level: int = 1, step: int = 0) -> dict:
        with trace.span("serve.frame", id=self._next_frame()):
            dev = next(model.parameters()).device
            with trace.span("serve.rays"):
                rays_o, rays_d = rays_grid(
                    torch.as_tensor(pose, device=dev), torch.as_tensor(intrin_inv, device=dev),
                    self.H, self.W, resolution_level,
                )
            h, w = rays_o.shape[:2]
            out = self.render_rays(model, rays_o.reshape(-1, 3), rays_d.reshape(-1, 3), step)
        # rotate world normals into the camera frame
        rot = np.linalg.inv(pose[:3, :3])
        return {
            "img": out["color"].reshape(h, w, -1),
            "normal": (rot @ out["normals"][..., None]).reshape(h, w, 3),
            "weight_depth": out["weight_depth"].reshape(h, w, 1),
            "gradient_error": out["gradient_error"],
        }

    def render_between(self, model: NeuSModel, poses: np.ndarray, intrin_inv: np.ndarray,
                       idx0: int, idx1: int, ratio: float, resolution_level: int = 4,
                       step: int = 0) -> np.ndarray:
        """[H//l, W//l, 3] colour of the pose at ``ratio`` between cameras
        ``idx0`` and ``idx1`` of ``poses`` (from :func:`resolve_cams`), through
        the first camera's inverse intrinsics."""
        with trace.span("serve.frame", id=self._next_frame()):
            dev = next(model.parameters()).device
            with trace.span("serve.rays"):
                rays_o, rays_d = rays_between(
                    torch.as_tensor(poses[idx0], device=dev),
                    torch.as_tensor(poses[idx1], device=dev),
                    torch.as_tensor(intrin_inv[0], device=dev), ratio, self.H, self.W,
                    resolution_level,
                )
            h, w = rays_o.shape[:2]
            out = self.render_rays(model, rays_o.reshape(-1, 3), rays_d.reshape(-1, 3), step)
        return out["color"].reshape(h, w, -1)

    def _next_frame(self) -> int:
        """This renderer's frame count before the frame (its span's id)."""
        self.frames += 1
        trace.count("serve.frames")
        return self.frames - 1


def val_image_metrics(img: np.ndarray, gt: np.ndarray, mask: np.ndarray) -> tuple[float, float]:
    """(L1, PSNR) under a [H, W, 1] mask."""
    mask_sum = mask.sum() + 1e-5
    l1 = np.abs((img - gt) * mask).sum() / mask_sum
    mse = ((img - gt) ** 2 * mask).sum() / (mask_sum * 3.0)
    psnr = 20.0 * np.log10(1.0 / np.sqrt(max(mse, 1e-12)))
    return float(l1), float(psnr)


def export_depth_from_sdf(weight_depth: np.ndarray, out_npy_path: str,
                          weight_png_path: str | None = None) -> None:
    """Save the per-pixel argmax-weight depth (the VDN cycle interface)."""
    os.makedirs(os.path.dirname(out_npy_path), exist_ok=True)
    np.save(out_npy_path, weight_depth)
    if weight_png_path is not None:
        lb, ub = np.percentile(weight_depth, [50, 95])
        png = ((weight_depth - lb) / max(ub - lb, 1e-9) * 255).clip(0, 255)
        os.makedirs(os.path.dirname(weight_png_path), exist_ok=True)
        cv.imwrite(weight_png_path, png)


def interpolate_frames(renderer: ImageRenderer, model: NeuSModel, poses: np.ndarray,
                       intrin_inv: np.ndarray, idx0: int, idx1: int, n_frames: int = 60,
                       resolution_level: int = 4, step: int = 0) -> list[np.ndarray]:
    """The sweep from camera ``idx0`` to ``idx1`` at sine-eased ratios as
    uint8 frames in the dataset's BGR order, then the same frames reversed."""
    frames = []
    for i in range(n_frames):
        ratio = np.sin(((i / n_frames) - 0.5) * np.pi) * 0.5 + 0.5
        img = renderer.render_between(model, poses, intrin_inv, idx0, idx1, float(ratio),
                                      resolution_level, step)
        frames.append((img * 256).clip(0, 255).astype(np.uint8))
    return frames + frames[::-1]


def write_video(path: str, frames: list[np.ndarray], fps: int = 30) -> None:
    """``frames`` as an ``mp4v`` video; raises if the writer does not open."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    h, w = frames[0].shape[:2]
    writer = cv.VideoWriter(path, cv.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"cv2.VideoWriter could not open {path} for mp4v")
    try:
        for frame in frames:
            writer.write(frame)
    finally:
        writer.release()
