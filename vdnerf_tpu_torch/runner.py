"""Evaluation runner: serves renders and depth exports from a checkpoint.

Counterpart of the serving part of ``vdnerf_tpu/runner.py``:

- ``valimg_<it>``: masked and unmasked L1/PSNR over all images at
  resolution level 2;
- ``getfeats_<it>``: per-image argmax-weight depth at full resolution,
  written to ``<data_dir>/<img_dir>/depth_from_sdf/sdf_<stem>.npy`` (stage 2
  of the VDN cycle).

Checkpoints load from the JAX package's ``ckpt_<it>.npz`` or a reference
``ckpt_<it>.pth``. The runner runs on ``cuda:<gpu>`` unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from vdnerf_tpu_torch.data.dataset import SceneData
from vdnerf_tpu_torch.data.rays import RayStore
from vdnerf_tpu_torch.io.checkpoints import load_jax_checkpoint, load_reference_checkpoint
from vdnerf_tpu_torch.train.builder import build_model, build_networks
from vdnerf_tpu_torch.train.config import TrainConfig
from vdnerf_tpu_torch.train.validate import ImageRenderer, export_depth_from_sdf, val_image_metrics
from vdnerf_tpu_torch.utils.device import configure_numerics, resolve_device
from vdnerf_tpu_torch.utils.hocon import load_conf

log = logging.getLogger(__name__)


class Runner:
    def __init__(
        self,
        conf_path: str,
        case: str = "CASE_NAME",
        img_dir: str = "image",
        npz_postfix: str = "",
        seed: int = 0,
        device=None,
        gpu: int = 0,
    ):
        self.device = resolve_device(device, gpu)
        configure_numerics()
        self.conf = load_conf(conf_path, case, img_dir, npz_postfix)
        self.base_exp_dir = self.conf.get_string("general.base_exp_dir")
        if img_dir != "image":
            self.base_exp_dir += "_" + img_dir.split("image")[-1]
        os.makedirs(self.base_exp_dir, exist_ok=True)

        self.scene_data = SceneData(self.conf["dataset"])
        self.tcfg = TrainConfig.from_conf(self.conf)
        if self.tcfg.learnable:
            raise NotImplementedError("learned cameras are not ported yet")
        self.nets = build_networks(self.conf, self.tcfg.extract_depth)
        self.model = build_model(self.conf, self.nets, seed).to(self.device)
        self.model.eval()
        self.iter_step = 0
        self.store = RayStore(self.scene_data.images_lis, self.scene_data.masks_lis)
        self.renderer = ImageRenderer(self.nets, self.tcfg, self.scene_data.H, self.scene_data.W)

    def load_checkpoint_iter(self, iter_step: int) -> None:
        """Load ckpt_<iter>.npz (JAX package), else ckpt_<iter>.pth (reference)."""
        stem = os.path.join(self.base_exp_dir, "checkpoints", f"ckpt_{iter_step:06d}")
        if os.path.exists(stem + ".npz"):
            self.iter_step = load_jax_checkpoint(stem + ".npz", self.model)
        elif os.path.exists(stem + ".pth"):
            self.iter_step = load_reference_checkpoint(stem + ".pth", self.model)
        else:
            raise FileNotFoundError(stem + ".npz")
        log.info("loaded checkpoint %s at iter %d", stem, self.iter_step)

    def val_img(self, idx: int, resolution_level: int = 1,
                gen_depth_for_finetune: bool = False, both_mask: bool = False):
        gt = self.store.image_at(idx, resolution_level) / 255.0
        mask = self.store.mask_at(idx, resolution_level)
        if self.tcfg.use_mask or both_mask:
            mask = (mask > 0.1).astype(np.float32)
        else:
            mask = np.ones_like(mask)

        out = self.renderer.render_image(
            self.model, self.scene_data.pose_all[idx],
            self.scene_data.intrinsics_all_inv[idx], resolution_level, self.iter_step,
        )
        img = out["img"]
        if gen_depth_for_finetune:
            stem = os.path.splitext(os.path.basename(self.scene_data.images_lis[idx]))[0]
            npy_path = os.path.join(
                self.scene_data.data_dir, self.scene_data.img_dir,
                "depth_from_sdf", f"sdf_{stem}.npy",
            )
            png_path = os.path.join(
                self.base_exp_dir, "weight_max", f"weight_max_{self.iter_step}_{idx}.png"
            )
            export_depth_from_sdf(out["weight_depth"], npy_path, png_path)

        l1, psnr = val_image_metrics(img, gt, mask)
        l1_full = psnr_full = None
        if both_mask:
            l1_full, psnr_full = val_image_metrics(img, gt, np.ones_like(mask))
        return l1, psnr, out["gradient_error"], l1_full, psnr_full

    def val_all_imgs(self, resolution_level: int = -1,
                     gen_depth_for_finetune: bool = False, both_mask: bool = False) -> dict:
        if resolution_level < 0:
            resolution_level = self.tcfg.validate_resolution_level
        rows = [
            self.val_img(idx, resolution_level, gen_depth_for_finetune, both_mask)
            for idx in range(self.scene_data.n_images)
        ]
        l1s, psnrs, geiks, l1s_f, psnrs_f = zip(*rows)
        summary = {
            "l1": float(np.mean(l1s)),
            "psnr": float(np.mean(psnrs)),
            "gradient_error": float(np.mean(geiks)),
        }
        if both_mask:
            summary["l1_unmasked"] = float(np.mean(l1s_f))
            summary["psnr_unmasked"] = float(np.mean(psnrs_f))
        log.info("val_all_imgs: %s", summary)
        print(summary)
        return summary
