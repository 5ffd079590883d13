"""Runner: training, and serving renders and depth exports from a checkpoint.

Counterpart of ``vdnerf_tpu/runner.py`` for fixed cameras:

- ``train``: the training loop with the faithful-then-resampled core switch
  at ``train.resample_from``, metrics to ``logs/metrics.jsonl``, periodic
  ``ckpt_<iter>.pth`` checkpoints and validation images, checkpoint-and-exit
  on SIGTERM, resume from the latest checkpoint with ``is_continue``, and the
  closing all-image evaluation;
- ``valimg_<it>``: masked and unmasked L1/PSNR over all images at
  resolution level 2;
- ``getfeats_<it>``: per-image argmax-weight depth at full resolution,
  written to ``<data_dir>/<img_dir>/depth_from_sdf/sdf_<stem>.npy`` (stage 2
  of the VDN cycle).

Checkpoints load from the JAX package's ``ckpt_<it>.npz`` or a reference
``ckpt_<it>.pth``; training writes the latter. The runner runs on
``cuda:<gpu>`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal

import cv2 as cv
import numpy as np
import torch

from vdnerf_tpu_torch.data.dataset import SceneData
from vdnerf_tpu_torch.data.rays import RayStore
from vdnerf_tpu_torch.io import (
    MetricsWriter,
    Throughput,
    checkpoint_path,
    latest_checkpoint,
    load_jax_checkpoint,
    load_reference_checkpoint,
    record_run,
    save_training_checkpoint,
)
from vdnerf_tpu_torch.train.builder import build_model, build_networks
from vdnerf_tpu_torch.train.config import TrainConfig
from vdnerf_tpu_torch.train.step import Trainer
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
        mode: str = "valimg",
        is_continue: bool = False,
    ):
        self.device = resolve_device(device, gpu)
        configure_numerics()
        self.conf = load_conf(conf_path, case, img_dir, npz_postfix)
        self.tcfg = TrainConfig.from_conf(self.conf)
        if self.tcfg.learnable:
            raise NotImplementedError("learned cameras are not ported yet")
        if mode == "train" and self.tcfg.val_mesh_freq <= self.tcfg.end_iter:
            raise NotImplementedError(
                f"train.val_mesh_freq = {self.tcfg.val_mesh_freq} would extract a mesh "
                f"before end_iter = {self.tcfg.end_iter}, and mesh extraction is not "
                "ported yet (ROADMAP.md queue 1, item 2); set train.val_mesh_freq "
                "above train.end_iter"
            )
        self.base_exp_dir = self.conf.get_string("general.base_exp_dir")
        if img_dir != "image":
            self.base_exp_dir += "_" + img_dir.split("image")[-1]
        os.makedirs(self.base_exp_dir, exist_ok=True)

        self.scene_data = SceneData(self.conf["dataset"])
        self.nets = build_networks(self.conf, self.tcfg.extract_depth)
        self.model = build_model(self.conf, self.nets, seed).to(self.device)
        self.iter_step = 0
        self.store = RayStore(self.scene_data.images_lis, self.scene_data.masks_lis)
        self.renderer = ImageRenderer(self.nets, self.tcfg, self.scene_data.H, self.scene_data.W)
        self.rng = np.random.default_rng(seed)

        self.trainer = None
        if mode == "train":
            cams = {
                "pose_all": torch.as_tensor(self.scene_data.pose_all, device=self.device),
                "intrin_inv_all": torch.as_tensor(self.scene_data.intrinsics_all_inv,
                                                  device=self.device),
            }
            generator = torch.Generator(device=self.device).manual_seed(seed)
            self.trainer = Trainer(self.tcfg, self.model, cams, generator)
            latest = latest_checkpoint(self.base_exp_dir) if is_continue else None
            if latest is not None:
                log.info("resuming from %s", latest)
                self.iter_step = load_reference_checkpoint(latest, self.model,
                                                           self.trainer.optimizer)
            record_run(self.base_exp_dir, self.conf.get("general.recording", []), conf_path)

    # -- checkpoints ----------------------------------------------------------

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

    def save_checkpoint(self) -> str:
        path = checkpoint_path(self.base_exp_dir, self.iter_step)
        save_training_checkpoint(path, self.model, self.iter_step, self.trainer.optimizer)
        return path

    # -- training -------------------------------------------------------------

    def train(self) -> dict | None:
        """Train to ``end_iter`` -> the closing ``val_all_imgs`` summary (None
        when a SIGTERM stopped the run after its checkpoint)."""
        tcfg = self.tcfg
        writer = MetricsWriter(os.path.join(self.base_exp_dir, "logs"))
        # the faithful full-width core up to resample_from, the resampled core
        # after it (the JAX runner's one program switch)
        resample_boundary = 0
        if self.nets.renderer.n_render_samples > 0 and tcfg.resample_from > self.iter_step:
            resample_boundary = min(tcfg.resample_from, tcfg.end_iter)
        faithful = dataclasses.replace(
            self.nets, renderer=dataclasses.replace(self.nets.renderer, n_render_samples=0))

        # SIGTERM asks for a checkpoint and a clean exit at the next step
        # boundary; the previous handler comes back on every exit path
        self._preempt_signal = None

        def _request_preempt(signum, _frame):
            self._preempt_signal = signum

        prev_sigterm = None
        try:
            prev_sigterm = signal.signal(signal.SIGTERM, _request_preempt)
        except ValueError:
            pass  # not the main thread: no hook

        n_images = self.scene_data.n_images
        image_perm = self.rng.permutation(n_images)
        perm_pos = 0
        throughput = Throughput(tcfg.batch_size)
        try:
            for _ in range(tcfg.end_iter - self.iter_step):
                idx = int(image_perm[perm_pos % len(image_perm)])
                batch = self.store.sample_pixels(idx, tcfg.batch_size, self.rng)
                perm_pos += 1
                if perm_pos % len(image_perm) == 0:
                    image_perm = self.rng.permutation(n_images)
                step = self.iter_step + 1
                nets = self.nets if step > resample_boundary else faithful
                metrics = self.trainer.step(nets, batch, self.iter_step)
                self.iter_step = step
                rays_ps = throughput.tick()
                if step % 10 == 0 or step <= 1:
                    writer.write(step, {**metrics, "rays_per_sec": rays_ps})
                if step % tcfg.report_freq == 0:
                    log.info("iter %d loss=%.5f psnr=%.3f rays/s=%.0f", step,
                             float(metrics["loss"]), float(metrics["psnr"]), rays_ps)
                if self._preempt_signal is not None:
                    # before the periodic validations: the grace window is short
                    self.save_checkpoint()
                    writer.flush()
                    log.warning("preemption signal %d: checkpoint saved at iter %d; "
                                "rerun with --is_continue to resume",
                                self._preempt_signal, step)
                    return None
                if step % tcfg.save_freq == 0:
                    self.save_checkpoint()
                if step % tcfg.val_freq == 0:
                    self.validate_image()
        finally:
            if prev_sigterm is not None:
                signal.signal(signal.SIGTERM, prev_sigterm)
            writer.close()
        return self.val_all_imgs(resolution_level=2, both_mask=True)

    # -- validation -----------------------------------------------------------

    def _render(self, idx: int, resolution_level: int) -> dict:
        return self.renderer.render_image(
            self.model, self.scene_data.pose_all[idx],
            self.scene_data.intrinsics_all_inv[idx], resolution_level, self.iter_step,
        )

    def validate_image(self, idx: int = -1, resolution_level: int = -1) -> None:
        """validations_fine/ (render over ground truth) and normals/ PNGs."""
        if idx < 0:
            idx = int(self.rng.integers(self.scene_data.n_images))
        if resolution_level < 0:
            resolution_level = self.tcfg.validate_resolution_level
        out = self._render(idx, resolution_level)
        img = (out["img"] * 255).clip(0, 255).astype(np.uint8)
        normal = (out["normal"] * 128 + 128).clip(0, 255).astype(np.uint8)
        gt = self.store.image_at(idx, resolution_level).astype(np.uint8)
        name = f"{self.iter_step:08d}_0_{idx}.png"
        for sub, image in (("validations_fine", np.concatenate([img, gt], axis=0)),
                           ("normals", normal)):
            os.makedirs(os.path.join(self.base_exp_dir, sub), exist_ok=True)
            cv.imwrite(os.path.join(self.base_exp_dir, sub, name), image)

    def val_img(self, idx: int, resolution_level: int = 1,
                gen_depth_for_finetune: bool = False, both_mask: bool = False):
        gt = self.store.image_at(idx, resolution_level) / 255.0
        mask = self.store.mask_at(idx, resolution_level)
        if self.tcfg.use_mask or both_mask:
            mask = (mask > 0.1).astype(np.float32)
        else:
            mask = np.ones_like(mask)

        out = self._render(idx, resolution_level)
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
