"""Runner: training, and serving renders and depth exports from a checkpoint.

Counterpart of ``vdnerf_tpu/runner.py`` for fixed and learned cameras:

- ``train``: the training loop in windows of ``train.steps_per_call`` steps
  (each step on the card a CUDA-graph replay, ``train/dispatch.py``) with the
  faithful-then-resampled core switch at ``train.resample_from``, metrics to
  ``logs/metrics.jsonl``, periodic ``ckpt_<iter>.pth`` checkpoints and
  validation images, checkpoint-and-exit on SIGTERM, resume from the latest
  checkpoint with ``is_continue``, and the closing all-image evaluation;
- ``valimg_<it>``: masked and unmasked L1/PSNR over all images at
  resolution level 2;
- ``getfeats_<it>``: per-image argmax-weight depth at full resolution,
  written to ``<data_dir>/<img_dir>/depth_from_sdf/sdf_<stem>.npy`` (stage 2
  of the VDN cycle);
- ``validate_mesh``: the -SDF iso-surface over the object bbox (grid through
  K1), in world space through ``scale_mats_np[0]`` on request, written to
  ``meshes/<iter:08d>.ply``; training extracts one at every
  ``val_mesh_freq``-th step (128^3, 256^3 at every 50,000th, 512^3 in world
  space at every 150,000th);
- ``interpolate_<i>_<j>``: the 60-frame novel-view sweep between cameras i
  and j at resolution level 4, forward then back, written to
  ``render/<iter:08d>_<i>_<j>.mp4``;
- ``showcam``: the initial, learned (learnable confs) and ground-truth
  camera poses to ``cam_poses/pose_<iter:06d>.npz`` and a frustum PNG beside
  it.

The wdepth confs (``train.extract_depth``) add the depth head and the
depth-feature store (``<data_dir>/<img_dir>/<depth_dir>/<stem>.npy``), which
every mode but the mesh modes loads, as the JAX runner does; ``only_depth`` and
``depth_weight`` are parsed and change nothing, and ``c_cat_d`` is not read,
as there. The learnable confs (``train.focal_learnable``) train the poses and
the focal with the networks (``data/cameras.py`` ``LearnedCameras``), and
every mode renders through the learned cameras.
Checkpoints load from the JAX package's ``ckpt_<it>.npz`` (the learned cameras
included) or a reference ``ckpt_<it>.pth`` (the learned cameras from the
``pnf_checkpoints/pnf_<it>.pth`` beside it); training writes the latter two.
The runner runs on ``cuda:<gpu>`` unless the caller passes ``device="cpu"``.

Data parallelism (``parallel/mesh.py``): a training runner given a
:class:`World` of N ranks (``torchrun``; ``cli.py`` makes it) runs on
``cuda:<LOCAL_RANK>``. Every rank draws the same full batch from the same
seeded host stream and keeps its block, so the sampling is the
single-process run's; every host draw (the validation image's index too)
happens on every rank. Rank 0 alone writes the metrics, checkpoints,
validation images, meshes and the closing evaluation, while the others wait
at a barrier; a SIGTERM on any rank stops every rank at the same window
boundary. ``VDNERF_PROFILE_DIR`` traces steps 10-15 on rank 0
(``utils/debug.py``), the program's spans and marks in it
(``utils/trace.py``).

The log's ``rays/s`` and ``metrics.jsonl``'s ``rays_per_sec`` are the last
window's: its rays over the host time since the window before it ended. At
the end of training one log line gives each step program's captures, eager
steps and replays, and the host seconds of the ``data.*``, ``dispatch.*`` and
``setup.*`` spans. Set-up runs in the spans ``setup.scene`` (the scene and
the ray store, ``setup.features`` in it) and ``setup.model``; the mesh in
``mesh.grid``, ``mesh.to_host``, ``mesh.marching`` and ``mesh.ply``.

Precision: the SDF block is f32 unless ``VDNERF_BF16`` asks for bf16 (read
once, here); a training runner switches it to bf16 when the conf sets
``train.bf16``, for the run's steps and its validation renders, as the JAX
runner switches its policy on in ``train()`` (``models/precision.py``). The
serving modes run under the first of the two. K2-K5 take their operand mode
from that policy and ``VDNERF_FUSED`` (also read once, here): f32 operands
under the f32 policy, as JAX's default, bf16 under ``VDNERF_FUSED`` or the
bf16 policy.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import os
import signal
import time

import cv2 as cv
import numpy as np
import torch

from vdnerf_tpu_torch.data.cameras import LearnedCameras, learn_intrin_K
from vdnerf_tpu_torch.data.dataset import SceneData, load_K_Rt_from_P
from vdnerf_tpu_torch.data.rays import RayStore
from vdnerf_tpu_torch.io import (
    MetricsWriter,
    checkpoint_path,
    from_jax_cams,
    latest_checkpoint,
    load_jax_checkpoint,
    load_pnf_checkpoint,
    load_reference_checkpoint,
    pnf_path,
    read_jax_cams,
    record_run,
    save_pnf_checkpoint,
    save_training_checkpoint,
)
from vdnerf_tpu_torch.mesh import extract_geometry, save_ply
from vdnerf_tpu_torch.models.precision import (
    env_fused,
    env_matmul_dtype,
    matmul_dtype,
    mlp_operand_dtype,
)
from vdnerf_tpu_torch.parallel import World, broadcast_parameters, rank_seed, shard_batch
from vdnerf_tpu_torch.train.builder import build_model, build_networks
from vdnerf_tpu_torch.train.config import TrainConfig
from vdnerf_tpu_torch.train.dispatch import StepDispatch
from vdnerf_tpu_torch.train.step import Trainer
from vdnerf_tpu_torch.train.validate import (
    ImageRenderer,
    export_depth_from_sdf,
    interpolate_frames,
    resolve_cams,
    val_image_metrics,
    write_video,
)
from vdnerf_tpu_torch.utils import debug, trace
from vdnerf_tpu_torch.utils.camvis import plot_cam_poses
from vdnerf_tpu_torch.utils.device import configure_numerics, resolve_device
from vdnerf_tpu_torch.utils.hocon import load_conf

log = logging.getLogger(__name__)


def mesh_resolution(step: int) -> tuple[int, bool]:
    """The training loop's mesh at ``step`` -> (resolution, world_space):
    128^3, 256^3 at every 50,000th step, 512^3 in world space at every
    150,000th (the JAX runner's cadence)."""
    if step % 150000 == 0:
        return 512, True
    if step % 50000 == 0:
        return 256, False
    return 128, False


def log_programs() -> None:
    """One log line: each step program's captures, eager steps and replays
    (``train/dispatch.py``'s counters), the SDF block's calls by route
    (``sdf_block.fused``, ``sdf_block.autograd``: ``models/fields.py``), the
    split mode's product launches by path (``split_gemm.*``:
    ``ops/kernels/fused_mlp.py``; a captured step counts when captured), and
    the host seconds of the ``data.*``, ``dispatch.*`` and ``setup.*`` spans,
    in this process."""
    programs: dict[str, dict[str, int]] = {}
    counts = trace.counts()
    for name, n in counts.items():
        what, _, program = name.partition(".")[2].partition(".")
        if name.startswith("dispatch."):
            programs.setdefault(program, {})[what] = n
    sdf = {route: counts.get(f"sdf_block.{route}", 0) for route in ("fused", "autograd")}
    split = {name.partition(".")[2]: n for name, n in sorted(counts.items())
             if name.startswith("split_gemm.")}
    spans = {name: round(s, 3) for name, (_, s) in trace.host().items()
             if name.split(".")[0] in ("data", "dispatch", "setup")}
    log.info("step programs %s; SDF block calls %s; split products %s; host seconds %s",
             programs, sdf, split, spans)


def window_size(tcfg: TrainConfig, res_step: int, iter_step: int,
                resample_boundary: int) -> int:
    """Steps per dispatch window: ``steps_per_call`` clipped by a gcd with
    every cadence (metric writes every 10 steps, report, save, validation,
    mesh), the steps left, the resume iteration and the core switch, as the
    JAX runner clips it (a term of 0 imposes nothing)."""
    k = max(1, tcfg.steps_per_call)
    for m in (10, tcfg.report_freq, tcfg.save_freq, tcfg.val_freq, tcfg.val_mesh_freq,
              res_step, iter_step, resample_boundary):
        if m:
            k = math.gcd(k, m)
    return k


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
        world: World | None = None,
    ):
        self.world = world or World()
        self.device = resolve_device(device, gpu)
        configure_numerics()
        self.conf = load_conf(conf_path, case, img_dir, npz_postfix)
        self.tcfg = TrainConfig.from_conf(self.conf)
        self.base_exp_dir = self.conf.get_string("general.base_exp_dir")
        if img_dir != "image":
            self.base_exp_dir += "_" + img_dir.split("image")[-1]
        os.makedirs(self.base_exp_dir, exist_ok=True)

        with trace.span("setup.scene"):
            self.scene_data = SceneData(self.conf["dataset"])
            self.store = None
            if "mesh" not in mode:
                self.store = RayStore(self.scene_data.images_lis, self.scene_data.masks_lis,
                                      self.scene_data.depth_lis,
                                      with_depth=self.tcfg.extract_depth)
        with trace.span("setup.model"):
            self.nets = build_networks(self.conf, self.tcfg.extract_depth)
            # the SDF block's precision: train.bf16 for a training run, else
            # VDNERF_BF16; K2-K5's operands follow it and VDNERF_FUSED
            policy = (matmul_dtype(True) if mode == "train" and self.tcfg.bf16
                      else env_matmul_dtype())
            self.mlp_dtype = mlp_operand_dtype(policy, env_fused())
            self.model = build_model(self.conf, self.nets, seed, policy,
                                     mlp_dtype=self.mlp_dtype).to(self.device)
        self.iter_step = 0
        self.renderer = ImageRenderer(self.nets, self.tcfg, self.scene_data.H, self.scene_data.W)
        self.rng = np.random.default_rng(seed)
        # the learned cameras (None for a fixed-camera conf), in every mode
        self.cams = None
        if self.tcfg.learnable:
            self.cams = LearnedCameras(
                self.scene_data.pose_all, float(self.scene_data.focal), self.scene_data.H,
                self.scene_data.W, self.conf.get_int("model.focal.order", default=2),
            ).to(self.device)

        self.trainer = None
        if mode == "train":
            cams = self.cams
            if cams is None:
                cams = {
                    "pose_all": torch.as_tensor(self.scene_data.pose_all, device=self.device),
                    "intrin_inv_all": torch.as_tensor(self.scene_data.intrinsics_all_inv,
                                                      device=self.device),
                }
            # each rank its own jitter stream; rank 0's is the single-process one
            generator = torch.Generator(device=self.device).manual_seed(
                rank_seed(seed, self.world.rank))
            self.trainer = Trainer(self.tcfg, self.model, cams, generator, self.world)
            if self.world.lead:
                record_run(self.base_exp_dir, self.conf.get("general.recording", []), conf_path)
        latest = latest_checkpoint(self.base_exp_dir) if is_continue else None
        if latest is not None:
            log.info("resuming from %s", latest)
            self.iter_step = load_reference_checkpoint(
                latest, self.model, self.trainer.optimizer if self.trainer else None)
            self._load_pnf(self.iter_step)
        if self.world.grouped:
            # every rank starts from rank 0's parameters (and learned cameras)
            broadcast_parameters(self.model, *([self.cams] if self.cams is not None else []))

    # -- checkpoints ----------------------------------------------------------

    def load_checkpoint_iter(self, iter_step: int) -> None:
        """Load ckpt_<iter>.npz (JAX package), else ckpt_<iter>.pth (reference),
        with the learned cameras of the one, or of the pnf_<iter>.pth beside
        the other."""
        stem = os.path.join(self.base_exp_dir, "checkpoints", f"ckpt_{iter_step:06d}")
        if os.path.exists(stem + ".npz"):
            self.iter_step = load_jax_checkpoint(stem + ".npz", self.model)
            cams = read_jax_cams(stem + ".npz") if self.cams is not None else None
            if cams is not None:
                self.cams.load_state_dict(from_jax_cams(cams))
        elif os.path.exists(stem + ".pth"):
            self.iter_step = load_reference_checkpoint(stem + ".pth", self.model)
            self._load_pnf(iter_step)
        else:
            raise FileNotFoundError(stem + ".npz")
        log.info("loaded checkpoint %s at iter %d", stem, self.iter_step)

    def _load_pnf(self, iter_step: int) -> None:
        """The learned cameras (and, when training, their Adams) from
        pnf_<iter>.pth, if the conf learns them and the file exists."""
        path = pnf_path(self.base_exp_dir, iter_step)
        if self.cams is None or not os.path.exists(path):
            return
        opts = self.trainer.camera_optimizers() if self.trainer else []
        load_pnf_checkpoint(path, self.cams, *opts)
        log.info("loaded learned cameras %s", path)

    def save_checkpoint(self) -> str:
        path = checkpoint_path(self.base_exp_dir, self.iter_step)
        save_training_checkpoint(path, self.model, self.iter_step, self.trainer.optimizer)
        if self.cams is not None:
            save_pnf_checkpoint(pnf_path(self.base_exp_dir, self.iter_step), self.cams,
                                self.iter_step, *self.trainer.camera_optimizers())
        return path

    # -- training -------------------------------------------------------------

    def train(self) -> dict | None:
        """Train to ``end_iter`` -> the closing ``val_all_imgs`` summary (None
        when a SIGTERM stopped the run after its checkpoint), on every rank.

        Steps run in windows of K = ``train.steps_per_call`` (``StepDispatch``:
        graph replays on the card), K clipped as the JAX runner clips it: it
        divides every cadence (metric writes every 10 steps, report, save,
        validation, mesh), the steps left, the resume iteration and
        ``resample_from``, so that windows end on every event and the run is
        the K = 1 run: the same pixel and jitter streams, the same logged
        steps, checkpoints, validations and meshes. Metrics come back once
        per window, and only when a step of it is due. Across ranks each
        batch is cut to the rank's block after it was drawn, and rank 0
        writes every file."""
        tcfg, world = self.tcfg, self.world
        writer = MetricsWriter(os.path.join(self.base_exp_dir, "logs")) if world.lead else None
        # the faithful full-width core up to resample_from, the resampled core
        # after it (the JAX runner's one program switch)
        resample_boundary = 0
        if self.nets.renderer.n_render_samples > 0 and tcfg.resample_from > self.iter_step:
            resample_boundary = min(tcfg.resample_from, tcfg.end_iter)
        faithful = dataclasses.replace(
            self.nets, renderer=dataclasses.replace(self.nets.renderer, n_render_samples=0))
        res_step = tcfg.end_iter - self.iter_step
        k = window_size(tcfg, res_step, self.iter_step, resample_boundary)

        # SIGTERM asks for a checkpoint and a clean exit at the next window
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
        dispatch = StepDispatch(self.trainer)
        profile_dir = os.environ.get(debug.PROFILE_ENV) if world.lead else None
        profiled = contextlib.ExitStack()
        window_end = time.perf_counter()
        try:
            for _ in range(res_step // k):
                # image draw and pixel sampling interleave per step exactly as
                # with K = 1 (the permutation refill can land mid-window)
                batches = []
                for _j in range(k):
                    idx = int(image_perm[perm_pos % len(image_perm)])
                    batch = self.store.sample_pixels(idx, tcfg.batch_size, self.rng)
                    batches.append(shard_batch(batch, world, tcfg.grad_accum))
                    perm_pos += 1
                    if perm_pos % len(image_perm) == 0:
                        image_perm = self.rng.permutation(n_images)
                first = self.iter_step + 1
                if profile_dir and self.iter_step <= 10 < self.iter_step + k:
                    # the windows that hold steps 10-15, or the run's end first
                    last = min(self.iter_step + k * -(-(16 - self.iter_step) // k), tcfg.end_iter)
                    profiled.enter_context(
                        debug.profile_trace(profile_dir, f"train_steps_{first}_{last}.json"))
                steps = range(self.iter_step, self.iter_step + k)
                window = dispatch.run(
                    steps, [self.nets if s + 1 > resample_boundary else faithful for s in steps],
                    batches)
                self.iter_step = step = self.iter_step + k
                if step - k <= 15 < step:
                    profiled.close()
                # the window's rays over the host time since the last one ended
                now = time.perf_counter()
                rays_ps = k * tcfg.batch_size / max(now - window_end, 1e-9)
                window_end = now
                due = [s for s in range(first, step + 1)
                       if s % 10 == 0 or s <= 1 or s % tcfg.report_freq == 0]
                if due and world.lead:
                    rows = window.read()
                    for s in due:
                        metrics = rows[s - first]
                        if s % 10 == 0 or s <= 1:
                            writer.write(s, {**metrics, "rays_per_sec": rays_ps})
                        if s % tcfg.report_freq == 0:
                            log.info("iter %d loss=%.5f psnr=%.3f rays/s=%.0f", s,
                                     metrics["loss"], metrics["psnr"], rays_ps)
                if world.any(self._preempt_signal is not None):
                    # before the periodic validations: the grace window is short
                    if world.lead:
                        self.save_checkpoint()
                        writer.flush()
                    world.barrier()
                    log.warning("preemption signal: checkpoint saved at iter %d; rerun with "
                                "--is_continue to resume", step)
                    return None
                wrote = False
                if step % tcfg.save_freq == 0:
                    wrote = True
                    if world.lead:
                        self.save_checkpoint()
                if step % tcfg.val_freq == 0:
                    # every rank draws the image, so that the host streams stay equal
                    idx = int(self.rng.integers(n_images))
                    wrote = True
                    if world.lead:
                        self.validate_image(idx)
                if step % tcfg.val_mesh_freq == 0:
                    wrote = True
                    if world.lead:
                        res, world_space = mesh_resolution(step)
                        self.validate_mesh(world_space=world_space, resolution=res)
                if wrote:
                    world.barrier()
        finally:
            profiled.close()
            if prev_sigterm is not None:
                signal.signal(signal.SIGTERM, prev_sigterm)
            if writer is not None:
                writer.close()
        log_programs()
        summary = self.val_all_imgs(resolution_level=2, both_mask=True) if world.lead else None
        return world.broadcast_object(summary)

    # -- validation -----------------------------------------------------------

    def resolved_cams(self) -> tuple[np.ndarray, np.ndarray]:
        """Every camera's c2w and inverse intrinsics [n, 4, 4] on the host,
        the learned ones for a learnable conf."""
        return resolve_cams(self.cams, self.scene_data.pose_all,
                            self.scene_data.intrinsics_all_inv)

    def _render(self, idx: int, resolution_level: int) -> dict:
        poses, intrin_inv = self.resolved_cams()
        return self.renderer.render_image(self.model, poses[idx], intrin_inv[idx],
                                          resolution_level, self.iter_step)

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

    # -- mesh -----------------------------------------------------------------

    def validate_mesh(self, world_space: bool = False, resolution: int = 256,
                      threshold: float = 0.0) -> dict:
        """-SDF iso-surface at ``threshold`` over the object bbox ->
        ``meshes/<iter:08d>.ply``; returns its path, vertex and triangle
        counts and the seconds of each part (the grid through K1
        synchronised, the copy to the host, marching, the PLY write)."""
        sdf_net = self.model.sdf_network_fine

        def neg_sdf(pts):
            return -sdf_net.sdf_value(pts)[:, 0]

        before = trace.host()
        verts, tris = extract_geometry(
            self.scene_data.object_bbox_min, self.scene_data.object_bbox_max,
            resolution, threshold, neg_sdf, device=self.device,
        )
        if world_space and len(verts):
            sm = self.scene_data.scale_mats_np[0]
            verts = verts * sm[0, 0] + sm[:3, 3][None]
        path = os.path.join(self.base_exp_dir, "meshes", f"{self.iter_step:08d}.ply")
        with trace.span("mesh.ply"):
            save_ply(path, verts, tris)
        seconds = trace.seconds("mesh.", since=before)
        log.info("mesh %s: %d vertices, %d triangles at %d^3 (%s)", path, len(verts), len(tris),
                 resolution, {k: round(v, 3) for k, v in seconds.items()})
        return {"path": path, "resolution": resolution, "world_space": world_space,
                "n_verts": int(len(verts)), "n_tris": int(len(tris)), "seconds": seconds}

    # -- novel views ----------------------------------------------------------

    def interpolate_view(self, idx0: int, idx1: int) -> str:
        """The novel-view sweep between cameras ``idx0`` and ``idx1`` ->
        ``render/<iter:08d>_<idx0>_<idx1>.mp4``."""
        poses, intrin_inv = self.resolved_cams()
        frames = interpolate_frames(self.renderer, self.model, poses, intrin_inv, idx0, idx1,
                                    step=self.iter_step)
        path = os.path.join(self.base_exp_dir, "render",
                            f"{self.iter_step:08d}_{idx0}_{idx1}.mp4")
        write_video(path, frames)
        return path

    # -- camera poses ---------------------------------------------------------

    def get_gt_poses(self, cameras_npz_path: str) -> np.ndarray | None:
        """c2w poses [n, 4, 4] from a cameras npz, keyed by image stem
        (``world_mat_<stem>``) or by index (``world_mat_<i>``), ``scale_mat``
        the identity where missing; None if the file or a camera is missing."""
        if not os.path.exists(cameras_npz_path):
            return None
        stems = [os.path.splitext(os.path.basename(f))[0] for f in self.scene_data.images_lis]
        poses = []
        with np.load(cameras_npz_path) as camera_dict:
            for i, stem in enumerate(stems):
                key = next((k for k in (f"world_mat_{stem}", f"world_mat_{i}")
                            if k in camera_dict), None)
                if key is None:
                    return None
                world_mat = camera_dict[key].astype(np.float32)
                scale_key = key.replace("world_mat", "scale_mat")
                scale_mat = (camera_dict[scale_key] if scale_key in camera_dict
                             else np.eye(4)).astype(np.float32)
                _, pose = load_K_Rt_from_P(None, (world_mat @ scale_mat)[:3, :4])
                poses.append(pose.astype(np.float32))
        return np.stack(poses)

    def show_cam_pose(self, gt_cameras_path: str | None = None) -> str:
        """The initial, learned and ground-truth camera poses ->
        ``cam_poses/pose_<iter:06d>.npz`` (``init_c2w``; ``learned_c2w`` and
        ``learned_K`` for a learnable conf; ``gt_c2w`` when the file
        ``dataset.gt_cameras_name``, by default the render cameras, resolves)
        and their frustums in a PNG beside it."""
        out = {"init_c2w": np.asarray(self.scene_data.pose_all)}
        pose_sets = {"init": out["init_c2w"]}
        fx = float(self.scene_data.focal)
        if self.cams is not None:
            with torch.no_grad():
                out["learned_c2w"] = self.cams.all_c2w().cpu().numpy()
                out["learned_K"] = learn_intrin_K(self.cams.fx, self.cams.H, self.cams.W,
                                                  self.cams.order).cpu().numpy()
            pose_sets["learned"] = out["learned_c2w"]
            fx = float(out["learned_K"][0, 0])
        if gt_cameras_path is None:
            gt_cameras_path = os.path.join(
                self.scene_data.data_dir,
                self.conf.get_string("dataset.gt_cameras_name",
                                     default=self.scene_data.render_cameras_name))
        gt = self.get_gt_poses(gt_cameras_path)
        if gt is not None:
            out["gt_c2w"] = gt
            pose_sets["gt"] = gt
        path = os.path.join(self.base_exp_dir, "cam_poses", f"pose_{self.iter_step:06d}.npz")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez(path, **out)
        plot_cam_poses(path.replace(".npz", ".png"), pose_sets, self.scene_data.H,
                       self.scene_data.W, fx)
        return path
