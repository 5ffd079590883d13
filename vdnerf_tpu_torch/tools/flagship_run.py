"""Flagship-scale convergence run on one card.

    python -m vdnerf_tpu_torch.tools.flagship_run [--iters 25000] [--out DIR]
        [--fast-bg] [--render-samples 96] [--resample-from 4170]
        [--resample-frac 1.0] [--fp32] [--fused] [--gpu 0]

Counterpart of ``tools/flagship_run.py``, with the same flags and modes
(``--seed`` and ``--gpu`` added). It trains the
womsk_white-dimension model (8x256 SDF, 4x256 colour head, 8x256 background
NeRF, 64+64 inside and 32 outside samples, batch 512) on an analytic scene
(``data/synthetic.py`` ``make_compound_scene``: 24 shaded views of 256^2),
then

- tracks the masked PSNR at resolution level 2 on 4 fixed views, with the
  eikonal error, every ``--val-every`` steps;
- saves the checkpoint (``checkpoints/ckpt_<iters>.pth``);
- renders the masked full-resolution PSNR over 4 evenly spaced views;
- extracts the ``--resolution``^3 mesh through K1, cleans it against the
  multi-view visual hull and measures its Chamfer distance to the analytic
  surface extracted at the same resolution (``mesh/qc.py`` ``geometry_qc``),
  with every edge count (watertight: each edge shared by two triangles).

Training goes through :class:`~vdnerf_tpu_torch.train.step.Trainer` and
:class:`~vdnerf_tpu_torch.train.dispatch.StepDispatch` (on the card, each step
a replay of the captured step) in windows of 10 steps (fewer where 10 does
not divide ``--val-every``, ``--iters`` and ``--resample-from``), on the
faithful core before ``--resample-from`` and the resampled core after it.
The SDF block is bf16 unless ``--fp32`` (``models/precision.py``). K2-K5 run
on the card in every mode; their operands follow the policy: bf16 under the
bf16 policy, f32 (the split mode, JAX's default ``linear``s) under ``--fp32``,
unless ``--fused`` (or ``VDNERF_FUSED=1``) asks for JAX's fused path, whose
operands are bf16. The report's ``fused_mlp`` is true exactly then, as the
JAX tool's is under ``--fused``; ``mlp_operands`` names the operand type.

Train modes: ``womsk`` (the womsk_white loss: no mask, white background, a
textured backdrop the background NeRF must model), ``masked`` (mask BCE on
the white-background scene, no outside samples) and ``wdepth`` (womsk plus
the 96-channel depth head and the NeRF's dpt head, distilled from sin/cos
encodings of the scene's true depth). ``--learn`` trains the poses and the
focal from COLMAP-grade noisy cameras (the mesh is then extracted through the
camera-centre Umeyama similarity into the true frame); ``--learn-frozen``
keeps the same noisy cameras fixed, as its control. PSNR is always taken
over the true object masks (``eval_mask/`` for the textured scenes).

Writes ``<out>/flagship_report.json`` with the JAX report's keys, where the
two that time an XLA compile are the dispatch's eager warm-up and capture
instead (``startup_warmup_capture_s``, ``resample_onset_warmup_capture_s``),
and ``card`` (``nvidia-smi``'s ``name, power.limit``) and ``launches`` (each
kernel's launches over the run) beside them. Runs on ``cuda:<--gpu>``; a
caller of :func:`main` may pass ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import cv2 as cv
import numpy as np
import torch

from vdnerf_tpu_torch.data.cameras import LearnedCameras, perturb_poses
from vdnerf_tpu_torch.data.dataset import SceneData
from vdnerf_tpu_torch.data.rays import RayStore
from vdnerf_tpu_torch.data.synthetic import GEOMETRIES, _sphere_trace, make_compound_scene
from vdnerf_tpu_torch.io import (
    checkpoint_path,
    pnf_path,
    save_pnf_checkpoint,
    save_training_checkpoint,
)
from vdnerf_tpu_torch.mesh.qc import geometry_qc
from vdnerf_tpu_torch.models.fields import NeRFConfig, RenderConfig, SDFConfig
from vdnerf_tpu_torch.models.precision import env_fused, matmul_dtype, mlp_operand_dtype
from vdnerf_tpu_torch.ops.kernels import build
from vdnerf_tpu_torch.ops.renderer import NeuSModel, NeuSNetworks, RendererConfig
from vdnerf_tpu_torch.train.config import TrainConfig
from vdnerf_tpu_torch.train.dispatch import StepDispatch
from vdnerf_tpu_torch.train.step import Trainer
from vdnerf_tpu_torch.train.validate import ImageRenderer, resolve_cams, val_image_metrics
from vdnerf_tpu_torch.utils.device import configure_numerics, resolve_device
from vdnerf_tpu_torch.utils.hocon import Config
from vdnerf_tpu_torch.utils.so3 import umeyama

# steps per window, as the JAX tool's k_scan
WINDOW = 10
# the wdepth teacher's channels (sin and cos of 48 frequencies)
DPT_DIM = 96


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--iters", type=int, default=25000)
    p.add_argument("--out", type=str, default="flagship_out")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--views", type=int, default=24)
    p.add_argument("--img-res", type=int, default=256)
    p.add_argument("--val-every", type=int, default=2500)
    p.add_argument("--fp32", action="store_true", help="the SDF block in f32, not bf16")
    p.add_argument("--train-mode", choices=["womsk", "masked", "wdepth"], default="womsk")
    p.add_argument("--fused", action="store_true",
                   help="JAX's fused MLP path: K2-K5 on bf16 operands (as VDNERF_FUSED=1)")
    p.add_argument("--fast-bg", action="store_true",
                   help="skip_bg_inside: the background NeRF on the outside block only")
    p.add_argument("--render-samples", type=int, default=0,
                   help="importance-resampled render core width "
                        "(RendererConfig.n_render_samples; 0 = faithful)")
    p.add_argument("--resample-from", type=int, default=0,
                   help="the faithful core through this iteration, the resampled core after")
    p.add_argument("--resample-frac", type=float, default=0.25,
                   help="the resample PDF's uniform floor (RendererConfig.resample_uniform_frac)")
    p.add_argument("--learn", action="store_true",
                   help="noisy initial poses + learned pose/focal refinement")
    p.add_argument("--learn-frozen", action="store_true",
                   help="control for --learn: the same noisy poses, frozen")
    p.add_argument("--shading", choices=["fixed", "camlight", "glossy"], default="fixed")
    p.add_argument("--geometry", choices=["compound", "arch"], default="compound",
                   help="analytic scene geometry (data/synthetic.py GEOMETRIES); the "
                        "Chamfer ground truth follows it")
    p.add_argument("--depth-loss-scale", type=float, default=1.0,
                   help="wdepth distillation-loss multiplier (train.depth_loss_scale)")
    p.add_argument("--feat-max-freq", type=float, default=5.0,
                   help="wdepth teacher-feature top frequency (rad per depth unit)")
    p.add_argument("--seed", type=int, default=0,
                   help="offsets the weights' (0), the training generator's (1) and the "
                        "pixel sampler's (0) seeds; 0 gives the JAX tool's seeds")
    p.add_argument("--gpu", type=int, default=0, help="CUDA device index")
    return p


def card_line() -> str | None:
    """``nvidia-smi``'s ``name, power.limit`` of the cards, or None without it."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def window_steps(val_every: int, iters: int, resample_from: int) -> int:
    """Steps per window: 10, halved until it divides every cadence (the JAX
    tool's ``k_scan`` rule)."""
    k = WINDOW
    while val_every % k or iters % k or resample_from % k:
        k //= 2
    return max(k, 1)


def masked_metrics(img: np.ndarray, gt: np.ndarray, eval_mask: np.ndarray) -> tuple[float, float]:
    """(L1, PSNR) of a render against its ground truth over the object mask
    (``eval_mask`` > 0.1), as the JAX tool's ``masked_psnr`` takes them."""
    return val_image_metrics(img, gt, (eval_mask > 0.1).astype(np.float32))


def write_teacher_features(sd, out_dir: str, geometry: str, max_freq: float) -> None:
    """The wdepth teacher: sin/cos encodings of 48 frequencies of each view's
    true depth at half resolution, ``image/00/<stem>.npy`` [96, H/2, W/2]
    (the layout the VDN cycle's wavelet predict writes), as the JAX tool."""
    scene_sdf = GEOMETRIES[geometry][0]
    fH, fW = sd.H // 2, sd.W // 2
    feat_dir = os.path.join(out_dir, "image", "00")
    os.makedirs(feat_dir, exist_ok=True)
    freqs = np.linspace(0.5, max_freq, DPT_DIM // 2)
    for i in range(sd.n_images):
        c2w = sd.pose_all[i].astype(np.float64)
        Kinv = np.linalg.inv(sd.intrinsics_all[i][:3, :3]).astype(np.float64)
        xs, ys = np.meshgrid(np.arange(fW), np.arange(fH))
        pix = np.stack([(xs + 0.5) * sd.W / fW, (ys + 0.5) * sd.H / fH, np.ones_like(xs)],
                       axis=-1).astype(np.float64)
        d = pix @ Kinv.T
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        d = d @ c2w[:3, :3].T
        o = np.broadcast_to(c2w[:3, 3], d.shape)
        t, hit = _sphere_trace(o, d, 0.05, 4.0, sdf=scene_sdf)
        depth = np.where(hit, t, 3.0)
        feats = np.concatenate([np.sin(depth[None] * freqs[:, None, None]),
                                np.cos(depth[None] * freqs[:, None, None])], axis=0)
        stem = os.path.splitext(os.path.basename(sd.images_lis[i]))[0]
        np.save(os.path.join(feat_dir, f"{stem}.npy"), feats.astype(np.float32))


def flagship_nets(train_mode: str, fast_bg: bool, render_samples: int, resample_frac: float):
    """The womsk_white dimensions; ``masked`` drops the background NeRF,
    ``wdepth`` adds the 96-channel depth head and the NeRF's dpt head."""
    wdepth = train_mode == "wdepth"
    return NeuSNetworks(
        sdf=SDFConfig(), color=RenderConfig(),
        nerf=NeRFConfig(gen_depth_feats=wdepth, dpt_dim=DPT_DIM),
        renderer=RendererConfig(n_outside=0 if train_mode == "masked" else 32,
                                skip_bg_inside=fast_bg, n_render_samples=render_samples,
                                resample_uniform_frac=resample_frac),
        depth=RenderConfig(d_out=DPT_DIM) if wdepth else None,
    )


def flagship_train_config(args):
    """The JAX tool's schedule: warm-up to iters/50 (at least 100), anneal to
    iters/4 (at least 1000), distillation from iters/10 with a ramp of
    iters/10; with ``--learn`` the cameras refine from the first step."""
    wdepth = args.train_mode == "wdepth"
    womsk = args.train_mode in ("womsk", "wdepth")
    tcfg = TrainConfig(
        batch_size=args.batch, end_iter=args.iters,
        warm_up_end=max(args.iters // 50, 100),
        anneal_end=max(args.iters // 4, 1000),
        use_white_bkgd=True,
        use_mask=not womsk, mask_weight=0.0 if womsk else 0.1,
        extract_depth=wdepth,
        rgb_dims=3,
        depth_start_iter=args.iters // 10 if wdepth else 0,
        depth_ramp_iters=max(args.iters // 10, 1) if wdepth else 5000,
        depth_loss_scale=args.depth_loss_scale if wdepth else 1.0,
        bf16=not args.fp32,
    )
    if args.learn:
        tcfg = dataclasses.replace(
            tcfg, learnable=True, focal_lr=5e-4, pose_lr=5e-4,
            focal_lr_gamma=0.9, pose_lr_gamma=0.9,
            step_size=max(args.iters // 50, 100),
            start_refine_pose_iter=-1, start_refine_focal_iter=-1,
        )
    return tcfg


def _rot_err_deg(a, b) -> float:
    R = np.matmul(a[:, :3, :3], np.swapaxes(b[:, :3, :3], 1, 2))
    tr = np.clip((np.trace(R, axis1=1, axis2=2) - 1.0) / 2.0, -1, 1)
    return float(np.degrees(np.arccos(tr)).mean())


def _center_err(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64)[:, :3, 3]
                                - np.asarray(b, np.float64)[:, :3, 3], axis=-1).mean())


def pose_refinement(cams, perturbed, gt_poses):
    """Learned against true cameras, raw and with the camera-centre Umeyama
    similarity quotiented out -> (stats, (s, R, t))."""
    with torch.no_grad():
        learned = cams.all_c2w().cpu().numpy()
        r, t, fx = (cams.r.cpu().numpy(), cams.t.cpu().numpy(),
                    float(cams.fx.detach().cpu().reshape(-1)[0]))
    gt64 = np.asarray(gt_poses, np.float64)
    learned64 = np.asarray(learned, np.float64)
    s_g, R_g, t_g = umeyama(learned64[:, :3, 3], gt64[:, :3, 3])
    aligned = learned64.copy()
    aligned[:, :3, :3] = np.einsum("ij,njk->nik", R_g, learned64[:, :3, :3])
    aligned[:, :3, 3] = s_g * learned64[:, :3, 3] @ R_g.T + t_g
    stats = {
        "init_rot_err_deg": round(_rot_err_deg(perturbed, gt_poses), 4),
        "final_rot_err_deg": round(_rot_err_deg(learned, gt_poses), 4),
        "init_center_err": round(_center_err(perturbed, gt_poses), 5),
        "final_center_err": round(_center_err(learned, gt_poses), 5),
        "aligned_rot_err_deg": round(_rot_err_deg(aligned, gt64), 4),
        "aligned_center_err": round(_center_err(aligned, gt64), 5),
        "gauge_scale": round(s_g, 6),
        "gauge_rot_deg": round(float(np.degrees(np.arccos(
            np.clip((np.trace(R_g) - 1.0) / 2.0, -1, 1)))), 4),
        "pose_param_delta_max_r": round(float(np.abs(r).max()), 5),
        "pose_param_delta_max_t": round(float(np.abs(t).max()), 5),
        "focal_coef": round(fx, 5),
    }
    return stats, (s_g, R_g, t_g)


def main(argv=None, device=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.learn and args.learn_frozen:
        raise SystemExit("--learn and --learn-frozen are mutually exclusive "
                         "(the frozen run is the control for --learn)")

    dev = resolve_device(device, args.gpu)
    configure_numerics()
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    card = card_line() if on_card else None
    os.makedirs(args.out, exist_ok=True)
    print(f"device: {dev}" + (f" ({card})" if card else ""), flush=True)

    wdepth = args.train_mode == "wdepth"
    womsk = args.train_mode in ("womsk", "wdepth")
    t_gen = time.time()
    make_compound_scene(args.out, n_images=args.views, H=args.img_res, W=args.img_res,
                        background="textured" if womsk else "white",
                        shading=args.shading, geometry=args.geometry)
    print(f"scene: {args.views} views {args.img_res}^2 ({args.train_mode}, {args.shading}) "
          f"rendered in {time.time() - t_gen:.1f}s", flush=True)

    sd = SceneData(Config({"data_dir": args.out, "img_dir": "image", "depth_dir": "00",
                           "render_cameras_name": "image/cameras_sphere.npz",
                           "object_cameras_name": "image/cameras_sphere.npz"}))
    if wdepth:
        t_feat = time.time()
        write_teacher_features(sd, args.out, args.geometry, args.feat_max_freq)
        print(f"teacher features: {sd.n_images} views {DPT_DIM}x{sd.H // 2}x{sd.W // 2} in "
              f"{time.time() - t_feat:.1f}s", flush=True)
    store = RayStore(sd.images_lis, sd.masks_lis, sd.depth_lis, with_depth=wdepth)

    nets = flagship_nets(args.train_mode, args.fast_bg, args.render_samples,
                         args.resample_frac)
    tcfg = flagship_train_config(args)
    perturbed = None
    if args.learn or args.learn_frozen:
        perturbed = perturb_poses(sd.pose_all, np.random.default_rng(5))
    policy = matmul_dtype(tcfg.bf16)
    fused = args.fused or env_fused()
    mlp_dtype = mlp_operand_dtype(policy, fused)
    model = NeuSModel(nets, 0.3, torch.Generator().manual_seed(args.seed), policy,
                      mlp_dtype=mlp_dtype).to(dev)
    if args.learn:
        cams = LearnedCameras(perturbed, float(sd.focal), sd.H, sd.W).to(dev)
    else:
        cams = {"pose_all": torch.as_tensor(perturbed if args.learn_frozen else sd.pose_all,
                                            device=dev),
                "intrin_inv_all": torch.as_tensor(sd.intrinsics_all_inv, device=dev)}
    trainer = Trainer(tcfg, model, cams, torch.Generator(device=dev).manual_seed(args.seed + 1))
    dispatch = StepDispatch(trainer)
    k = window_steps(args.val_every, args.iters, args.resample_from)
    faithful = nets
    if args.render_samples and args.resample_from > 0:
        faithful = dataclasses.replace(
            nets, renderer=dataclasses.replace(nets.renderer, n_render_samples=0))
    img_renderer = ImageRenderer(nets, tcfg, sd.H, sd.W)

    def eval_mask_at(idx: int, res_level: int) -> np.ndarray:
        """The object mask: eval_mask/ for the textured scenes (their training
        masks are all white), the training mask otherwise."""
        if not womsk:
            return store.mask_at(idx, res_level)
        stem = os.path.splitext(os.path.basename(sd.images_lis[idx]))[0]
        m = cv.imread(os.path.join(args.out, "image", "eval_mask", f"{stem}.png"), 0) / 255.0
        if res_level > 1:
            m = cv.resize(m, (sd.W // res_level, sd.H // res_level),
                          interpolation=cv.INTER_AREA)
        return m[..., None]

    def masked_psnr(idx: int, res_level: int, step: int) -> tuple[float, float, float]:
        # through the learned cameras on a --learn run
        poses, intrin_inv = resolve_cams(cams if args.learn else None,
                                         perturbed if args.learn_frozen else sd.pose_all,
                                         sd.intrinsics_all_inv)
        out = img_renderer.render_image(model, poses[idx], intrin_inv[idx], res_level, step)
        gt = store.image_at(idx, res_level) / 255.0
        l1, psnr = masked_metrics(out["img"], gt, eval_mask_at(idx, res_level))
        return l1, psnr, out["gradient_error"]

    # the fixed validation panel: 4 evenly spaced views, averaged
    val_views = [int(i) for i in np.linspace(0, sd.n_images - 1, 4).round()]

    curve = []
    last_metrics = {}
    rng = np.random.default_rng(args.seed)
    build.reset_launches()
    sync()
    t0 = time.time()
    startup_s = onset_s = None
    # windows that ran a program's eager warm-up steps or its capture
    setup_wall, setup_windows = 0.0, 0
    val_wall = 0.0
    for i0 in range(0, args.iters, k):
        steps = range(i0, i0 + k)
        batches = [store.sample_pixels(s % sd.n_images, tcfg.batch_size, rng) for s in steps]
        core = faithful if i0 < args.resample_from else nets
        n_setup = sum(dispatch.eager_steps.values()) + len(dispatch.programs)
        sync()
        t_w = time.time()
        window = dispatch.run(steps, [core] * k, batches)
        if sum(dispatch.eager_steps.values()) + len(dispatch.programs) != n_setup:
            sync()
            setup_wall += time.time() - t_w
            setup_windows += 1
            if i0 == 0:
                startup_s = time.time() - t0
                print(f"first window (eager warm-up + capture) wall: {startup_s:.1f}s",
                      flush=True)
            elif i0 == args.resample_from and faithful is not nets:
                onset_s = time.time() - t_w
                print(f"resample-onset window (eager warm-up + capture) wall: {onset_s:.1f}s",
                      flush=True)
        it = i0 + k
        if it % 500 == 0 or it == k:
            elapsed = time.time() - t0
            m = window.read()[-1]
            dl = f" dfeat {m['depth_loss']:.4f}" if "depth_loss" in m else ""
            print(f"iter {it} train-psnr {m['psnr']:.2f} loss {m['loss']:.4f} "
                  f"s_val {m['s_val']:.4f}{dl} [{it * tcfg.batch_size / elapsed:.0f} rays/s]",
                  flush=True)
            last_metrics = m
        if it % args.val_every == 0 or it == args.iters:
            sync()
            t_val = time.time()
            vals = [masked_psnr(v, 2, it) for v in val_views]
            curve.append({"iter": it, "masked_psnr_res2": float(np.mean([v[1] for v in vals])),
                          "l1": float(np.mean([v[0] for v in vals])),
                          "gradient_error": float(np.mean([v[2] for v in vals])),
                          "n_views": len(val_views), "wall_s": time.time() - t0})
            print(f"  val @ {it}: masked PSNR {curve[-1]['masked_psnr_res2']:.2f} dB (mean of "
                  f"{len(val_views)} fixed views)  eikonal {curve[-1]['gradient_error']:.4f}",
                  flush=True)
            val_wall += time.time() - t_val
    sync()
    train_wall = time.time() - t0
    rays_per_sec = args.iters * tcfg.batch_size / train_wall
    # steady state: without the windows of eager warm-up and capture, and
    # without the validation renders
    steady_rays_per_sec = (
        (args.iters - setup_windows * k) * tcfg.batch_size
        / max(train_wall - setup_wall - val_wall, 1e-9))
    train_launches = dict(build.LAUNCHES)
    print(f"trained {args.iters} iters in {train_wall:.1f}s ({rays_per_sec:.0f} rays/s incl. "
          f"warm-up; {steady_rays_per_sec:.0f} rays/s steady-state excl. {setup_wall:.1f}s of "
          f"warm-up and capture in {setup_windows} windows); launches {train_launches}",
          flush=True)

    save_training_checkpoint(checkpoint_path(args.out, args.iters), model, args.iters,
                             trainer.optimizer)
    if args.learn:
        save_pnf_checkpoint(pnf_path(args.out, args.iters), cams, args.iters,
                            *trainer.camera_optimizers())

    finals = [masked_psnr(i, 1, args.iters)
              for i in range(0, sd.n_images, max(sd.n_images // 4, 1))]
    final_psnr = float(np.mean([f[1] for f in finals]))
    final_eik = float(np.mean([f[2] for f in finals]))
    print(f"final full-res masked PSNR {final_psnr:.2f} dB (eikonal {final_eik:.4f})",
          flush=True)

    pose_stats = None
    sdf_net = model.sdf_network_fine
    if args.learn:
        pose_stats, (s_g, R_g, t_g) = pose_refinement(cams, perturbed, sd.pose_all)
        print(f"pose refine: {pose_stats}", flush=True)
        R_t = torch.as_tensor(R_g, dtype=torch.float32, device=dev)
        t_t = torch.as_tensor(t_g, dtype=torch.float32, device=dev)

        def neg_sdf(pts):  # pts in the true frame, queried in the learned one
            return -sdf_net.sdf_value(((pts - t_t) @ R_t) / s_g)[:, 0]
    else:
        def neg_sdf(pts):
            return -sdf_net.sdf_value(pts)[:, 0]

    eval_masks = np.stack([eval_mask_at(i, 1)[..., 0] > 0.5
                           for i in range(sd.n_images)]).astype(np.uint8)
    # the hull of the cameras the mesh lives under: the true ones (a --learn
    # mesh is gauge-aligned into the true frame), or the frozen noisy ones
    if args.learn_frozen:
        world_mats = np.stack([sd.intrinsics_all[i] @ np.linalg.inv(perturbed[i])
                               for i in range(sd.n_images)])
    else:
        world_mats = np.stack(sd.world_mats_np)
    gt_sdf = GEOMETRIES[args.geometry][1]
    qc = geometry_qc(neg_sdf, lambda p: -gt_sdf(p), sd.object_bbox_min, sd.object_bbox_max,
                     args.resolution, eval_masks, world_mats,
                     ply_prefix=os.path.join(args.out, "flagship_mesh"),
                     log=lambda m: print(m, flush=True), device=dev)
    cmanifold = (
        {k_: v for k_, v in qc["clean"].items()
         if k_ in ("n_edges", "boundary_edges", "nonmanifold_edges", "watertight")}
        if qc["clean"] else
        {"n_edges": 0, "boundary_edges": 0, "nonmanifold_edges": 0, "watertight": False})

    report = {
        "config": {
            "iters": args.iters, "batch": args.batch, "views": args.views,
            "img_res": args.img_res, "mesh_res": args.resolution,
            "model": ("flagship womsk_white_wdepth dims (8x256 SDF, 64+64+32 samples, "
                      "96-ch depth head)" if wdepth else
                      "flagship womsk_white dims (8x256 SDF, 64+64+32 samples)"),
            "train_mode": args.train_mode,
            "shading": args.shading,
            "geometry": args.geometry,
            "learn_cameras": args.learn,
            "learn_frozen_control": args.learn_frozen,
            "gauge_aligned_geometry": bool(args.learn),
            # the colour head, depth head and background NeRF run through
            # K2-K5: bf16 operands under --fp32 only with --fused
            "bf16": not args.fp32, "fused_mlp": fused,
            "mlp_operands": "bf16" if mlp_dtype == torch.bfloat16 else "f32",
            "fast_bg": args.fast_bg,
            "render_samples": args.render_samples,
            "resample_from": args.resample_from,
            "resample_frac": args.resample_frac,
            "depth_loss_scale": args.depth_loss_scale if wdepth else None,
            "window_steps": k,
            "seed": args.seed,
            "device": str(dev),
        },
        "card": card,
        "train_wall_s": round(train_wall, 1),
        "startup_warmup_capture_s": round(startup_s, 1) if startup_s else None,
        "resample_onset_warmup_capture_s": round(onset_s, 1) if onset_s else None,
        "val_wall_s": round(val_wall, 1),
        "rays_per_sec": round(rays_per_sec, 1),
        "steady_rays_per_sec": round(steady_rays_per_sec, 1),
        "psnr_curve": curve,
        "final_masked_psnr_fullres": round(final_psnr, 3),
        "final_eikonal": round(final_eik, 5),
        "final_train_metrics": last_metrics,
        "pose_refinement": pose_stats,
        "mesh": qc["raw"],
        "mesh_clean": qc["clean"],
        "chamfer": qc["chamfer"],
        "launches": {"train": train_launches, "total": dict(build.LAUNCHES)},
    }
    with open(os.path.join(args.out, "flagship_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({
        "final_masked_psnr": report["final_masked_psnr_fullres"],
        "chamfer": report["chamfer"]["chamfer"],
        "watertight": cmanifold["watertight"],
        "boundary_edges": cmanifold["boundary_edges"],
        "train_wall_s": report["train_wall_s"],
    }), flush=True)
    return report


if __name__ == "__main__":
    main()
