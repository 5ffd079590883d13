"""The five-stage VDN cycle at full width on one card, through the port's CLIs.

    python -m vdnerf_tpu_torch.tools.vdn_cycle_run [--iters 12000] [--out DIR]
        [--shading camlight] [--depth-weight-scale 10] [--learn] [--gpu 0]
    python -m vdnerf_tpu_torch.tools.vdn_cycle_run --out DIR --skip-to-wdepth
        [--render-samples 96 --resample-from 4170 --resample-frac 1.0]
        [--leg-tag _rs96] [--seed N]
    python -m vdnerf_tpu_torch.tools.vdn_cycle_run --out DIR --cycle2
    python -m vdnerf_tpu_torch.tools.vdn_cycle_run --out DIR --eik-boost 0.1 0.3 1

Counterpart of ``tools/vdn_cycle_run.py``, with every flag and mode of it
(``--gpu`` added). On the compound (or arch) analytic scene, 24 textured views
of 256^2:

  1. train NeuS at the womsk_white dimensions   (``cli.main --mode train``)
  2. export the depth-from-SDF maps             (``cli.main --mode getfeats_<it>``)
  3. finetune the wavelet monodepth encoder     (``wavelet.finetune.finetune``)
  4. extract the 96-channel VDN features        (``wavelet.predict.main``)
  5. retrain NeuS with the distillation head on those features

then measures both legs against the analytic surface: the object-masked PSNR
and eikonal error at resolution level 2, the 512^3 mesh's Chamfer distance
after visual-hull cleaning (``mesh/qc.py``; the grid through K1), and the
exported argmax-weight depth against sphere-traced depth. ``--learn`` trains
the poses and the focal from COLMAP-grade noisy cameras in both legs and
measures through the camera-centre Umeyama similarity; ``--skip-to-wdepth``
reruns stage 5 alone on a completed cycle's features; ``--cycle2`` runs
stages 2-5 again from the distilled leg, the finetune warm-started from the
first cycle's encoder; ``--eik-boost`` continues the distilled leg at each
given eikonal weight.

Writes the JAX tool's files with its keys (``vdn_cycle_report.json``,
``vdn_cycle_report_wdepth<iters><tag>.json``, ``vdn_cycle2_report.json``,
``eik_boost_report<tag>.json``); each report's ``config`` adds ``gpu``,
``device`` and ``card`` (``nvidia-smi``'s ``name, power.limit``). Beside each
report, ``<report>_card.json`` holds every stage's wall seconds, the card's
peak memory (``torch.cuda.max_memory_allocated``) and the kernel launches.

Precision: one policy for every stage, as the JAX tool switches bf16 on for
its process: the SDF block is bf16 unless ``--fp32``, through
``VDNERF_BF16``, which the port's training and serving runners both read
(``models/precision.py``); the tool sets it for the length of :func:`main`
and restores it after. K2-K5's operands follow the policy there: bf16 by
default, f32 (the split mode) under ``--fp32`` unless ``VDNERF_FUSED=1``, as
the JAX tool's ``linear``s. The ``.conf`` text is the JAX tool's. The
side-car's finetune and predict run under deterministic cuDNN (no
benchmarking; :func:`deterministic_cudnn`), so that an arm repeats on a seed
as JAX's does on its device; both cuDNN flags are restored after each stage.

Card memory: before each stage the tool collects the previous stage's
objects (a training run's CUDA graphs and their shared pool, the eval
runner, the side-car and its loaders) and empties the allocator's cache, so
that each stage starts from the parameters alone.

Runs on ``cuda:<--gpu>``; a caller of :func:`main` may pass ``device="cpu"``.
The JAX tool's predict reads whichever checkpoint ``os.walk`` lists first;
this tool reads the last epoch's, and ``--cycle2`` warm-starts from the
first cycle's last epoch by number.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import time

import cv2 as cv
import numpy as np
import torch

from vdnerf_tpu_torch import cli
from vdnerf_tpu_torch.data.cameras import all_learned_c2w, perturb_poses, rays_grid
from vdnerf_tpu_torch.data.dataset import SceneData
from vdnerf_tpu_torch.data.synthetic import GEOMETRIES, _sphere_trace, make_compound_scene
from vdnerf_tpu_torch.mesh.qc import geometry_qc as run_qc
from vdnerf_tpu_torch.ops.kernels import build
from vdnerf_tpu_torch.runner import Runner
from vdnerf_tpu_torch.tools.flagship_run import card_line
from vdnerf_tpu_torch.train.validate import val_image_metrics
from vdnerf_tpu_torch.utils.device import resolve_device
from vdnerf_tpu_torch.utils.hocon import Config
from vdnerf_tpu_torch.utils.so3 import umeyama
from vdnerf_tpu_torch.wavelet import finetune as finetune_cli
from vdnerf_tpu_torch.wavelet import predict as predict_cli

BASE_CONF = """\
general {{
    base_exp_dir = {exp_dir}
    recording = []
}}
dataset {{
    data_dir = {data_dir}
    img_dir = image
    depth_dir = {depth_dir}
    render_cameras_name = image/{cam_npz}
    object_cameras_name = image/{cam_npz}
}}
train {{
    learning_rate = 5e-4
    learning_rate_alpha = 0.05
    end_iter = {iters}
    batch_size = {batch}
    steps_per_call = 10
    validate_resolution_level = 4
    warm_up_end = {warm_up}
    anneal_end = {anneal}
    use_white_bkgd = True
    save_freq = {iters}
    val_freq = {val_freq}
    val_mesh_freq = {iters}
    report_freq = 500
    igr_weight = {igr_weight}
    mask_weight = 0.0
    use_mask = False
{extra_train}
}}
model {{
    nerf {{
        D = 8, d_in = 4, d_in_view = 3, W = 256,
        multires = 10, multires_view = 4, output_ch = 4, skips = [4],
        rgb_dims = 3, use_viewdirs = True{nerf_extra}
    }}
    sdf_network {{
        d_out = 257
        d_in = 3
        d_hidden = 256
        n_layers = 8
        skip_in = [4]
        multires = 6
        bias = 0.5
        scale = 1.0
        geometric_init = True
        weight_norm = True
    }}
    variance_network {{ init_val = 0.3 }}
    rendering_network {{
        d_feature = 256
        mode = idr
        d_in = 9
        d_out = 3
        d_hidden = 256
        n_layers = 4
        weight_norm = True
        multires_view = 4
        squeeze_out = True
    }}
{depth_block}
    neus_renderer {{
        n_samples = 64
        n_importance = 64
        n_outside = 32
        up_sample_steps = 4
        perturb = 1.0
        skip_bg_inside = {fast_bg}{renderer_extra}
    }}
}}
"""

DEPTH_BLOCK = """\
    depth_extract_network {{
        d_feature = 256
        mode = idr
        d_in = 9
        d_out = {dpt_dim}
        d_hidden = 256
        n_layers = 4
        weight_norm = True
        multires_view = 4
        squeeze_out = True
    }}
"""

# the precision policy's switch, read by the training and serving runners
BF16_ENV = "VDNERF_BF16"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--iters", type=int, default=12000,
                   help="NeuS iters for BOTH training legs")
    p.add_argument("--wdepth-iters", type=int, default=None,
                   help="override iters for the distilled retrain leg only (default: --iters)")
    p.add_argument("--skip-to-wdepth", action="store_true",
                   help="reuse an existing --out dir's scene + VDN features (stages 1-4 of a "
                        "completed cycle) and run ONLY the distilled retrain leg; writes "
                        "exp_wdepth_<iters>/ and vdn_cycle_report_wdepth<iters>.json")
    p.add_argument("--out", type=str, default="vdn_cycle_out")
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--views", type=int, default=24)
    p.add_argument("--img-res", type=int, default=256)
    p.add_argument("--encoder", type=str, default="densenet",
                   help="wavelet encoder (densenet = the reference flagship)")
    p.add_argument("--wavelet-epochs", type=int, default=6)
    p.add_argument("--wavelet-bs", type=int, default=2)
    p.add_argument("--fp32", action="store_true", help="the SDF block in f32, not bf16")
    p.add_argument("--shading", choices=["fixed", "camlight", "glossy"], default="fixed",
                   help="'camlight' = light co-located with the camera + specular")
    p.add_argument("--geometry", choices=["compound", "arch"], default="compound",
                   help="analytic scene geometry (data/synthetic.py GEOMETRIES); also the "
                        "scene/case dir name")
    p.add_argument("--mesh-res", type=int, default=512,
                   help="geometry-QC grid resolution for both legs")
    p.add_argument("--depth-weight-scale", type=float, default=1.0,
                   help="scale on the ramped distillation loss (1.0 = the reference's schedule)")
    p.add_argument("--depth-start-iter", type=int, default=None,
                   help="absolute distillation onset iter for the wdepth leg (default: "
                        "leg_iters // 10)")
    p.add_argument("--cycle2", action="store_true",
                   help="run a SECOND cycle iteration from a completed cycle in --out "
                        "(exp_wdepth_c2); cycle-1 teacher artifacts are archived as *_c1")
    p.add_argument("--eik-boost", type=float, nargs="+", default=None,
                   help="from the completed cycle's distilled checkpoint, train --eik-iters "
                        "more iterations per listed igr_weight and measure eikonal + Chamfer "
                        "+ exported-depth error")
    p.add_argument("--eik-iters", type=int, default=3000,
                   help="extra iterations for each --eik-boost arm")
    p.add_argument("--anneal-end", type=int, default=None,
                   help="override the leg-relative cos-anneal horizon (default iters//4)")
    p.add_argument("--warm-up-end", type=int, default=None,
                   help="override the leg-relative lr warmup (default iters//50)")
    p.add_argument("--lr-end-iter", type=int, default=None,
                   help="clamp the cosine-lr horizon of the wdepth leg to this iteration")
    p.add_argument("--learn", action="store_true",
                   help="learned-cameras arm: BOTH training legs refine pose + focal from "
                        "COLMAP-grade-noisy initial cameras (cameras_sphere_noisy.npz)")
    p.add_argument("--render-samples", type=int, default=0,
                   help="importance-resampled render core width for the WDEPTH leg "
                        "(neus_renderer.n_render_samples; 0 = faithful full-width)")
    p.add_argument("--resample-frac", type=float, default=0.25,
                   help="resample PDF uniform floor (resample_uniform_frac)")
    p.add_argument("--resample-from", type=int, default=0,
                   help="faithful core through this iteration of the wdepth leg, resampled "
                        "core after (train.resample_from)")
    p.add_argument("--leg-tag", type=str, default="",
                   help="suffix for the --skip-to-wdepth leg's (or --eik-boost arms') exp "
                        "dir / conf / report names")
    p.add_argument("--seed", type=int, default=0,
                   help="--seed passed to the training CLI for the --skip-to-wdepth leg")
    p.add_argument("--gpu", type=int, default=0, help="CUDA device index")
    return p


# -- the card: stages, memory, launches --------------------------------------


def release(dev: torch.device) -> None:
    """Collect what the last stage left and return its cached blocks (a
    training run's graph pool among them) to the card."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


class StageLog:
    """Per stage: wall seconds, the card's peak memory and the kernel
    launches, printed as the stage ends."""

    def __init__(self, dev: torch.device, card: str | None):
        self.dev = dev
        self.card = card
        self.stages: dict[str, dict] = {}
        if dev.type == "cuda":
            # the allocator's statistics exist once the device has memory
            torch.zeros(1, device=dev)

    @contextlib.contextmanager
    def stage(self, name: str):
        on_card = self.dev.type == "cuda"
        release(self.dev)
        if on_card:
            torch.cuda.reset_peak_memory_stats(self.dev)
        before = dict(build.LAUNCHES)
        t0 = time.time()
        yield
        if on_card:
            torch.cuda.synchronize(self.dev)
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated(self.dev) if on_card else None
        launches = {k: build.LAUNCHES[k] - before[k] for k in before}
        self.stages[name] = {"wall_s": round(wall, 1), "peak_memory_bytes": peak,
                             "launches": launches}
        mem = f"{peak / 2**30:.2f} GiB" if peak is not None else "not measured (no card)"
        print(f"[stage] {name}: {wall:.1f} s, peak memory {mem}, launches {launches}"
              + (f" ({self.card})" if self.card else ""), flush=True)

    def write(self, report_path: str) -> str:
        path = report_path[:-len(".json")] + "_card.json"
        with open(path, "w") as f:
            json.dump({"card": self.card, "device": str(self.dev), "stages": self.stages},
                      f, indent=2)
        return path


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms, without benchmarking, for one
    side-car stage; both flags restored after. The side-car's step then
    repeats bit for bit on a seed (its resize is two products and its pads
    are built from slices), and so does the arm."""
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev


@contextlib.contextmanager
def precision_policy(bf16: bool):
    """``VDNERF_BF16`` for the length of the run, restored after."""
    prev = os.environ.get(BF16_ENV)
    os.environ[BF16_ENV] = "1" if bf16 else "0"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(BF16_ENV, None)
        else:
            os.environ[BF16_ENV] = prev


# -- QC ----------------------------------------------------------------------


def _stem(sd, idx: int) -> str:
    return os.path.splitext(os.path.basename(sd.images_lis[idx]))[0]


def _eval_mask(scene_dir: str, stem: str) -> np.ndarray:
    return cv.imread(os.path.join(scene_dir, "image", "eval_mask", f"{stem}.png"), 0)


def _render(runner: Runner, idx: int, res_level: int) -> dict:
    poses, intrin_inv = runner.resolved_cams()
    return runner.renderer.render_image(runner.model, poses[idx], intrin_inv[idx], res_level,
                                        runner.iter_step)


def object_masked_psnr(runner: Runner, scene_dir: str, n_views: int = 4,
                       res_level: int = 2) -> tuple[float, float]:
    """Masked PSNR (and the mean eikonal error) over the true object masks
    (``eval_mask/``; training uses the womsk white masks), through the
    learned cameras on a learnable conf."""
    sd = runner.scene_data
    psnrs, eiks = [], []
    for idx in range(0, sd.n_images, max(sd.n_images // n_views, 1)):
        out = _render(runner, idx, res_level)
        gt = runner.store.image_at(idx, res_level) / 255.0
        m = _eval_mask(scene_dir, _stem(sd, idx)) / 255.0
        if res_level > 1:
            m = cv.resize(m, (sd.W // res_level, sd.H // res_level),
                          interpolation=cv.INTER_AREA)
        mask = (m[..., None] > 0.1).astype(np.float32)
        _l1, psnr = val_image_metrics(out["img"], gt, mask)
        psnrs.append(psnr)
        eiks.append(out["gradient_error"])
    return float(np.mean(psnrs)), float(np.mean(eiks))


def make_noisy_cameras(scene_dir: str, seed: int = 5):
    """Write ``image/cameras_sphere_noisy.npz`` (and a copy at the scene's
    root): the scene's true cameras with COLMAP-grade pose noise
    (``perturb_poses``). -> (gt_pose_all, noisy_pose_all, gt_world_mats)."""
    sd = SceneData(Config({
        "data_dir": scene_dir, "img_dir": "image", "depth_dir": "00",
        "render_cameras_name": "image/cameras_sphere.npz",
        "object_cameras_name": "image/cameras_sphere.npz",
    }))
    gt = np.asarray(sd.pose_all, np.float64)
    noisy = perturb_poses(gt, np.random.default_rng(seed))
    cam_npz = {}
    gt_world_mats = []
    for i in range(sd.n_images):
        stem = _stem(sd, i)
        K = np.asarray(sd.intrinsics_all[i], np.float64)
        cam_npz[f"world_mat_{stem}"] = (K @ np.linalg.inv(noisy[i])).astype(np.float32)
        cam_npz[f"scale_mat_{stem}"] = np.eye(4, dtype=np.float32)
        gt_world_mats.append((K @ np.linalg.inv(gt[i])).astype(np.float32))
    np.savez(os.path.join(scene_dir, "image", "cameras_sphere_noisy.npz"), **cam_npz)
    np.savez(os.path.join(scene_dir, "cameras_sphere_noisy.npz"), **cam_npz)
    return gt, noisy, np.stack(gt_world_mats)


def _rot_err_deg(a, b) -> float:
    R = np.matmul(a[:, :3, :3], np.swapaxes(b[:, :3, :3], 1, 2))
    tr = np.clip((np.trace(R, axis1=1, axis2=2) - 1.0) / 2.0, -1, 1)
    return float(np.degrees(np.arccos(tr)).mean())


def _center_err(a, b) -> float:
    return float(np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=-1).mean())


def pose_recovery_stats(runner: Runner, gt_pose_all):
    """Learned cameras against the true ones, raw and with the camera-centre
    Umeyama similarity quotiented out -> (stats, (s, R, t)); the similarity
    maps the learned frame into the true one."""
    cams = runner.cams
    with torch.no_grad():
        learned = np.asarray(all_learned_c2w(cams.r, cams.t, cams.init_c2w).cpu().numpy(),
                             np.float64)
        init = np.asarray(cams.init_c2w.cpu().numpy(), np.float64)
    gt = np.asarray(gt_pose_all, np.float64)
    s, R, t = umeyama(learned[:, :3, 3], gt[:, :3, 3])
    aligned = learned.copy()
    aligned[:, :3, :3] = np.einsum("ij,njk->nik", R, learned[:, :3, :3])
    aligned[:, :3, 3] = s * learned[:, :3, 3] @ R.T + t
    gauge_angle = float(np.degrees(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1, 1))))
    stats = {
        "init_rot_err_deg": round(_rot_err_deg(init, gt), 4),
        "init_center_err": round(_center_err(init, gt), 5),
        "raw_rot_err_deg": round(_rot_err_deg(learned, gt), 4),
        "raw_center_err": round(_center_err(learned, gt), 5),
        "aligned_rot_err_deg": round(_rot_err_deg(aligned, gt), 4),
        "aligned_center_err": round(_center_err(aligned, gt), 5),
        "gauge_scale": round(s, 6),
        "gauge_rot_deg": round(gauge_angle, 4),
        "gauge_trans": round(float(np.linalg.norm(t)), 5),
    }
    return stats, (s, R, t)


def depth_export_qc(runner: Runner, scene_dir: str, geometry: str, n_views: int = 4,
                    res_level: int = 2, sim=None) -> dict:
    """The getfeats export (argmax-weight sample depth a ray) against the
    sphere-traced analytic depth over the true object mask, both distances
    along the same unit rays; under ``sim`` the rays and depths are mapped
    into the true frame first (p_gt = s R p + t)."""
    gt_sdf = GEOMETRIES[geometry][0]
    sd = runner.scene_data
    poses, intrin_inv = runner.resolved_cams()
    abs_errs, rel_errs = [], []
    for idx in range(0, sd.n_images, max(sd.n_images // n_views, 1)):
        out = _render(runner, idx, res_level)
        wd = np.asarray(out["weight_depth"])[..., 0]
        ro, rd = rays_grid(torch.as_tensor(poses[idx], dtype=torch.float32),
                           torch.as_tensor(intrin_inv[idx], dtype=torch.float32),
                           sd.H, sd.W, res_level)
        ro = ro.numpy().astype(np.float64)
        rd = rd.numpy().astype(np.float64)
        if sim is not None:
            s_g, R_g, t_g = sim
            ro = s_g * ro @ R_g.T + t_g
            rd = rd @ R_g.T
            wd = wd * s_g
        cam_dist = float(np.linalg.norm(ro.reshape(-1, 3)[0]))
        t, hit = _sphere_trace(ro, rd, cam_dist - 1.0, cam_dist + 1.0, sdf=gt_sdf)
        m = _eval_mask(scene_dir, _stem(sd, idx))
        if res_level > 1:
            m = cv.resize(m, (sd.W // res_level, sd.H // res_level),
                          interpolation=cv.INTER_AREA)
        sel = (m > 127) & hit
        if not sel.any():
            continue
        err = np.abs(wd[sel] - t[sel])
        abs_errs.append(err)
        rel_errs.append(err / np.maximum(t[sel], 1e-6))
    if not abs_errs:
        return {"n_views": 0}
    abs_all = np.concatenate(abs_errs)
    rel_all = np.concatenate(rel_errs)
    return {
        "n_views": len(abs_errs),
        "res_level": res_level,
        "abs_mean": round(float(abs_all.mean()), 5),
        "abs_median": round(float(np.median(abs_all)), 5),
        "abs_p95": round(float(np.percentile(abs_all, 95)), 5),
        "rel_mean": round(float(rel_all.mean()), 5),
    }


def geometry_qc(runner: Runner, scene_dir: str, geometry: str, resolution: int = 512,
                sim=None, world_mats=None) -> dict:
    """The mesh at ``resolution``^3 (the SDF through K1), cleaned against the
    visual hull, and its Chamfer distance to the analytic surface
    (``mesh/qc.py``). Under ``sim`` (a learned-camera leg) the SDF is
    queried in the true frame, p_l = R^T (p_gt - t) / s, and the hull takes
    the true ``world_mats``."""
    sd = runner.scene_data
    sdf_net = runner.model.sdf_network_fine
    dev = runner.device
    if sim is not None:
        s_g, R_g, t_g = sim
        R_t = torch.as_tensor(R_g, dtype=torch.float32, device=dev)
        t_t = torch.as_tensor(t_g, dtype=torch.float32, device=dev)

        def neg_sdf(pts):
            return -sdf_net.sdf_value(((pts - t_t) @ R_t) / s_g)[:, 0]
    else:
        def neg_sdf(pts):
            return -sdf_net.sdf_value(pts)[:, 0]

    gt_sdf = GEOMETRIES[geometry][1]
    eval_masks = np.stack([(_eval_mask(scene_dir, _stem(sd, i)) > 127).astype(np.uint8)
                           for i in range(sd.n_images)])
    with torch.no_grad():
        qc = run_qc(neg_sdf, lambda p: -gt_sdf(p), sd.object_bbox_min, sd.object_bbox_max,
                    resolution, eval_masks,
                    np.stack(sd.world_mats_np) if world_mats is None else world_mats,
                    device=dev)
    if not qc["raw"]["n_verts"]:
        return {"n_verts": 0, "chamfer": None}
    return {
        "mesh_res": resolution,
        "n_verts": qc["raw"]["n_verts"], "n_tris": qc["raw"]["n_tris"],
        "clean": qc["clean"],
        **qc["chamfer"],
        "wall_s": qc["wall_s"],
    }


# -- confs and legs ------------------------------------------------------------


def write_conf_file(path, exp_dir, scene_dir, iters, batch, wdepth,
                    depth_weight_scale=1.0, dpt_dim=96,
                    depth_start_iter=None, lr_end_iter=None,
                    igr_weight=0.1, anneal_end=None, warm_up_end=None,
                    render_samples=0, resample_frac=0.25, resample_from=0,
                    learn=False, cam_npz="cameras_sphere.npz"):
    """BASE_CONF for one training leg, the JAX tool's text. ``dpt_dim`` is
    the encoder's feature width (96 for densenet, 32 for mobilenet_light);
    ``depth_start_iter`` defaults to iters // 10, ``anneal_end`` to
    max(iters // 4, 1000), ``warm_up_end`` to max(iters // 50, 100);
    ``render_samples`` / ``resample_frac`` / ``resample_from`` put the
    importance-resampled core into the leg; ``learn`` writes the reference's
    womsk_learn surface (poses and focal refined from ``cam_npz``)."""
    extra = ""
    if wdepth:
        start = iters // 10 if depth_start_iter is None else depth_start_iter
        extra = (f"    extract_depth = True\n"
                 f"    depth_start_iter = {start}\n"
                 f"    depth_before_color = False\n"
                 f"    depth_loss_scale = {depth_weight_scale}\n"
                 f"    rgb_dims = 3")
    if lr_end_iter:
        extra += f"\n    lr_end_iter = {lr_end_iter}"
    renderer_extra = ""
    if render_samples:
        renderer_extra = (
            f"\n        n_render_samples = {render_samples}"
            f"\n        resample_uniform_frac = {resample_frac}"
        )
        if resample_from:
            extra += f"\n    resample_from = {resample_from}"
    if learn:
        extra += (
            "\n    focal_learnable = True"
            "\n    poses_learnable = True"
            "\n    start_refine_pose_iter = -1"
            "\n    start_refine_focal_iter = -1"
            "\n    focal_lr = 5e-4"
            "\n    pose_lr = 5e-4"
            "\n    focal_lr_gamma = 0.9"
            "\n    pose_lr_gamma = 0.9"
            f"\n    step_size = {max(iters // 50, 100)}"
        )
    with open(path, "w") as f:
        f.write(BASE_CONF.format(
            exp_dir=exp_dir, data_dir=scene_dir, iters=iters,
            igr_weight=igr_weight,
            batch=batch,
            warm_up=(max(iters // 50, 100) if warm_up_end is None else warm_up_end),
            anneal=(max(iters // 4, 1000) if anneal_end is None else anneal_end),
            val_freq=iters // 2,
            extra_train=extra,
            nerf_extra=(f",\n        gen_depth_feats = True, dpt_dim = {dpt_dim}"
                        if wdepth else ""),
            depth_block=DEPTH_BLOCK.format(dpt_dim=dpt_dim) if wdepth else "",
            depth_dir="wavelet_feats/0" if wdepth else "00",
            fast_bg="True",
            renderer_extra=renderer_extra,
            cam_npz=cam_npz,
        ))
    return path


class Cycle:
    """What every stage shares: the parsed flags, the device, the stage log."""

    def __init__(self, args, dev: torch.device, log: StageLog):
        self.args = args
        self.dev = dev
        self.log = log
        self.scene_dir = os.path.join(args.out, args.geometry)
        # each report's config: the flags, the device and the card
        self.config = {**vars(args), "device": str(dev), "card": log.card}

    def cli(self, argv: list[str]):
        return cli.main(argv + ["--gpu", str(self.args.gpu)], device=self.dev)

    def eval_runner(self, conf_path: str, it: int) -> Runner:
        runner = Runner(conf_path, mode="eval", device=self.dev, gpu=self.args.gpu)
        runner.load_checkpoint_iter(it)
        return runner

    def evaluate_leg(self, conf_path: str, it: int, prefix: str, report: dict,
                     gt_pose_all=None, gt_world_mats=None) -> None:
        """``<prefix>_object_masked_psnr_res2``, ``_eikonal``, (learn)
        ``_pose_recovery``, ``_geometry`` and ``_depth_export_qc`` of the
        leg's checkpoint at ``it``, into ``report``."""
        runner = self.eval_runner(conf_path, it)
        psnr, eik = object_masked_psnr(runner, self.scene_dir)
        report[f"{prefix}_object_masked_psnr_res2"] = round(psnr, 3)
        report[f"{prefix}_eikonal"] = round(eik, 5)
        sim = None
        if gt_pose_all is not None:
            stats, sim = pose_recovery_stats(runner, gt_pose_all)
            report[f"{prefix}_pose_recovery"] = stats
            print(f"[cycle] {prefix} pose recovery: {stats}", flush=True)
        report[f"{prefix}_geometry"] = geometry_qc(runner, self.scene_dir, self.args.geometry,
                                                   self.args.mesh_res, sim=sim,
                                                   world_mats=gt_world_mats)
        report[f"{prefix}_depth_export_qc"] = depth_export_qc(
            runner, self.scene_dir, self.args.geometry, sim=sim)

    def run_wdepth_leg(self, conf_path: str, exp_dir: str, wit: int, report: dict,
                       seed: int = 0, gt_pose_all=None, gt_world_mats=None) -> dict:
        """Stage 5: train through the CLI, evaluate the leg's checkpoint, and
        read the distillation loss's course from ``logs/metrics.jsonl``."""
        with self.log.stage("train_wdepth"):
            self.cli(["--conf", conf_path, "--mode", "train", "--seed", str(seed)])
        report["stages"]["train_wdepth_s"] = self.log.stages["train_wdepth"]["wall_s"]
        with self.log.stage("qc_wdepth"):
            self.evaluate_leg(conf_path, wit, "wdepth", report, gt_pose_all, gt_world_mats)
        with open(os.path.join(exp_dir, "logs", "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        dlosses = [r["depth_loss"] for r in records if "depth_loss" in r]
        report["distillation"] = {
            "depth_loss_first": round(dlosses[0], 4) if dlosses else None,
            "depth_loss_last": round(dlosses[-1], 4) if dlosses else None,
            "all_losses_finite": bool(np.isfinite([r["loss"] for r in records]).all()),
        }
        return report

    def finetune(self, logdir: str, warm_start: str | None = None) -> str:
        """Stage 3: the side-car's finetune on the depth export -> the last
        epoch's checkpoint folder."""
        a = self.args
        argv = ["-r", a.out, "--case", a.geometry, "--epochs", str(a.wavelet_epochs),
                "-bs", str(a.wavelet_bs), "--image_size", str(a.img_res),
                "--encoder_type", a.encoder, "--logdir", logdir,
                "--val_freq", "50", "--save_freq", str(a.wavelet_epochs), "--gpu", str(a.gpu)]
        if warm_start:
            argv += ["-ckpt", warm_start]
        with deterministic_cudnn():
            logpath = finetune_cli.finetune(argv, device=self.dev)
        ckpt = last_checkpoint(logpath)
        assert ckpt, f"no wavelet checkpoint under {logpath}"
        return ckpt

    def predict(self, ckpt: str) -> dict:
        """Stage 4: the VDN features of every view -> their record."""
        img_dir = os.path.join(self.scene_dir, "image")
        with deterministic_cudnn():
            predict_cli.main(["-ckpt", ckpt, "--ckpt_name", "model.npz", "-d", img_dir,
                              "--encoder_type", self.args.encoder, "--gpu", str(self.args.gpu)],
                             device=self.dev)
        feat_dir = os.path.join(img_dir, "wavelet_feats", "0")
        feats0 = np.load(os.path.join(feat_dir, sorted(os.listdir(feat_dir))[0]))
        return {"n_views": len(os.listdir(feat_dir)), "shape": list(feats0.shape),
                "finite": bool(np.isfinite(feats0).all())}

    def write(self, report: dict, name: str) -> None:
        path = os.path.join(self.args.out, name)
        with open(path, "w") as f:
            json.dump(report, f, indent=2)
        self.log.write(path)


def last_checkpoint(logpath: str) -> str | None:
    """The folder of the highest epoch's ``model.npz`` under a finetune log."""
    found = []
    for root, _dirs, files in os.walk(logpath):
        if "model.npz" in files:
            epoch = os.path.basename(root).rpartition("_")[2]
            found.append((int(epoch) if epoch.isdigit() else -1, root))
    return max(found)[1] if found else None


def _feature_dim(scene_dir: str) -> int:
    feat_dir = os.path.join(scene_dir, "image", "wavelet_feats", "0")
    return int(np.load(os.path.join(feat_dir, sorted(os.listdir(feat_dir))[0])).shape[1])


def _base_keys(out: str, keys) -> dict | None:
    path = os.path.join(out, "vdn_cycle_report.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        base = json.load(f)
    return {k: base.get(k) for k in keys}


def wdepth_leg_only(cyc: Cycle, wit: int) -> dict:
    """--skip-to-wdepth: rerun only stage 5 against the VDN features a
    completed cycle extracted into --out."""
    args = cyc.args
    feat_dir = os.path.join(cyc.scene_dir, "image", "wavelet_feats", "0")
    if not os.path.isdir(feat_dir) or not os.listdir(feat_dir):
        raise SystemExit(f"--skip-to-wdepth needs VDN features at {feat_dir} from a "
                         f"completed cycle run (stages 1-4)")
    tag = args.leg_tag
    exp_dir = os.path.join(args.out, f"exp_wdepth_{wit}{tag}")
    if os.path.exists(exp_dir):
        raise SystemExit(f"{exp_dir} already exists; delete it first")
    report = {"config": cyc.config, "stages": {}}
    base = _base_keys(args.out, ("base_object_masked_psnr_res2", "base_eikonal",
                                 "base_geometry"))
    if base is not None:
        report["base_from"] = base

    gt_pose_all = gt_world_mats = None
    cam_npz = "cameras_sphere.npz"
    if args.learn:
        gt_pose_all, _noisy, gt_world_mats = make_noisy_cameras(cyc.scene_dir)
        cam_npz = "cameras_sphere_noisy.npz"
    conf = write_conf_file(
        os.path.join(args.out, f"wdepth_{wit}{tag}.conf"), exp_dir, cyc.scene_dir,
        wit, args.batch, wdepth=True, depth_weight_scale=args.depth_weight_scale,
        dpt_dim=_feature_dim(cyc.scene_dir), depth_start_iter=args.depth_start_iter,
        lr_end_iter=args.lr_end_iter, anneal_end=args.anneal_end,
        warm_up_end=args.warm_up_end, render_samples=args.render_samples,
        resample_frac=args.resample_frac, resample_from=args.resample_from,
        learn=args.learn, cam_npz=cam_npz,
    )
    cyc.run_wdepth_leg(conf, exp_dir, wit, report, seed=args.seed, gt_pose_all=gt_pose_all,
                       gt_world_mats=gt_world_mats)
    cyc.write(report, f"vdn_cycle_report_wdepth{wit}{tag}.json")
    print(json.dumps({
        "wdepth_iters": wit,
        "wdepth_psnr": report["wdepth_object_masked_psnr_res2"],
        "wdepth_eikonal": report["wdepth_eikonal"],
        "wdepth_chamfer": report["wdepth_geometry"]["chamfer"],
        "train_wall_s": report["stages"]["train_wdepth_s"],
    }), flush=True)
    return report


def cycle2_legs(cyc: Cycle, wit: int) -> dict:
    """--cycle2: stages 2-5 again from a completed cycle's distilled leg:
    getfeats from exp_wdepth, the finetune warm-started from the first
    cycle's encoder, the features again, a fresh distilled leg in
    exp_wdepth_c2. The first cycle's exports and features are kept as
    ``*_c1``."""
    args = cyc.args
    img_dir = os.path.join(cyc.scene_dir, "image")
    wdepth_conf = os.path.join(args.out, "wdepth.conf")
    exp_wdepth = os.path.join(args.out, "exp_wdepth")
    for need in (wdepth_conf, exp_wdepth, os.path.join(img_dir, "wavelet_feats", "0")):
        if not os.path.exists(need):
            raise SystemExit(f"--cycle2 needs a completed cycle in {args.out} "
                             f"(missing {need})")
    exp_c2 = os.path.join(args.out, "exp_wdepth_c2")
    if os.path.exists(exp_c2):
        raise SystemExit(f"{exp_c2} already exists; delete it first")
    report = {"config": cyc.config, "stages": {}}
    cycle1 = _base_keys(args.out, ("base_geometry", "wdepth_geometry",
                                   "base_object_masked_psnr_res2",
                                   "wdepth_object_masked_psnr_res2", "base_eikonal",
                                   "wdepth_eikonal", "wdepth_depth_export_qc"))
    if cycle1 is not None:
        report["cycle1"] = cycle1

    # 2'. the depth export of the distilled checkpoint (cycle 1's kept)
    sdf_dir = os.path.join(img_dir, "depth_from_sdf")
    if os.path.isdir(sdf_dir) and not os.path.isdir(sdf_dir + "_c1"):
        shutil.move(sdf_dir, sdf_dir + "_c1")
    with cyc.log.stage("getfeats"):
        cyc.cli(["--conf", wdepth_conf, "--mode", f"getfeats_{wit}"])
    n_exports = len([f for f in os.listdir(sdf_dir) if f.endswith(".npy")])
    assert n_exports == args.views, (n_exports, args.views)
    report["stages"]["getfeats_s"] = cyc.log.stages["getfeats"]["wall_s"]
    print(f"[cycle2] getfeats from exp_wdepth: {n_exports} maps", flush=True)

    # 3'. the finetune, warm-started from cycle 1's encoder
    c1_ckpt = last_checkpoint(os.path.join(args.out, "wavelet_log"))
    assert c1_ckpt, "no cycle-1 wavelet checkpoint to warm-start from"
    with cyc.log.stage("wavelet_finetune"):
        ckpt = cyc.finetune(os.path.join(args.out, "wavelet_log_c2"), warm_start=c1_ckpt)
    report["stages"]["wavelet_finetune_s"] = cyc.log.stages["wavelet_finetune"]["wall_s"]
    print(f"[cycle2] wavelet finetune (warm-start) "
          f"{report['stages']['wavelet_finetune_s']}s", flush=True)

    # 4'. the features again (cycle 1's kept)
    feats_root = os.path.join(img_dir, "wavelet_feats")
    if not os.path.isdir(feats_root + "_c1"):
        shutil.move(feats_root, feats_root + "_c1")
    with cyc.log.stage("predict"):
        report["vdn_features"] = cyc.predict(ckpt)
    report["stages"]["predict_s"] = cyc.log.stages["predict"]["wall_s"]
    print(f"[cycle2] features: {report['vdn_features']}", flush=True)

    # 5'. the second distilled leg
    conf = write_conf_file(
        os.path.join(args.out, "wdepth_c2.conf"), exp_c2, cyc.scene_dir, wit, args.batch,
        wdepth=True, depth_weight_scale=args.depth_weight_scale,
        dpt_dim=report["vdn_features"]["shape"][1], depth_start_iter=args.depth_start_iter,
        lr_end_iter=args.lr_end_iter, render_samples=args.render_samples,
        resample_frac=args.resample_frac, resample_from=args.resample_from,
    )
    cyc.run_wdepth_leg(conf, exp_c2, wit, report, seed=args.seed)
    cyc.write(report, "vdn_cycle2_report.json")
    c1g = (report.get("cycle1") or {}).get("wdepth_geometry") or {}
    print(json.dumps({
        "cycle1_wdepth_chamfer": c1g.get("chamfer"),
        "cycle2_wdepth_chamfer": report["wdepth_geometry"]["chamfer"],
        "cycle2_wdepth_psnr": report["wdepth_object_masked_psnr_res2"],
        "cycle2_wdepth_eikonal": report["wdepth_eikonal"],
        "cycle2_depth_export_qc": report["wdepth_depth_export_qc"],
        "train_wall_s": report["stages"]["train_wdepth_s"],
    }), flush=True)
    return report


def eik_boost_probe(cyc: Cycle, wit: int) -> dict:
    """--eik-boost: from the completed cycle's distilled checkpoint, train
    ``--eik-iters`` more steps per eikonal weight (distillation on, its
    onset kept at wit // 10, the cosine lr held at its floor past wit) and
    measure eikonal, PSNR, Chamfer and the exported depth."""
    args = cyc.args
    exp_wdepth = os.path.join(args.out, "exp_wdepth")
    ckpt = os.path.join(exp_wdepth, "checkpoints")
    feat_dir = os.path.join(cyc.scene_dir, "image", "wavelet_feats", "0")
    for need in (ckpt, feat_dir):
        if not os.path.exists(need):
            raise SystemExit(f"--eik-boost needs a completed cycle in {args.out} "
                             f"(missing {need})")
    end = wit + args.eik_iters
    report = {"config": cyc.config, "arms": {}}
    baseline = _base_keys(args.out, ("wdepth_geometry", "wdepth_eikonal",
                                     "wdepth_object_masked_psnr_res2",
                                     "wdepth_depth_export_qc", "base_eikonal"))
    if baseline is not None:
        report["wdepth_baseline"] = baseline
    for w in args.eik_boost:
        tag = f"w{w:g}".replace(".", "p") + args.leg_tag
        exp_dir = os.path.join(args.out, f"exp_eikboost_{tag}")
        if os.path.exists(exp_dir):
            raise SystemExit(f"{exp_dir} already exists; delete it first")
        os.makedirs(exp_dir)
        shutil.copytree(ckpt, os.path.join(exp_dir, "checkpoints"))
        conf = write_conf_file(
            os.path.join(args.out, f"eikboost_{tag}.conf"), exp_dir, cyc.scene_dir, end,
            args.batch, wdepth=True, depth_weight_scale=args.depth_weight_scale,
            dpt_dim=_feature_dim(cyc.scene_dir), depth_start_iter=wit // 10,
            lr_end_iter=wit, igr_weight=w,
        )
        with cyc.log.stage(f"train_eikboost_{tag}"):
            cyc.cli(["--conf", conf, "--mode", "train", "--is_continue"])
        with cyc.log.stage(f"qc_eikboost_{tag}"):
            runner = cyc.eval_runner(conf, end)
            psnr, eik = object_masked_psnr(runner, cyc.scene_dir)
            arm = {"igr_weight": w, "psnr": round(psnr, 3), "eikonal": round(eik, 5),
                   "geometry": geometry_qc(runner, cyc.scene_dir, args.geometry,
                                           args.mesh_res),
                   "depth_export_qc": depth_export_qc(runner, cyc.scene_dir, args.geometry)}
            del runner
        report["arms"][f"igr_{w:g}"] = {
            "igr_weight": w, "train_wall_s": cyc.log.stages[f"train_eikboost_{tag}"]["wall_s"],
            **{k: v for k, v in arm.items() if k != "igr_weight"}}
        print(f"[eik-boost] igr={w:g}: eik {arm['eikonal']:.4f}, chamfer "
              f"{arm['geometry']['chamfer']}", flush=True)
    cyc.write(report, f"eik_boost_report{args.leg_tag}.json")
    print(json.dumps({
        k: {kk: v[kk] for kk in ("eikonal", "psnr")}
        | {"chamfer": v["geometry"]["chamfer"],
           "depth_abs_mean": v["depth_export_qc"].get("abs_mean")}
        for k, v in report["arms"].items()
    }), flush=True)
    return report


def full_cycle(cyc: Cycle, wit: int) -> dict:
    """Stages 1-5 and both legs' QC -> vdn_cycle_report.json."""
    args, scene_dir = cyc.args, cyc.scene_dir
    os.makedirs(scene_dir, exist_ok=True)
    report = {"config": cyc.config, "stages": {}}

    t0 = time.time()
    with cyc.log.stage("scene_gen"):
        make_compound_scene(scene_dir, n_images=args.views, H=args.img_res, W=args.img_res,
                            background="textured", shading=args.shading,
                            geometry=args.geometry)
        # the side-car reads object masks from <case>/mask/ (3-channel); the
        # scene keeps its true masks under image/eval_mask/
        wmask_dir = os.path.join(scene_dir, "mask")
        os.makedirs(wmask_dir, exist_ok=True)
        em_dir = os.path.join(scene_dir, "image", "eval_mask")
        for fn in os.listdir(em_dir):
            m = cv.imread(os.path.join(em_dir, fn), 0)
            cv.imwrite(os.path.join(wmask_dir, fn), np.repeat(m[..., None], 3, axis=-1))
    report["stages"]["scene_gen_s"] = cyc.log.stages["scene_gen"]["wall_s"]
    print(f"[cycle] scene: {args.views} views {args.img_res}^2 "
          f"({report['stages']['scene_gen_s']}s)", flush=True)

    gt_pose_all = gt_world_mats = None
    cam_npz = "cameras_sphere.npz"
    if args.learn:
        gt_pose_all, noisy, gt_world_mats = make_noisy_cameras(scene_dir)
        cam_npz = "cameras_sphere_noisy.npz"
        print(f"[cycle] learn arm: noisy cameras written (mean init rot err "
              f"{_rot_err_deg(noisy, gt_pose_all):.3f} deg)", flush=True)

    def write_conf(path, exp_dir, wdepth, iters=None, dpt_dim=96):
        return write_conf_file(
            path, exp_dir, scene_dir, iters or args.iters, args.batch, wdepth,
            depth_weight_scale=args.depth_weight_scale, dpt_dim=dpt_dim,
            depth_start_iter=args.depth_start_iter if wdepth else None,
            lr_end_iter=args.lr_end_iter if wdepth else None,
            render_samples=args.render_samples if wdepth else 0,
            resample_frac=args.resample_frac,
            resample_from=args.resample_from if wdepth else 0,
            learn=args.learn, cam_npz=cam_npz,
        )

    # 1. base NeuS training
    base_conf = write_conf(os.path.join(args.out, "base.conf"),
                           os.path.join(args.out, "exp_base"), wdepth=False)
    with cyc.log.stage("train_base"):
        cyc.cli(["--conf", base_conf, "--mode", "train"])
    report["stages"]["train_base_s"] = cyc.log.stages["train_base"]["wall_s"]
    with cyc.log.stage("qc_base"):
        cyc.evaluate_leg(base_conf, args.iters, "base", report, gt_pose_all, gt_world_mats)
    print(f"[cycle] base train {report['stages']['train_base_s']}s, object-masked PSNR "
          f"{report['base_object_masked_psnr_res2']:.2f} dB, eikonal "
          f"{report['base_eikonal']:.4f}, Chamfer {report['base_geometry']['chamfer']}",
          flush=True)

    # 2. the depth-from-SDF export
    sdf_dir = os.path.join(scene_dir, "image", "depth_from_sdf")
    with cyc.log.stage("getfeats"):
        cyc.cli(["--conf", base_conf, "--mode", f"getfeats_{args.iters}"])
    n_exports = len([f for f in os.listdir(sdf_dir) if f.endswith(".npy")])
    assert n_exports == args.views, (n_exports, args.views)
    report["stages"]["getfeats_s"] = cyc.log.stages["getfeats"]["wall_s"]
    depths = np.stack([np.load(os.path.join(sdf_dir, f))
                       for f in sorted(os.listdir(sdf_dir)) if f.endswith(".npy")])
    report["depth_export"] = {
        "n_maps": int(n_exports),
        "depth_mean": round(float(depths.mean()), 4),
        "depth_finite": bool(np.isfinite(depths).all()),
    }
    print(f"[cycle] getfeats: {n_exports} maps ({report['stages']['getfeats_s']}s)", flush=True)

    # 3. the side-car's finetune on those depths
    with cyc.log.stage("wavelet_finetune"):
        ckpt = cyc.finetune(os.path.join(args.out, "wavelet_log"))
    report["stages"]["wavelet_finetune_s"] = cyc.log.stages["wavelet_finetune"]["wall_s"]
    print(f"[cycle] wavelet finetune ({args.encoder}) "
          f"{report['stages']['wavelet_finetune_s']}s", flush=True)

    # 4. the VDN features
    with cyc.log.stage("predict"):
        report["vdn_features"] = cyc.predict(ckpt)
    report["stages"]["predict_s"] = cyc.log.stages["predict"]["wall_s"]
    print(f"[cycle] features: {report['vdn_features']} ({report['stages']['predict_s']}s)",
          flush=True)

    # 5. the distilled retrain on those features
    wdepth_conf = write_conf(os.path.join(args.out, "wdepth.conf"),
                             os.path.join(args.out, "exp_wdepth"), wdepth=True, iters=wit,
                             dpt_dim=report["vdn_features"]["shape"][1])
    cyc.run_wdepth_leg(wdepth_conf, os.path.join(args.out, "exp_wdepth"), wit, report,
                       gt_pose_all=gt_pose_all, gt_world_mats=gt_world_mats)
    print(f"[cycle] wdepth eikonal {report['wdepth_eikonal']:.4f}, Chamfer "
          f"{report['wdepth_geometry']['chamfer']} (base {report['base_geometry']['chamfer']})",
          flush=True)
    dist = report["distillation"]
    assert dist["depth_loss_first"] is not None, "distillation loss never fired"
    print(f"[cycle] wdepth train {report['stages']['train_wdepth_s']}s, object-masked PSNR "
          f"{report['wdepth_object_masked_psnr_res2']:.2f} dB, depth_loss "
          f"{dist['depth_loss_first']:.3f} -> {dist['depth_loss_last']:.3f}", flush=True)

    report["total_wall_s"] = round(time.time() - t0, 1)
    cyc.write(report, "vdn_cycle_report.json")
    learn_summary = {}
    if args.learn:
        learn_summary = {"base_pose": report["base_pose_recovery"],
                         "wdepth_pose": report["wdepth_pose_recovery"]}
    print(json.dumps({
        "base_psnr": report["base_object_masked_psnr_res2"],
        "wdepth_psnr": report["wdepth_object_masked_psnr_res2"],
        "base_chamfer": report["base_geometry"]["chamfer"],
        "wdepth_chamfer": report["wdepth_geometry"]["chamfer"],
        **learn_summary,
        "base_eikonal": report["base_eikonal"],
        "wdepth_eikonal": report["wdepth_eikonal"],
        "depth_loss_drop": [report["distillation"]["depth_loss_first"],
                            report["distillation"]["depth_loss_last"]],
        "total_wall_s": report["total_wall_s"],
    }), flush=True)
    return report


def main(argv=None, device=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(device, args.gpu)
    if args.learn and (args.cycle2 or args.eik_boost):
        raise SystemExit("--learn composes with the full cycle and --skip-to-wdepth only "
                         "(not --cycle2/--eik-boost)")
    if not (args.skip_to_wdepth or args.cycle2 or args.eik_boost):
        # a reused out dir would evaluate stale files (a resume picks the
        # highest checkpoint whichever run wrote it): refuse it
        for stale in ("exp_base", "exp_wdepth", "wavelet_log", args.geometry):
            if os.path.exists(os.path.join(args.out, stale)):
                raise SystemExit(f"--out {args.out} already contains '{stale}' from a "
                                 f"previous run; pass a fresh directory (or delete it)")
    card = card_line() if dev.type == "cuda" else None
    print(f"device: {dev}" + (f" ({card})" if card else ""), flush=True)
    cyc = Cycle(args, dev, StageLog(dev, card))
    wit = args.wdepth_iters or args.iters
    with precision_policy(not args.fp32):
        if args.skip_to_wdepth:
            return wdepth_leg_only(cyc, wit)
        if args.cycle2:
            return cycle2_legs(cyc, wit)
        if args.eik_boost:
            return eik_boost_probe(cyc, wit)
        return full_cycle(cyc, wit)


if __name__ == "__main__":
    main()
