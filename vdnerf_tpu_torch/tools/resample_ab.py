"""Faithful-against-resampled-core convergence A/B through the port's CLI, on the card.

    python -m vdnerf_tpu_torch.tools.resample_ab [--iters 2500] [--masked]
        [--fast-bg] [--onset-frac F] [--render-samples 24] [--uniform-frac F]
        [--iters-b N] [--skip-faithful] [--workdir DIR] [--out FILE]
        [--row NAME [--record docs/RESAMPLE_AB_torch.json]] [--gpu 0]

Counterpart of ``tools/resample_ab.py``, with every flag of it (``--gpu``,
``--row`` and ``--record`` added). On the compound analytic scene
(textured background, ``--views`` views of ``--img-res``^2, from the port's
own byte-identical generator, ``data/synthetic.py``) it trains two arms
through ``vdnerf_tpu_torch.cli`` at the JAX tool's reduced widths (its
``CONF`` text, byte for byte), with the same budget and seed: the faithful
core (all 24 + 24 ladder samples) and the importance-resampled core
(``--render-samples``, from ``--onset-frac`` of the run on); ``--masked``
trains the wmask regime on the true object masks. Each arm is measured as the
VDN cycle tool measures a leg (``tools/vdn_cycle_run.py``): the
object-masked PSNR and eikonal error at resolution level 2, and the mesh at
``--mesh-res``^3 cleaned against the visual hull, its Chamfer distance to the
analytic surface and watertightness; its training wall time is the CLI's,
synchronised. Writes the JAX tool's report (``config``, ``arms``,
``delta``; ``config`` adds the device and the card's name and power limit)
to ``--out``; with ``--row NAME`` also the row of ``docs/RESAMPLE_AB_CPU.json``'s
``final`` form under ``final[NAME]`` of ``--record``, the JAX record's delta
of the same row beside it (``jax_delta``). Both arms run in the precision the
environment selects, JAX's default unless ``VDNERF_BF16`` / ``VDNERF_FUSED``.

Runs on ``cuda:<--gpu>``; a caller of :func:`main` may pass
``device="cpu"``. The work directory defaults to ``resample_ab_out``
(``resample_ab_out_masked`` under ``--masked``: that regime rewrites the
scene's training masks), git-ignored.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

import torch

from vdnerf_tpu_torch import cli
from vdnerf_tpu_torch.data.synthetic import make_compound_scene
from vdnerf_tpu_torch.runner import Runner
from vdnerf_tpu_torch.tools.flagship_run import card_line
from vdnerf_tpu_torch.tools.vdn_cycle_run import geometry_qc, object_masked_psnr
from vdnerf_tpu_torch.utils.device import resolve_device

# the JAX tool's reduced-widths womsk conf, byte for byte
CONF = """\
general {{
    base_exp_dir = {exp_dir}
    recording = []
}}
dataset {{
    data_dir = {data_dir}
    img_dir = image
    depth_dir = 00
    render_cameras_name = image/cameras_sphere.npz
    object_cameras_name = image/cameras_sphere.npz
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
    val_freq = {iters}
    val_mesh_freq = {iters}
    report_freq = 500
    igr_weight = 0.1
    mask_weight = {mask_weight}
    use_mask = {use_mask}
    resample_from = {resample_from}
}}
model {{
    nerf {{
        D = 2, d_in = 4, d_in_view = 3, W = 64,
        multires = 4, multires_view = 2, output_ch = 4, skips = [4],
        rgb_dims = 3, use_viewdirs = True
    }}
    sdf_network {{
        d_out = 65
        d_in = 3
        d_hidden = 64
        n_layers = 4
        skip_in = [2]
        multires = 6
        bias = 0.5
        scale = 1.0
        geometric_init = True
        weight_norm = True
    }}
    variance_network {{ init_val = 0.3 }}
    rendering_network {{
        d_feature = 64
        mode = idr
        d_in = 9
        d_out = 3
        d_hidden = 64
        n_layers = 2
        weight_norm = True
        multires_view = 4
        squeeze_out = True
    }}
    neus_renderer {{
        n_samples = 24
        n_importance = 24
        n_outside = {n_outside}
        up_sample_steps = 4
        perturb = 1.0
        skip_bg_inside = {skip_bg}{resample_block}
    }}
}}
"""

DEFAULT_WORKDIR = "resample_ab_out"
# the JAX package's record of the same A/Bs, beside which a row is written
JAX_RECORD = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "docs", "RESAMPLE_AB_CPU.json")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=2500)
    p.add_argument("--iters-b", type=int, default=0,
                   help="the resample arm's budget alone (default: --iters)")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--views", type=int, default=10)
    p.add_argument("--img-res", type=int, default=96)
    p.add_argument("--mesh-res", type=int, default=160)
    p.add_argument("--render-samples", type=int, default=24,
                   help="the resample arm's core width (the faithful arm runs all 24 + 24)")
    p.add_argument("--onset-frac", type=float, default=0.0,
                   help="the resample arm's train.resample_from as a fraction of its budget")
    p.add_argument("--fast-bg", action="store_true", help="skip_bg_inside in both arms")
    p.add_argument("--masked", action="store_true",
                   help="the wmask regime (true masks, mask BCE, n_outside 0)")
    p.add_argument("--uniform-frac", type=float, default=None,
                   help="the resample arm's resample_uniform_frac (default: the renderer's)")
    p.add_argument("--skip-faithful", action="store_true", help="run the resample arm only")
    p.add_argument("--workdir", type=str, default=DEFAULT_WORKDIR)
    p.add_argument("--out", type=str, default=os.path.join(DEFAULT_WORKDIR,
                                                           "resample_ab_report.json"))
    p.add_argument("--row", type=str, default="",
                   help="also write the report as final[ROW] of --record")
    p.add_argument("--record", type=str, default="docs/RESAMPLE_AB_torch.json")
    p.add_argument("--gpu", type=int, default=0, help="CUDA device index")
    return p


def write_arm_conf(path: str, args, exp_dir: str, scene_dir: str, arm_iters: int,
                   m: int) -> str:
    """CONF for one arm (``m``: its resampled core's width, 0 for the
    faithful arm), as the JAX tool writes it."""
    with open(path, "w") as f:
        f.write(CONF.format(
            exp_dir=exp_dir, data_dir=scene_dir, iters=arm_iters,
            batch=args.batch, warm_up=max(arm_iters // 50, 100),
            anneal=max(arm_iters // 4, 500),
            mask_weight=0.1 if args.masked else 0.0,
            use_mask=args.masked,
            n_outside=0 if args.masked else 8,
            skip_bg=args.fast_bg and not args.masked,
            resample_from=int(arm_iters * args.onset_frac) if m else 0,
            resample_block=(
                (f"\n        n_render_samples = {m}"
                 + (f"\n        resample_uniform_frac = {args.uniform_frac}"
                    if args.uniform_frac is not None else ""))
                if m else ""
            ),
        ))
    return path


def row_record(report: dict) -> dict:
    """The report in ``docs/RESAMPLE_AB_CPU.json``'s ``final`` row form."""
    c = report["config"]
    arms = {}
    for arm, r in report["arms"].items():
        geo = r["geometry"]
        arms[arm] = {"core_samples": r["core_samples"],
                     "object_masked_psnr_res2": r["object_masked_psnr_res2"],
                     "eikonal": r["eikonal"], "chamfer": geo.get("chamfer"),
                     "watertight": bool((geo.get("clean") or {}).get("watertight", False)),
                     "train_wall_s": r["train_wall_s"]}
    return {"config": {k: c[k] for k in ("iters", "batch", "views", "img_res",
                                          "render_samples")},
            "onset_frac": c["onset_frac"], "iters_b": c["iters_b"], "masked": c["masked"],
            "fast_bg": c["fast_bg"], "arms": arms, "delta": report.get("delta"),
            "card": c["card"], "device": c["device"]}


def write_row(record_path: str, row: str, report: dict) -> dict:
    """final[row] of ``record_path`` <- the report's row, beside the JAX
    record's delta of the same row (``jax_delta``, None where it has none)."""
    rec = {"final": {}}
    if os.path.exists(record_path):
        with open(record_path) as f:
            rec = json.load(f)
    jax = {}
    if os.path.exists(JAX_RECORD):
        with open(JAX_RECORD) as f:
            jax = json.load(f).get("final", {})
    entry = row_record(report)
    entry["jax_delta"] = jax.get(row, {}).get("delta")
    rec.setdefault("final", {})[row] = entry
    os.makedirs(os.path.dirname(os.path.abspath(record_path)), exist_ok=True)
    with open(record_path, "w") as f:
        json.dump(rec, f, indent=2)
    return entry


def main(argv=None, device=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.masked and args.workdir == DEFAULT_WORKDIR:
        # the masked regime rewrites the scene's training masks in place:
        # never share a scene between the two regimes
        args.workdir = DEFAULT_WORKDIR + "_masked"
    dev = resolve_device(device, args.gpu)
    card = card_line() if dev.type == "cuda" else None
    print(f"device: {dev}" + (f" ({card})" if card else ""), flush=True)

    os.makedirs(args.workdir, exist_ok=True)
    scene_dir = os.path.join(args.workdir, "compound")
    if not os.path.exists(os.path.join(scene_dir, "image", "cameras_sphere.npz")):
        make_compound_scene(scene_dir, n_images=args.views, H=args.img_res, W=args.img_res,
                            background="textured", shading="fixed")
    if args.masked:
        # the wmask regime trains against the true object masks (the
        # textured scene writes white training masks and real eval_mask/)
        mask_dir = os.path.join(scene_dir, "image", "mask")
        eval_dir = os.path.join(scene_dir, "image", "eval_mask")
        for fn in os.listdir(eval_dir):
            shutil.copyfile(os.path.join(eval_dir, fn), os.path.join(mask_dir, fn))

    report = {"config": {**vars(args), "device": str(dev), "card": card}, "arms": {}}
    arms = (("faithful", 0), ("resample", args.render_samples))
    if args.skip_faithful:
        arms = arms[1:]
    for arm, m in arms:
        arm_iters = args.iters_b if m and args.iters_b else args.iters
        exp_dir = os.path.join(args.workdir, f"exp_{arm}")
        if os.path.exists(exp_dir):
            shutil.rmtree(exp_dir)  # never resume a stale arm
        conf = write_arm_conf(os.path.join(args.workdir, f"{arm}.conf"), args, exp_dir,
                              scene_dir, arm_iters, m)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.time()
        cli.main(["--conf", conf, "--mode", "train", "--gpu", str(args.gpu)], device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = round(time.time() - t0, 1)
        runner = Runner(conf, mode="eval", device=dev, gpu=args.gpu)
        runner.load_checkpoint_iter(arm_iters)
        psnr, eik = object_masked_psnr(runner, scene_dir)
        geo = geometry_qc(runner, scene_dir, "compound", args.mesh_res)
        report["arms"][arm] = {
            "core_samples": m or 48,
            "object_masked_psnr_res2": round(psnr, 3),
            "eikonal": round(eik, 5),
            "geometry": geo,
            "train_wall_s": wall,
        }
        print(json.dumps({arm: report["arms"][arm]}), flush=True)
        del runner

    if not args.skip_faithful:
        f_arm, r_arm = report["arms"]["faithful"], report["arms"]["resample"]
        report["delta"] = {
            "psnr_db": round(r_arm["object_masked_psnr_res2"]
                             - f_arm["object_masked_psnr_res2"], 3),
            "chamfer_ratio": (
                round(r_arm["geometry"]["chamfer"] / f_arm["geometry"]["chamfer"], 3)
                if f_arm["geometry"].get("chamfer") and r_arm["geometry"].get("chamfer")
                else None
            ),
        }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    if args.row:
        write_row(args.record, args.row, report)
    print(json.dumps(report.get("delta", report["arms"])))
    return report


if __name__ == "__main__":
    main()
