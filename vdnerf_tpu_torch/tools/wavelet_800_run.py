"""The wavelet side-car finetuned for whole epochs at the reference's shapes, on the card.

    python -m vdnerf_tpu_torch.tools.wavelet_800_run [--out wavelet800_out]
        [--views 8] [--epochs 3] [--bs 4] [--image-size 800] [--encoder densenet]
        [--report FILE] [--gpu 0]

Counterpart of ``tools/wavelet_800_run.py`` (``--gpu`` and ``--report``
added). The reference finetunes its monodepth side-car at 800x800 inputs,
batch 4, DenseNet-161; this tool runs that finetune for ``--epochs`` whole
epochs:

  1. renders the compound analytic scene at ``--image-size``^2, ``--views``
     views, textured background (the port's byte-identical generator,
     ``data/synthetic.py``; kept when ``--out`` already holds it);
  2. writes sphere-traced analytic depth as the ``depth_from_sdf`` pseudo-GT
     at half resolution, the getfeats export's layout (:func:`write_teacher`);
  3. mirrors the object masks into the side-car's ``mask/`` layout;
  4. runs the port's ``wavelet.finetune.finetune`` at ``--image-size``,
     ``--bs``, ``--encoder`` for ``--epochs`` epochs, each epoch's wall time
     taken synchronised around its pass over the training loader.

The report has the JAX tool's keys (``config``, ``stages``, the loss
trajectory's first, last and epoch means, ``checkpoint_saved``) and adds the
per-step losses, each epoch's seconds, images/s (training images over the
epochs' seconds), the card's peak memory, the cuDNN mode the finetune ran
(benchmarking unless ``torch.backends.cudnn.deterministic`` was set) and the
card's name and power limit. It goes to ``<out>/wavelet_800_report.json`` and,
with ``--report``, to that file too.

No ImageNet weights exist here, so the encoder starts from the flax
initialisation, as in every cycle run. Runs on ``cuda:<--gpu>``; a caller of
:func:`main` may pass ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import cv2 as cv
import numpy as np
import torch

from vdnerf_tpu_torch.data.dataset import SceneData
from vdnerf_tpu_torch.data.synthetic import GEOMETRIES, _sphere_trace, make_compound_scene
from vdnerf_tpu_torch.tools.flagship_run import card_line
from vdnerf_tpu_torch.utils.device import resolve_device
from vdnerf_tpu_torch.utils.hocon import Config
from vdnerf_tpu_torch.wavelet import finetune as finetune_cli

CASE = "compound800"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=str, default="wavelet800_out")
    p.add_argument("--views", type=int, default=8)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--bs", type=int, default=4)
    p.add_argument("--image-size", type=int, default=800)
    p.add_argument("--encoder", type=str, default="densenet")
    p.add_argument("--report", type=str, default="",
                   help="also write the report to this file")
    p.add_argument("--gpu", type=int, default=0, help="CUDA device index")
    return p


def scene_data(scene_dir: str) -> SceneData:
    return SceneData(Config({"dataset": {
        "data_dir": scene_dir, "img_dir": "image", "depth_dir": "00",
        "render_cameras_name": "image/cameras_sphere.npz",
        "object_cameras_name": "image/cameras_sphere.npz",
    }})["dataset"])


def write_teacher(scene_dir: str, size: int) -> int:
    """Sphere-traced depth of the compound surface at half resolution (pixel
    centres of the full-size image, misses at 4.0) as
    ``image/depth_from_sdf/sdf_<stem>.npy``, and each view's
    ``image/eval_mask`` as a 3-channel ``mask/<stem>.png`` -> the view count."""
    sd = scene_data(scene_dir)
    scene_sdf = GEOMETRIES["compound"][0]
    sdf_dir = os.path.join(scene_dir, "image", "depth_from_sdf")
    mask_dir = os.path.join(scene_dir, "mask")
    os.makedirs(sdf_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)
    H = W = size
    dH, dW = H // 2, W // 2
    for i in range(sd.n_images):
        stem = os.path.splitext(os.path.basename(sd.images_lis[i]))[0]
        c2w = sd.pose_all[i].astype(np.float64)
        Kinv = np.linalg.inv(sd.intrinsics_all[i][:3, :3]).astype(np.float64)
        xs, ys = np.meshgrid(np.arange(dW), np.arange(dH))
        pix = np.stack([(xs + 0.5) * W / dW, (ys + 0.5) * H / dH,
                        np.ones_like(xs)], axis=-1).astype(np.float64)
        d = pix @ Kinv.T
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        d = d @ c2w[:3, :3].T
        o = np.broadcast_to(c2w[:3, 3], d.shape)
        cam_dist = float(np.linalg.norm(c2w[:3, 3]))
        t, hit = _sphere_trace(o, d, cam_dist - 1.0, cam_dist + 1.0, sdf=scene_sdf)
        np.save(os.path.join(sdf_dir, f"sdf_{stem}.npy"), np.where(hit, t, 4.0).astype(np.float32))
        m = cv.imread(os.path.join(scene_dir, "image", "eval_mask", f"{stem}.png"), 0)
        cv.imwrite(os.path.join(mask_dir, f"{stem}.png"), np.repeat(m[..., None], 3, axis=-1))
    return sd.n_images


class EpochClock:
    """The finetune's training loader, each full pass over it timed,
    synchronised on the card at both ends (``seconds``)."""

    def __init__(self, loader, dev: torch.device):
        self.loader = loader
        self.dev = dev
        self.seconds: list[float] = []

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        self._sync()
        t0 = time.perf_counter()
        yield from self.loader
        self._sync()
        self.seconds.append(time.perf_counter() - t0)


@contextlib.contextmanager
def timed_epochs(dev: torch.device):
    """The finetune CLI's data loader factory wrapped for the length of the
    block, so that its training loader is an :class:`EpochClock` -> the list
    of clocks made."""
    make = finetune_cli.get_neus_train_test_data
    clocks: list[EpochClock] = []

    def wrapped(*args, **kwargs):
        train, test = make(*args, **kwargs)
        clocks.append(EpochClock(train, dev))
        return clocks[-1], test

    finetune_cli.get_neus_train_test_data = wrapped
    try:
        yield clocks
    finally:
        finetune_cli.get_neus_train_test_data = make


def train_losses(logpath: str) -> list[float]:
    """The per-step losses of the finetune's ``train/metrics.jsonl``."""
    path = os.path.join(logpath, "train", "metrics.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [rec["loss"] for rec in map(json.loads, f) if "loss" in rec]


def main(argv=None, device=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(device, args.gpu)
    card = card_line() if dev.type == "cuda" else None
    print(f"device: {dev}" + (f" ({card})" if card else ""), flush=True)
    scene_dir = os.path.join(args.out, CASE)
    report = {"config": {**vars(args), "device": str(dev), "card": card}, "stages": {}}
    os.makedirs(scene_dir, exist_ok=True)

    size = args.image_size
    t0 = time.time()
    if not os.path.isdir(os.path.join(scene_dir, "image")):
        make_compound_scene(scene_dir, n_images=args.views, H=size, W=size,
                            background="textured")
    report["stages"]["scene_gen_s"] = round(time.time() - t0, 1)
    print(f"scene: {args.views} views {size}^2 ({report['stages']['scene_gen_s']}s)", flush=True)

    t1 = time.time()
    n = write_teacher(scene_dir, size)
    report["stages"]["depth_gt_s"] = round(time.time() - t1, 1)
    print(f"analytic depth GT: {n} maps {size // 2}x{size // 2} "
          f"({report['stages']['depth_gt_s']}s)", flush=True)

    if dev.type == "cuda":
        torch.zeros(1, device=dev)  # the allocator's statistics exist from here
        torch.cuda.reset_peak_memory_stats(dev)
    t2 = time.time()
    with timed_epochs(dev) as clocks:
        logpath = finetune_cli.finetune([
            "-r", args.out, "--case", CASE,
            "--epochs", str(args.epochs),
            "-bs", str(args.bs),
            "--image_size", str(size),
            "--encoder_type", args.encoder,
            "--logdir", os.path.join(args.out, "wavelet_log800"),
            "--val_freq", "4", "--save_freq", str(args.epochs),
            "--log_every", "1", "--gpu", str(args.gpu),
        ], device=dev)
    report["stages"]["finetune_s"] = round(time.time() - t2, 1)
    epoch_s = clocks[0].seconds
    report["cudnn"] = {"deterministic": torch.backends.cudnn.deterministic,
                       "benchmark": torch.backends.cudnn.benchmark}
    report["peak_memory_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                   if dev.type == "cuda" else None)
    report["epoch_s"] = epoch_s
    report["images_per_s"] = n * len(epoch_s) / sum(epoch_s) if epoch_s else None

    losses = train_losses(logpath)
    report["losses"] = losses
    report["loss_first"] = round(losses[0], 5) if losses else None
    report["loss_last"] = round(losses[-1], 5) if losses else None
    report["n_loss_records"] = len(losses)
    report["losses_finite"] = bool(np.isfinite(losses).all()) if losses else None
    # per-batch losses are noisy at ceil(views / bs) steps an epoch: compare
    # the first and the last epoch's means
    ipe = max(1, -(-args.views // args.bs))
    report["iters_per_epoch"] = ipe
    if len(losses) >= 2 * ipe:
        first_m, last_m = float(np.mean(losses[:ipe])), float(np.mean(losses[-ipe:]))
        report["first_epoch_mean_loss"] = round(first_m, 5)
        report["last_epoch_mean_loss"] = round(last_m, 5)
        report["loss_descended"] = bool(last_m < first_m)
    else:
        report["loss_descended"] = bool(losses[-1] < losses[0]) if len(losses) >= 2 else None
    report["checkpoint_saved"] = any("model.npz" in files for _, _, files in os.walk(logpath))

    paths = [os.path.join(args.out, "wavelet_800_report.json")] + (
        [args.report] if args.report else [])
    for path in paths:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps({
        "epochs": args.epochs, "bs": args.bs, "image_size": size,
        "finetune_wall_s": report["stages"]["finetune_s"],
        "epoch_s": [round(s, 3) for s in epoch_s], "images_per_s": report["images_per_s"],
        "peak_memory_bytes": report["peak_memory_bytes"], "cudnn": report["cudnn"],
        "loss_first": report["loss_first"], "loss_last": report["loss_last"],
        "first_epoch_mean_loss": report.get("first_epoch_mean_loss"),
        "last_epoch_mean_loss": report.get("last_epoch_mean_loss"),
        "loss_descended": report["loss_descended"], "card": card,
    }), flush=True)
    return report


if __name__ == "__main__":
    main()
