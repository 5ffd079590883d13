"""VDN finetune CLI: adapt the monodepth encoder to NeuS pseudo-depths.

Counterpart of ``vdnerf_tpu/wavelet/finetune.py`` (the same flags): the
monodepth model (DenseNet-161 and the wavelet decoder by default) trained
encoder-only on a ``getfeats`` export (``<root>/<case>/<imgdir>/*.png`` with
``depth_from_sdf/sdf_<stem>.npy``), 800^2 inputs and 400^2 targets, Adam at
``-lr`` under the epoch cosine, one validation batch every ``--val_freq``
steps, checkpoints every ``--save_freq`` epochs and after the last.

Usage:
    python -m vdnerf_tpu_torch.wavelet.finetune -r ./depth_data --case boat \
        [-d image] [-max 4] [--epochs 100] [-ckpt <folder>]
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys

import torch

from vdnerf_tpu_torch.io.logging import MetricsWriter
from vdnerf_tpu_torch.utils.device import configure_numerics, resolve_device
from vdnerf_tpu_torch.wavelet.data import get_neus_train_test_data
from vdnerf_tpu_torch.wavelet.io import load_model_from_folder, save_model, save_opts
from vdnerf_tpu_torch.wavelet.model import WaveletOpts, create_model
from vdnerf_tpu_torch.wavelet.train_lib import (
    batch_to_device,
    cosine_epoch_lr,
    log_val_batch,
    make_eval_fn,
    make_finetune_step,
)


def parse_argument(argv=None):
    parser = argparse.ArgumentParser(
        description="Monodepth finetuning on NeuS depth-from-SDF exports"
    )
    parser.add_argument("-r", "--dataset_root", type=str, default="../depth_data/")
    parser.add_argument("-d", "--imgdir", type=str, default="image")
    parser.add_argument("-max", "--dpt_max", type=float, default=4)
    parser.add_argument("--case", type=str, default="lego")
    parser.add_argument("--epochs", default=100, type=int)
    parser.add_argument("-lr", "--learning-rate", default=0.00001, type=float)
    parser.add_argument("--logdir", type=str, default="log")
    parser.add_argument("--model_name", type=str, default="DenseNetWaveLet")
    parser.add_argument("--disparity", action="store_true")
    parser.add_argument("--loss_scales", nargs="+", type=int, default=[0, 1, 2, 3])
    parser.add_argument("--output_scales", nargs="+", type=int, default=[0, 1, 2, 3])
    parser.add_argument("--gpu", type=int, default=0)
    parser.add_argument("-bs", "--batch-size", default=4, type=int)
    parser.add_argument("--save_freq", default=30, type=int)
    parser.add_argument("--num_workers", default=0, type=int)
    parser.add_argument("-ckpt", "--pretrained-ckpt", type=str, default=None)
    parser.add_argument("-c", "--continue-train", action="store_true")
    parser.add_argument("--log_histogram", action="store_true")
    parser.add_argument("--normalize_input", action="store_true")
    parser.add_argument("--supervise_LL", action="store_true", default=True)
    parser.add_argument("--encoder_type", type=str, default="densenet")
    parser.add_argument("--use_wavelets", action="store_true", default=True)
    parser.add_argument("--no_pretrained", action="store_true", default=False)
    parser.add_argument("--dw_waveconv", action="store_true")
    parser.add_argument("--dw_upconv", action="store_true")
    parser.add_argument("--use_224", action="store_true", default=False)
    parser.add_argument("--image_size", type=int, default=800,
                        help="training resolution (reference hardcodes 800)")
    parser.add_argument("--val_freq", type=int, default=300)
    parser.add_argument("--log_every", type=int, default=100,
                        help="scalar-logging stride in steps (default "
                             "matches the original print cadence; short "
                             "QC windows pass 1 so metrics.jsonl carries "
                             "the full loss trajectory)")
    return parser.parse_args(argv)


def finetune(argv=None, device=None) -> str:
    """Run the finetune; returns the run's log folder (checkpoints under
    ``models/weights_<epoch>``)."""
    args = parse_argument(argv)
    device = resolve_device(device, args.gpu)
    configure_numerics()
    # shapes are fixed within a run: let cuDNN time its f32 algorithms once,
    # unless the caller asked for deterministic ones (then the step repeats
    # bit for bit: train_lib's resize has no atomics)
    torch.backends.cudnn.benchmark = not torch.backends.cudnn.deterministic

    logpath = os.path.join(
        args.logdir, args.model_name,
        datetime.datetime.now().strftime("%m%d_%H%M")
        + "-msk_{}_{}".format(args.case, args.imgdir.split("image")[-1]),
    )
    os.makedirs(logpath, exist_ok=True)
    save_opts(logpath, args)
    with open(os.path.join(logpath, "commandline_args.txt"), "w") as f:
        f.write(" ".join(sys.argv[1:] if argv is None else argv))

    opts = WaveletOpts(
        encoder_type=args.encoder_type,
        normalize_input=args.normalize_input,
        use_wavelets=args.use_wavelets,
        use_224=args.use_224,
    )
    model = create_model(opts, device)
    if args.pretrained_ckpt is not None:
        load_model_from_folder(model, args.pretrained_ckpt)

    root_folder = os.path.join(args.dataset_root, args.case)
    train_loader, test_loader = get_neus_train_test_data(
        root_folder, imgdir=args.imgdir, batch_size=args.batch_size,
        dpt_max=args.dpt_max, image_size=args.image_size,
    )

    step_fn = make_finetune_step(model, args.learning_rate, encoder_only=True)
    eval_fn = make_eval_fn(model)
    lr_sched = cosine_epoch_lr(args.learning_rate, args.epochs)

    writer = MetricsWriter(os.path.join(logpath, "train"))
    val_writer = MetricsWriter(os.path.join(logpath, "val"))
    niter = 0
    last_saved = -1
    test_iter = iter(test_loader)
    for epoch in range(args.epochs):
        lr = lr_sched(epoch)
        for batch in train_loader:
            metrics = step_fn(batch_to_device(batch, device), lr)
            niter += 1
            if niter % args.log_every == 0:
                loss = float(metrics["loss"])
                print(f"Epoch [{epoch}] iter {niter} loss {loss:.4f}")
                writer.write(niter, {"loss": loss, "lr": lr})
            if niter % args.val_freq == 0:
                try:
                    vbatch = next(test_iter)
                except StopIteration:
                    test_iter = iter(test_loader)
                    vbatch = next(test_iter)
                vbatch = batch_to_device(vbatch, device)
                voutputs, vmetrics = eval_fn(vbatch)
                log_val_batch(
                    val_writer, niter, vbatch, voutputs, vmetrics,
                    output_scales=tuple(args.output_scales),
                    use_wavelets=args.use_wavelets,
                    log_histogram=args.log_histogram,
                )
        if epoch % args.save_freq == 0:
            save_model(model, logpath, epoch)
            last_saved = epoch
    if last_saved != args.epochs - 1:
        save_model(model, logpath, args.epochs - 1)
    writer.close()
    val_writer.close()
    print(logpath)
    return logpath


if __name__ == "__main__":
    finetune()
