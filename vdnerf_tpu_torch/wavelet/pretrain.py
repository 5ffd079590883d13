"""NYU pretraining CLI for the monodepth net.

Counterpart of ``vdnerf_tpu/wavelet/pretrain.py`` (the same flags): the
multi-scale wavelet losses over the DenseDepth NYU zip, the whole model
trained (encoder and decoder), one validation batch every ``--val_freq``
steps (from ``data/nyu2_test.csv``, or, where the zip has no test list, the
last tenth of the train pairs held out), per-epoch checkpoints.

Usage:
    python -m vdnerf_tpu_torch.wavelet.pretrain --nyu_zip nyu_data.zip --epochs 20
"""

from __future__ import annotations

import argparse
import datetime
import os

import torch

from vdnerf_tpu_torch.io.logging import MetricsWriter
from vdnerf_tpu_torch.utils.device import configure_numerics, resolve_device
from vdnerf_tpu_torch.wavelet.data import BatchLoader, NYUZipDataset
from vdnerf_tpu_torch.wavelet.io import save_model, save_opts
from vdnerf_tpu_torch.wavelet.model import WaveletOpts, create_model
from vdnerf_tpu_torch.wavelet.train_lib import (
    batch_to_device,
    cosine_epoch_lr,
    log_val_batch,
    make_eval_fn,
    make_finetune_step,
)


def build_parser():
    p = argparse.ArgumentParser(description="NYU wavelet-monodepth pretraining")
    p.add_argument("--nyu_zip", type=str, required=True)
    p.add_argument("--epochs", default=20, type=int)
    p.add_argument("-lr", "--learning-rate", default=0.0001, type=float)
    p.add_argument("--logdir", type=str, default="log")
    p.add_argument("--model_name", type=str, default="DenseNetWaveLet")
    p.add_argument("-bs", "--batch-size", default=8, type=int)
    p.add_argument("--save_freq", default=1, type=int)
    p.add_argument("--normalize_input", action="store_true")
    p.add_argument("--encoder_type", type=str, default="densenet")
    p.add_argument("--use_224", action="store_true", default=False)
    p.add_argument("--image_size", type=int, default=448)
    p.add_argument("--max_steps_per_epoch", type=int, default=0)
    p.add_argument("--val_freq", type=int, default=300,
                   help="validate on one eval-split minibatch every N iters "
                        "(reference wavelet/train.py:334)")
    p.add_argument("--log_histogram", action="store_true")
    return p


def pretrain(argv=None, device=None) -> str:
    """Run the pretraining; returns the run's log folder."""
    args = build_parser().parse_args(argv)
    device = resolve_device(device)
    configure_numerics()
    # shapes are fixed within a run: let cuDNN time its f32 algorithms once
    torch.backends.cudnn.benchmark = True

    logpath = os.path.join(
        args.logdir, args.model_name,
        datetime.datetime.now().strftime("%m%d_%H%M") + "-nyu",
    )
    os.makedirs(logpath, exist_ok=True)
    save_opts(logpath, args)

    opts = WaveletOpts(
        encoder_type=args.encoder_type,
        normalize_input=args.normalize_input,
        use_224=args.use_224,
    )
    model = create_model(opts, device)

    dataset = NYUZipDataset(args.nyu_zip)
    loader = BatchLoader(
        dataset, args.batch_size, shuffle=True,
        image_size=args.image_size, depth_size=args.image_size // 2,
        augment=True,
    )
    # eval split (the DenseDepth zip ships data/nyu2_test.csv); without it,
    # hold the last ~10% of the train pairs out of the training set
    try:
        val_dataset = NYUZipDataset(args.nyu_zip, "data/nyu2_test.csv")
    except KeyError:
        val_dataset = NYUZipDataset(args.nyu_zip)
        if len(dataset.pairs) > 1:
            n_val = max(len(dataset.pairs) // 10, 1)
            val_dataset.pairs = dataset.pairs[-n_val:]
            dataset.pairs = dataset.pairs[:-n_val]
    val_loader = BatchLoader(
        val_dataset, args.batch_size, shuffle=False,
        image_size=args.image_size, depth_size=args.image_size // 2,
        augment=False,
    )

    step_fn = make_finetune_step(model, args.learning_rate, encoder_only=False)
    eval_fn = make_eval_fn(model)
    lr_sched = cosine_epoch_lr(args.learning_rate, args.epochs)
    writer = MetricsWriter(os.path.join(logpath, "train"))
    val_writer = MetricsWriter(os.path.join(logpath, "val"))

    niter = 0
    last_saved = -1
    val_iter = iter(val_loader)
    for epoch in range(args.epochs):
        lr = lr_sched(epoch)
        for i, batch in enumerate(loader):
            if args.max_steps_per_epoch and i >= args.max_steps_per_epoch:
                break
            metrics = step_fn(batch_to_device(batch, device), lr)
            niter += 1
            if niter % 100 == 0:
                loss = float(metrics["loss"])
                print(f"Epoch [{epoch}][{i}] loss {loss:.4f}")
                writer.write(niter, {"loss": loss, "lr": lr})
            if niter % args.val_freq == 0:
                try:
                    vbatch = next(val_iter)
                except StopIteration:
                    val_iter = iter(val_loader)
                    vbatch = next(val_iter)
                vbatch = batch_to_device(vbatch, device)
                voutputs, vmetrics = eval_fn(vbatch)
                log_val_batch(val_writer, niter, vbatch, voutputs, vmetrics,
                              log_histogram=args.log_histogram)
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
    pretrain()
