"""Training machinery of the monodepth side-car (pretrain and VDN finetune).

Counterpart of ``vdnerf_tpu/wavelet/train_lib.py``:

- per scale s: the align-corners bilinear resize of ``("disp", s)`` to the
  target, masked, 0.1 * L1 against the masked depth;
- plus, where the decoder emits ``("wavelets", 3, "LL")`` (the 224
  decoders), L1 against the 4-level Haar DWT of the target over 2^4;
- Adam (beta 0.9 / 0.999, eps 1e-8 outside the square root, as
  ``optax.adam``) with the lr set once per epoch from the cosine schedule;
  finetuning trains the encoder only, the decoder frozen, while the whole
  model runs in training mode (the encoder's BatchNorms use and update batch
  statistics).

Batches are dicts of NCHW float32 tensors: ``image`` [N, 3, H, W], ``depth``
and ``mask`` [N, 1, H/2, W/2].
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vdnerf_tpu_torch.wavelet.haar import haar_dwt2_multi


def _align_corners_weights(n_in: int, n_out: int, like: torch.Tensor) -> torch.Tensor:
    """[n_out, n_in]: row i holds the two linear-interpolation weights of
    source position i (n_in - 1) / (n_out - 1)."""
    src = torch.arange(n_out, dtype=torch.float64) * ((n_in - 1) / max(n_out - 1, 1))
    i0 = src.floor().long().clamp(0, n_in - 1)
    w1 = src - i0
    rows = torch.arange(n_out)
    m = torch.zeros(n_out, n_in, dtype=torch.float64)
    m[rows, i0] += 1.0 - w1
    m[rows, (i0 + 1).clamp(max=n_in - 1)] += w1
    return m.to(like.device, like.dtype)


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``F.interpolate(x, (out_h, out_w), mode="bilinear", align_corners=True)``
    as two products with the interpolation weights, along the width, then
    the height. Its backward is two products too, where interpolate's
    accumulates with atomics on the card: the finetune step repeats bit for
    bit under deterministic cuDNN."""
    h, w = x.shape[-2:]
    if (h, w) == (out_h, out_w):
        return x
    rows = x @ _align_corners_weights(w, out_w, x).t()
    return _align_corners_weights(h, out_h, x) @ rows


def multiscale_depth_loss(outputs: dict, depth_n: torch.Tensor, mask: torch.Tensor,
                          loss_scales=(0, 1, 2, 3), output_scales=(0, 1, 2, 3),
                          supervise_ll: bool = True, dwt_levels: int = 4):
    """-> (total_loss, per-scale metric dict); depth_n / mask [N, 1, H, W]."""
    h, w = depth_n.shape[-2:]
    total = 0.0
    metrics = {}
    for scale in range(4):
        if scale not in output_scales or ("disp", scale) not in outputs:
            continue
        pred = resize_bilinear_align_corners(outputs[("disp", scale)], h, w) * mask
        l_depth = (pred - depth_n).abs().mean()
        loss = 0.1 * l_depth
        if scale in loss_scales:
            total = total + loss
        metrics[f"loss/{scale}"] = loss
        metrics[f"loss_depth/{scale}"] = l_depth

    if supervise_ll and ("wavelets", 3, "LL") in outputs:
        yl_gt, _ = haar_dwt2_multi(depth_n, dwt_levels)
        l_ll = (outputs[("wavelets", 3, "LL")] - yl_gt).abs().mean() / (2**dwt_levels)
        metrics["loss_LL3"] = l_ll
        total = total + l_ll

    metrics["loss"] = total
    return total, metrics


def cosine_epoch_lr(base_lr: float, epochs: int, alpha: float = 0.05, warmup: int = 0):
    """epoch -> lr: a cosine from base_lr down to alpha * base_lr over
    ``epochs``, after an optional linear warm-up."""

    def schedule(epoch: int) -> float:
        if warmup and epoch < warmup:
            return base_lr * epoch / warmup
        progress = (epoch - warmup) / max(epochs - warmup, 1)
        return base_lr * ((math.cos(math.pi * progress) + 1.0) * 0.5 * (1 - alpha) + alpha)

    return schedule


def batch_to_device(batch: dict, device) -> dict[str, torch.Tensor]:
    """The loader's NCHW numpy arrays as float32 tensors on ``device``."""
    return {k: torch.from_numpy(batch[k]).to(device, non_blocking=True)
            for k in ("image", "depth", "mask")}


def finetune_loss(model: torch.nn.Module, batch: dict):
    """-> (total, metrics) of the model's current mode on one batch."""
    outputs = model(batch["image"])
    depth_n = batch["depth"] * batch["mask"]
    return multiscale_depth_loss(outputs, depth_n, batch["mask"])


def make_finetune_step(model: torch.nn.Module, base_lr: float, encoder_only: bool = True):
    """-> step_fn(batch, lr) -> metrics (detached tensors).

    Trains the encoder's parameters only, the decoder's frozen, when
    ``encoder_only``; the Adam state lives in the closure.
    """
    if encoder_only:
        model.decoder.requires_grad_(False)
    trainable = (model.encoder if encoder_only else model).parameters()
    opt = torch.optim.Adam(trainable, lr=base_lr, betas=(0.9, 0.999), eps=1e-8)

    def step_fn(batch: dict, lr: float) -> dict:
        model.train()
        for group in opt.param_groups:
            group["lr"] = lr
        total, metrics = finetune_loss(model, batch)
        opt.zero_grad(set_to_none=True)
        total.backward()
        opt.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step_fn


def make_eval_fn(model: torch.nn.Module):
    """eval_fn(batch) -> (outputs, metrics), running BatchNorm statistics."""

    @torch.no_grad()
    def eval_fn(batch: dict):
        model.eval()
        outputs = model(batch["image"])
        depth_n = batch["depth"] * batch["mask"]
        _, metrics = multiscale_depth_loss(outputs, depth_n, batch["mask"])
        return outputs, metrics

    return eval_fn


def _norm_img(x):
    """Per-image min/max normalization (reference utils normalize_image)."""
    a = np.asarray(x, dtype=np.float32)
    lo, hi = float(a.min()), float(a.max())
    return (a - lo) / max(hi - lo, 1e-9)


def _hwc(t) -> np.ndarray:
    """One [C, H, W] tensor or array -> [H, W, C] numpy."""
    a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return np.transpose(a, (1, 2, 0))


def log_val_batch(writer, niter: int, batch: dict, outputs: dict, metrics: dict,
                  output_scales=(0, 1, 2, 3), use_wavelets: bool = True,
                  log_histogram: bool = False, max_images: int = 4) -> None:
    """Mid-training validation logging with the reference's tag layout
    (wavelet/train.py:113-166): per-scale loss scalars; colour, predicted and
    ground-truth disparity images; predicted and ground-truth LL and detail
    images; optionally histograms of every logged coefficient map. Images go
    in HWC, as the JAX package writes them."""
    writer.write(niter, {k: v for k, v in metrics.items()})

    depth_n = batch["depth"] * batch["mask"]
    yl_gt = yh_gt = None
    if use_wavelets:
        yl_gt, yh_gt = haar_dwt2_multi(depth_n, 4)

    n = min(depth_n.shape[0], max_images)
    for j in range(n):
        writer.write_image(niter, f"color/{j}", _hwc(batch["image"][j]))
        writer.write_image(niter, f"disp_0_gt/{j}", _norm_img(_hwc(depth_n[j])))
        for scale in output_scales:
            if ("disp", scale) in outputs:
                writer.write_image(niter, f"disp_{scale}_pred/{j}",
                                   _norm_img(_hwc(outputs[("disp", scale)][j])))
        if not use_wavelets:
            continue
        if ("wavelets", 3, "LL") in outputs:
            pred_ll = _hwc(outputs[("wavelets", 3, "LL")][j])
            gt_ll = _hwc(yl_gt[j])
            writer.write_image(niter, f"LL_3_pred/{j}", _norm_img(pred_ll))
            writer.write_image(niter, f"LL_3_gt/{j}", _norm_img(gt_ll))
            if log_histogram:
                writer.write_histogram(niter, f"hist_LL_3_pred/{j}", pred_ll)
                writer.write_histogram(niter, f"hist_LL_3_gt/{j}", gt_ll)
        for scale in range(4):
            for c, coeff in enumerate(("LH", "HL", "HH")):
                if ("wavelets", scale, coeff) not in outputs:
                    continue
                pred = _hwc(outputs[("wavelets", scale, coeff)][j])
                gt = _hwc(yh_gt[scale][c][j])
                writer.write_image(niter, f"{coeff}_{scale}_pred/{j}", _norm_img(pred))
                writer.write_image(niter, f"{coeff}_{scale}_gt/{j}", _norm_img(gt))
                if log_histogram:
                    writer.write_histogram(niter, f"hist_{coeff}_{scale}_pred/{j}", pred)
                    writer.write_histogram(niter, f"hist_{coeff}_{scale}_gt/{j}", gt)
