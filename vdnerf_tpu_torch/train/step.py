"""The NeuS train step: pixel batch -> rays -> render -> losses -> Adam.

Counterpart of ``vdnerf_tpu/train/step.py`` for fixed cameras: rays of the
batch's pixels, near/far on the unit sphere, the render (jitter and
stratified resample drawn from a ``torch.Generator``), the L1 colour +
eikonal + mask-BCE loss, and Adam with ``neus_lr_schedule``.

Every normaliser of the loss is a global sum over the batch, taken through
:func:`_global_sum`: a data-parallel version all-reduces there, and the
sharded loss is then the single-device one.
"""

from __future__ import annotations

import numpy as np
import torch

from vdnerf_tpu_torch.data.cameras import pixels_to_rays
from vdnerf_tpu_torch.data.dataset import near_far_from_sphere
from vdnerf_tpu_torch.ops.renderer import NeuSModel, NeuSNetworks, render
from vdnerf_tpu_torch.train.config import TrainConfig
from vdnerf_tpu_torch.train.schedules import neus_lr_schedule

def _global_sum(x: torch.Tensor) -> torch.Tensor:
    """A sum over this process's rays; across ranks, the place to all-reduce."""
    return x


def cos_anneal_ratio(step: int, anneal_end: int) -> float:
    """min(1, step / anneal_end) in f32; 1.0 when annealing is off."""
    if anneal_end == 0:
        return 1.0
    return float(min(np.float32(1.0), np.float32(step) / np.float32(anneal_end)))


def rays_from_batch(cams: dict, batch: dict, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Rays of the batch's pixels; ``cams`` holds ``pose_all`` [n, 4, 4] and
    ``intrin_inv_all`` [n, 4, 4] on the device."""
    idx = int(batch["img_idx"])
    px = torch.as_tensor(batch["pixels_x"], device=device)
    py = torch.as_tensor(batch["pixels_y"], device=device)
    return pixels_to_rays(cams["pose_all"][idx], cams["intrin_inv_all"][idx], px, py)


def loss_fn(nets: NeuSNetworks, tcfg: TrainConfig, model: NeuSModel, cams: dict,
            batch: dict, step: int, generator: torch.Generator | None):
    """-> (loss, metrics {name: detached scalar tensor})."""
    dev = cams["pose_all"].device
    rays_o, rays_d = rays_from_batch(cams, batch, dev)
    near, far = near_far_from_sphere(rays_o, rays_d)
    true_rgb = torch.as_tensor(batch["color"], device=dev)
    mask_raw = torch.as_tensor(batch["mask"], device=dev)
    background_rgb = torch.ones(1, 3, device=dev) if tcfg.use_white_bkgd else None
    if tcfg.use_mask:
        mask = (mask_raw > 0.1).float()
    else:
        mask = torch.ones_like(mask_raw)
    mask_sum = _global_sum(mask.sum()) + 1e-5

    out = render(nets, model, rays_o, rays_d, near, far, generator=generator,
                 background_rgb=background_rgb,
                 cos_anneal_ratio=cos_anneal_ratio(step, tcfg.anneal_end))
    color_fine = out["color_fine"]

    color_error = (color_fine - true_rgb) * mask
    color_fine_loss = _global_sum(color_error.abs().sum()) / mask_sum
    sq = _global_sum(((color_fine - true_rgb) ** 2 * mask).sum())
    psnr = 20.0 * torch.log10(1.0 / torch.sqrt(sq / (mask_sum * 3.0)))

    eik_num = _global_sum(out["gradient_error_num"].sum())
    eik_den = _global_sum(out["gradient_error_den"].sum())
    eikonal_loss = eik_num / (eik_den + 1e-5)

    w = torch.clamp(out["weight_sum"], 1e-3, 1.0 - 1e-3)
    bce = -(mask * torch.log(w) + (1.0 - mask) * torch.log(1.0 - w))
    n_total = _global_sum(torch.tensor(float(bce.numel()), device=dev))
    mask_loss = _global_sum(bce.sum()) / n_total

    loss = color_fine_loss + eikonal_loss * tcfg.igr_weight + mask_loss * tcfg.mask_weight
    metrics = {
        "loss": loss,
        "color_loss": color_fine_loss,
        "eikonal_loss": eikonal_loss,
        "mask_loss": mask_loss,
        "psnr": psnr,
        "s_val": out["s_val"].mean(),
        "cdf": _global_sum((out["cdf_fine"][:, :1] * mask).sum()) / mask_sum,
        "weight_max": _global_sum((out["weight_max"] * mask).sum()) / mask_sum,
    }
    return loss, {k: v.detach() for k, v in metrics.items()}


class Trainer:
    """One optimizer step per :meth:`step`: gradients of the loss (averaged
    over ``grad_accum`` microbatches), then ``torch.optim.Adam`` over
    ``model.parameters()`` (nerf, sdf, variance, colour: the reference's
    order) with the learning rate ``neus_lr_schedule(step)`` set before the
    update, ``step`` counting updates from 0 as optax's ``count`` does (so
    the first update under warm-up moves nothing)."""

    def __init__(self, tcfg: TrainConfig, model: NeuSModel, cams: dict,
                 generator: torch.Generator | None):
        self.tcfg = tcfg
        self.model = model
        self.cams = cams
        self.generator = generator
        self.params = list(model.parameters())
        self.optimizer = torch.optim.Adam(self.params, lr=tcfg.learning_rate,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.schedule = neus_lr_schedule(
            tcfg.learning_rate, tcfg.warm_up_end, tcfg.lr_end_iter or tcfg.end_iter,
            tcfg.learning_rate_alpha,
        )

    def gradients(self, nets: NeuSNetworks, batch: dict, step: int) -> dict:
        """Fill ``p.grad`` with the step's gradient -> metrics. With
        ``grad_accum`` > 1 the rays split into that many contiguous
        microbatches, and gradients and metrics are their means."""
        accum = max(self.tcfg.grad_accum, 1)
        n = len(batch["pixels_x"])
        if n % accum:
            raise ValueError(f"batch of {n} rays does not split into {accum} microbatches")
        m = n // accum
        for p in self.params:
            p.grad = None
        sums = {}
        for k in range(accum):
            sub = {name: v if name == "img_idx" else v[k * m:(k + 1) * m]
                   for name, v in batch.items()}
            loss, metrics = loss_fn(nets, self.tcfg, self.model, self.cams, sub, step,
                                    self.generator)
            loss.backward()
            sums = {name: sums.get(name, 0.0) + v for name, v in metrics.items()}
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif accum > 1:
                p.grad.mul_(1.0 / accum)
        return {name: v * (1.0 / accum) if accum > 1 else v for name, v in sums.items()}

    def apply(self, step: int) -> None:
        """The Adam update of step ``step`` from the gradients in ``p.grad``."""
        lr = self.schedule(step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()

    def step(self, nets: NeuSNetworks, batch: dict, step: int) -> dict:
        """Training step ``step`` (0-based) on a pixel batch -> metrics
        (device scalars)."""
        metrics = self.gradients(nets, batch, step)
        self.apply(step)
        return metrics
