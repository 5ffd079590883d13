"""The NeuS train step: pixel batch -> rays -> render -> losses -> Adam.

Counterpart of ``vdnerf_tpu/train/step.py``: rays of the batch's pixels
(from the fixed cameras, or from the learned pose and focal, so that their
gradients flow), near/far on the unit sphere, the render (jitter and
stratified resample drawn from a ``torch.Generator``), the L1 colour +
eikonal + mask-BCE loss (plus, for the wdepth confs, the sigmoid-ramped
depth-feature distillation loss), Adam with ``neus_lr_schedule``, and for
the learnable confs the pose and focal updates (Adam at the multistep
learning rates of the global step) past ``start_refine_pose_iter``.

Every normaliser of the loss is a global sum over the batch, taken through
the trainer's :class:`World` (``parallel/mesh.py``): in a world with a
process group it is all-reduced over the ranks, and the sharded loss is the
single-process one. The gradients are then summed over the ranks once per
step, after the microbatches (:meth:`Trainer.device_gradients`).

What depends on the step number reaches the step as data, so that one
captured step serves every step (``train/dispatch.py``): the batch as device
tensors, and :attr:`Trainer.inputs`, a device record of the step's
``cos_anneal_ratio``, distillation weight and learning rates (main, pose,
focal), computed on the host in f32 (:meth:`Trainer.step_inputs`). Whether
the distillation term is in the loss (``distill``) and whether the cameras
are refined (``refine``) are separate programs, where the JAX step
multiplies by a gate and branches by ``lax.cond``.

Spans (``utils/trace.py``): ``step`` around :meth:`Trainer.program`, and in
it the render's (``ops/renderer.py``; the batch's rays and near/far in a
``render.rays`` of their own, the learned cameras' c2w and K^-1 in a
``render.cameras`` inside it), ``step.loss``, ``step.backward`` (split by
the render's backward points, and with learned cameras by ``bwd.cameras``
on the batch's rays, whose piece is the cameras' backward; its first piece
is the loss's and the composite's), ``step.allreduce`` (grouped worlds) and
``step.adam``; every Adam's construction in ``setup.optimizer``.
"""

from __future__ import annotations

import numpy as np
import torch

from vdnerf_tpu_torch.data.cameras import LearnedCameras, pixels_to_rays
from vdnerf_tpu_torch.data.dataset import near_far_from_sphere
from vdnerf_tpu_torch.ops.renderer import NeuSModel, NeuSNetworks, render
from vdnerf_tpu_torch.parallel import World, all_reduce_grads
from vdnerf_tpu_torch.train.config import TrainConfig
from vdnerf_tpu_torch.train.schedules import (
    focal_lr_milestones,
    multistep_schedule,
    neus_lr_schedule,
    pose_lr_milestones,
)
from vdnerf_tpu_torch.utils import trace

# the fields of Trainer.inputs
STEP_INPUTS = ("cos_anneal_ratio", "distill_weight", "lr", "pose_lr", "focal_lr")


def metric_names(tcfg: TrainConfig) -> tuple[str, ...]:
    """The scalars one step reports, in the order loss_fn gives them."""
    names = ("loss", "color_loss", "eikonal_loss", "mask_loss", "psnr", "s_val", "cdf",
             "weight_max")
    return names + (("depth_loss", "psnr_dfeat") if tcfg.extract_depth else ())


def depth_ramp_weight(depth_iter: int, total_iter: int = 5000) -> float:
    """Sigmoid ramp of the distillation loss, in f32 as the JAX package."""
    d = np.float32(depth_iter)
    return float(np.float32(1.0) / (np.exp(np.float32(-10.0) * (d / np.float32(total_iter)
                                                                - np.float32(0.5)))
                                    + np.float32(1.0)))


def cos_anneal_ratio(step: int, anneal_end: int) -> float:
    """min(1, step / anneal_end) in f32; 1.0 when annealing is off."""
    if anneal_end == 0:
        return 1.0
    return float(min(np.float32(1.0), np.float32(step) / np.float32(anneal_end)))


def upload_batch(batch: dict, device) -> dict[str, torch.Tensor]:
    """A host pixel batch (numpy leaves, or the [K, ...] stack of a window)
    -> tensors on ``device``; to the card through pinned memory without
    blocking the host. Tensors pass through."""
    device = torch.device(device)
    out = {}
    for name, v in batch.items():
        t = torch.as_tensor(v)
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        out[name] = t.to(device, non_blocking=True)
    return out


def rays_from_batch(cams, batch: dict, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Rays of the batch's pixels. ``cams``: the fixed cameras, a dict of
    ``pose_all`` [n, 4, 4] and ``intrin_inv_all`` [n, 4, 4] on the device,
    or :class:`LearnedCameras` (the learned c2w and the inverse of the
    learned K, differentiable). The camera is picked by an index tensor, so
    a batch already on the device is read without a host round trip."""
    b = upload_batch({k: batch[k] for k in ("img_idx", "pixels_x", "pixels_y")}, device)
    idx = b["img_idx"].reshape(1)
    if isinstance(cams, LearnedCameras):
        with trace.span("render.cameras"):
            pose, intrin_inv = cams.c2w(idx)[0], cams.K_inv()
    else:
        pose = cams["pose_all"].index_select(0, idx)[0]
        intrin_inv = cams["intrin_inv_all"].index_select(0, idx)[0]
    return pixels_to_rays(pose, intrin_inv, b["pixels_x"], b["pixels_y"])


def loss_fn(nets: NeuSNetworks, tcfg: TrainConfig, model: NeuSModel, cams,
            batch: dict, inputs, distill: bool, generator: torch.Generator | None,
            world: World | None = None):
    """-> (loss, metrics {name: detached scalar tensor}). ``cams``: as
    :func:`rays_from_batch` takes them; ``batch``: tensors on the cameras'
    device; ``inputs``: the step's STEP_INPUTS (the device record, or
    floats); ``distill``: the distillation term is in the loss; ``world``:
    whose ``sum`` takes every normaliser (JAX's ``_psum``), this process
    alone by default."""
    gsum = (world or World()).sum
    dev = batch["color"].device
    with trace.span("render.rays"):
        # the learned cameras' backward, after every layer's, is a piece of its own
        rays_o, rays_d = trace.point("bwd.cameras", *rays_from_batch(cams, batch, dev))
        near, far = near_far_from_sphere(rays_o, rays_d)
        background_rgb = torch.ones(1, 3, device=dev) if tcfg.use_white_bkgd else None

    out = render(nets, model, rays_o, rays_d, near, far, generator=generator,
                 background_rgb=background_rgb,
                 cos_anneal_ratio=inputs[0],
                 depth_before_color=tcfg.depth_before_color)
    with trace.span("step.loss"):
        return _loss(tcfg, batch, out, inputs, distill, gsum)


def _loss(tcfg: TrainConfig, batch: dict, out: dict, inputs, distill: bool, gsum):
    """The loss and the metrics of a render ``out`` of the batch's rays."""
    true_rgb = batch["color"]
    mask_raw = batch["mask"]
    if tcfg.use_mask:
        mask = (mask_raw > 0.1).float()
    else:
        mask = torch.ones_like(mask_raw)
    mask_sum = gsum(mask.sum()) + 1e-5
    color_fine = out["color_fine"]

    color_error = (color_fine - true_rgb) * mask
    color_fine_loss = gsum(color_error.abs().sum()) / mask_sum
    sq = gsum(((color_fine - true_rgb) ** 2 * mask).sum())
    psnr = 20.0 * torch.log10(1.0 / torch.sqrt(sq / (mask_sum * 3.0)))

    eik_num = gsum(out["gradient_error_num"].sum())
    eik_den = gsum(out["gradient_error_den"].sum())
    eikonal_loss = eik_num / (eik_den + 1e-5)

    w = torch.clamp(out["weight_sum"], 1e-3, 1.0 - 1e-3)
    bce = -(mask * torch.log(w) + (1.0 - mask) * torch.log(1.0 - w))
    n_total = gsum(bce.new_full((), float(bce.numel())))
    mask_loss = gsum(bce.sum()) / n_total

    loss = color_fine_loss + eikonal_loss * tcfg.igr_weight + mask_loss * tcfg.mask_weight
    metrics = {
        "loss": loss,
        "color_loss": color_fine_loss,
        "eikonal_loss": eikonal_loss,
        "mask_loss": mask_loss,
        "psnr": psnr,
        "s_val": out["s_val"].mean(),
        "cdf": gsum((out["cdf_fine"][:, :1] * mask).sum()) / mask_sum,
        "weight_max": gsum((out["weight_max"] * mask).sum()) / mask_sum,
    }

    if tcfg.extract_depth:
        gt_feats = batch["feats"]
        feats = out["render_feats"]
        depth_fine_loss = gsum(((feats - gt_feats) * mask).abs().sum()) / mask_sum
        dsq = gsum(((feats - gt_feats) ** 2 * mask).sum())
        # mask_sum * 3 whatever the channel count, as the JAX package
        psnr_dfeat = 20.0 * torch.log10(1.0 / torch.sqrt(dsq / (mask_sum * 3.0)))
        if distill:
            loss = loss + inputs[1] * depth_fine_loss
        metrics.update(loss=loss, depth_loss=depth_fine_loss, psnr_dfeat=psnr_dfeat)
    return loss, {k: v.detach() for k, v in metrics.items()}


class Trainer:
    """One optimizer step per :meth:`step`: gradients of the loss (averaged
    over ``grad_accum`` microbatches), then ``torch.optim.Adam`` over
    ``model.parameters()`` (nerf, sdf, variance, colour[, depth head]: the
    reference's order) with the learning rate ``neus_lr_schedule(step)`` set before the
    update, ``step`` counting updates from 0 as optax's ``count`` does (so
    the first update under warm-up moves nothing).

    With :class:`LearnedCameras` (the learnable confs) the loss also takes
    the gradient of the cameras' ``r``, ``t`` and ``fx`` (dense: zero rows
    for the cameras not in the batch), and past ``start_refine_pose_iter``
    (:meth:`refines`; it gates pose and focal alike, as in the JAX step) two
    more Adams step, one over (r, t) and one over fx, with optax
    ``scale_by_adam``'s defaults at the multistep learning rates of the
    global step. Before the gate they neither step nor count.

    On the card every Adam is ``capturable``: its step counts live on the
    device and its learning rate is a field of ``inputs`` (``lr``,
    ``pose_lr``, ``focal_lr``), so that a captured step reads the schedule's
    value of the step it replays. On the CPU they are torch's default Adam,
    with the learning rate a float set before each update.

    ``world`` (``parallel/mesh.py``) decides whether the step communicates:
    in a grouped world the loss's sums and the gradients are reduced over its
    ranks; by default the trainer is this process alone."""

    def __init__(self, tcfg: TrainConfig, model: NeuSModel, cams,
                 generator: torch.Generator | None, world: World | None = None):
        self.tcfg = tcfg
        self.model = model
        self.cams = cams
        self.generator = generator
        self.world = world or World()
        self.params = list(model.parameters())
        self.device = self.params[0].device
        self.capturable = self.device.type == "cuda"
        # the step's STEP_INPUTS, on the device
        self.inputs = torch.zeros(len(STEP_INPUTS), device=self.device)
        self.optimizer = self._adam(self.params, 2, tcfg.learning_rate)
        self.schedule = neus_lr_schedule(
            tcfg.learning_rate, tcfg.warm_up_end, tcfg.lr_end_iter or tcfg.end_iter,
            tcfg.learning_rate_alpha,
        )
        self.learnable = isinstance(cams, LearnedCameras)
        if self.learnable != tcfg.learnable:
            raise ValueError("a learnable conf trains LearnedCameras, a fixed one a camera dict")
        self.cam_params = []
        if self.learnable:
            self.cam_params = list(cams.parameters())
            self.pose_optimizer = self._adam(cams.pose_params(), 3, tcfg.pose_lr)
            self.focal_optimizer = self._adam([cams.fx], 4, tcfg.focal_lr)
            self.pose_schedule = multistep_schedule(
                tcfg.pose_lr,
                pose_lr_milestones(tcfg.warm_up_end, tcfg.end_iter, tcfg.step_size),
                tcfg.pose_lr_gamma)
            self.focal_schedule = multistep_schedule(
                tcfg.focal_lr,
                focal_lr_milestones(tcfg.warm_up_end, tcfg.end_iter, tcfg.step_size),
                tcfg.focal_lr_gamma)
        self.metric_names = metric_names(tcfg)

    def _adam(self, params, field: int, lr: float) -> torch.optim.Adam:
        """Adam (0.9, 0.999, 1e-8) whose lr on the card is ``inputs[field]``."""
        with trace.span("setup.optimizer"):
            return torch.optim.Adam(params, lr=self.inputs[field] if self.capturable else lr,
                                    betas=(0.9, 0.999), eps=1e-8, capturable=self.capturable)

    def camera_optimizers(self) -> list[torch.optim.Adam]:
        """The cameras' Adams, pose then focal (lrs ``inputs[3]``, ``inputs[4]``)."""
        return [self.pose_optimizer, self.focal_optimizer] if self.learnable else []

    def distills(self, step: int) -> bool:
        """Step ``step`` has the distillation term in its loss."""
        return self.tcfg.extract_depth and step > self.tcfg.depth_start_iter

    def refines(self, step: int) -> bool:
        """Step ``step`` updates the learned cameras."""
        return self.learnable and step > self.tcfg.start_refine_pose_iter

    def step_inputs(self, step: int) -> np.ndarray:
        """STEP_INPUTS of step ``step`` as f32 [5]: min(1, step / anneal_end),
        the distillation weight (its sigmoid ramp times ``depth_loss_scale``,
        0 where :meth:`distills` is false), ``neus_lr_schedule(step)``, and
        the pose and focal learning rates (0 without learned cameras)."""
        t = self.tcfg
        weight = 0.0
        if self.distills(step):
            weight = depth_ramp_weight(step - t.depth_start_iter - 1,
                                       t.depth_ramp_iters) * t.depth_loss_scale
        cam_lrs = [0.0, 0.0]
        if self.learnable:
            cam_lrs = [self.pose_schedule(step), self.focal_schedule(step)]
        return np.array([cos_anneal_ratio(step, t.anneal_end), weight, self.schedule(step),
                         *cam_lrs], np.float32)

    def set_inputs(self, step: int) -> None:
        self.inputs.copy_(upload_batch({"inputs": self.step_inputs(step)}, self.device)["inputs"])

    def gradients(self, nets: NeuSNetworks, batch: dict, step: int) -> dict:
        """Fill ``p.grad`` with the gradient of step ``step`` on a host batch
        -> metrics (see :meth:`device_gradients`)."""
        self.set_inputs(step)
        return self.device_gradients(nets, upload_batch(batch, self.device), self.distills(step))

    def device_gradients(self, nets: NeuSNetworks, batch: dict, distill: bool) -> dict:
        """Fill ``p.grad`` of the networks (and the learned cameras) with the
        gradient at ``inputs`` on a batch of device tensors -> metrics. With
        ``grad_accum`` > 1 the rays split into that many contiguous
        microbatches, and gradients and metrics are their means. In a
        grouped ``world`` the batch is this rank's block, and the gradients are
        then summed over the ranks in one all-reduce (JAX's ``psum`` after
        the accumulation scan). Each ``.grad`` is made anew by the first
        backward (under capture, in the graph's pool, where every replay
        writes it)."""
        accum = max(self.tcfg.grad_accum, 1)
        n = batch["pixels_x"].shape[0]
        if n % accum:
            raise ValueError(f"batch of {n} rays does not split into {accum} microbatches")
        m = n // accum
        params = self.params + self.cam_params
        for p in params:
            p.grad = None
        sums = {}
        for k in range(accum):
            sub = {name: v if name == "img_idx" else v[k * m:(k + 1) * m]
                   for name, v in batch.items()}
            loss, metrics = loss_fn(nets, self.tcfg, self.model, self.cams, sub, self.inputs,
                                    distill, self.generator, self.world)
            with trace.span("step.backward"):
                loss.backward()
            sums = metrics if k == 0 else {name: sums[name] + v for name, v in metrics.items()}
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif accum > 1:
                p.grad.mul_(1.0 / accum)
        if self.world.grouped:
            with trace.span("step.allreduce"):
                all_reduce_grads(params)
        return {name: v * (1.0 / accum) if accum > 1 else v for name, v in sums.items()}

    def apply(self, step: int) -> None:
        """The Adam updates of step ``step`` from the gradients in ``p.grad``."""
        self.set_inputs(step)
        self._update(self.refines(step))

    def _update(self, refine: bool) -> None:
        """Adam at the learning rate ``inputs[2]``, and with ``refine`` the
        camera Adams at ``inputs[3]`` and ``inputs[4]``: read there by the
        capturable Adams on the card, set as floats on the CPU."""
        opts = [self.optimizer] + (self.camera_optimizers() if refine else [])
        for opt, field in zip(opts, (2, 3, 4)):
            if not self.capturable:
                for group in opt.param_groups:
                    group["lr"] = float(self.inputs[field])
            opt.step()

    def program(self, nets: NeuSNetworks, batch: dict, distill: bool, refine: bool,
                step: int | None = None) -> dict:
        """One step at ``inputs`` on a batch of device tensors, gradients then
        Adam -> metrics: what a captured step runs. ``step``: the step's
        number for the trace, where it is known (not in a capture)."""
        with trace.span("step", id=step):
            metrics = self.device_gradients(nets, batch, distill)
            with trace.span("step.adam"):
                self._update(refine)
        return metrics

    def step(self, nets: NeuSNetworks, batch: dict, step: int) -> dict:
        """Training step ``step`` (0-based) on a host pixel batch -> metrics
        (device scalars)."""
        self.set_inputs(step)
        return self.program(nets, upload_batch(batch, self.device), self.distills(step),
                            self.refines(step), step)
