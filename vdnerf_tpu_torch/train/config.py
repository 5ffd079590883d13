"""Typed training configuration, built from the HOCON ``train`` block.

Counterpart of ``vdnerf_tpu/train/config.py``: the same fields, defaults and
conf keys, so every conf gives the same ``TrainConfig`` in both packages, and
``bf16`` (``train.bf16``), which the JAX runner reads from the conf itself
to switch its matmul policy on (``models/precision.py``).
"""

from __future__ import annotations

import dataclasses
import logging

from vdnerf_tpu_torch.utils.hocon import Config

log = logging.getLogger(__name__)

# Largest ray batch one gradient computation takes before the batch is split
# into grad_accum microbatches. The JAX package set it as a guard for its TPU
# compiler; on the card it is kept for parity: every conf then trains the same
# estimator (the mean of per-microbatch losses) in both packages.
MAX_MONOLITHIC_BATCH = 2048


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 5e-4
    learning_rate_alpha: float = 0.05
    end_iter: int = 300_000
    batch_size: int = 512
    validate_resolution_level: int = 4
    warm_up_end: int = 0
    anneal_end: int = 0
    use_white_bkgd: bool = True
    save_freq: int = 10_000
    val_freq: int = 5_000
    val_mesh_freq: int = 10_000
    report_freq: int = 500
    igr_weight: float = 0.1
    mask_weight: float = 0.0
    use_mask: bool = False
    # microbatches per step, gradients averaged (the mean of per-microbatch
    # losses, each normalised by its own sums)
    grad_accum: int = 1
    # training steps per dispatch window (clipped by the runner's gcd rule):
    # on the card each is one replay of the captured step, with one upload
    # and at most one metrics readback per window; the run is the same at
    # every value
    steps_per_call: int = 1
    # cosine-lr horizon (0 = end_iter); steps past it hold the alpha*lr floor
    lr_end_iter: int = 0
    # onset of the importance-resampled render core
    # (neus_renderer.n_render_samples): the faithful full-width core trains
    # before this iteration
    resample_from: int = 0
    # depth distillation (wdepth confs)
    extract_depth: bool = False
    depth_start_iter: int = 0
    depth_weight: float = 0.0
    only_depth: bool = False
    depth_before_color: bool = False
    rgb_dims: int = 3
    depth_ramp_iters: int = 5_000
    depth_loss_scale: float = 1.0
    # learned cameras (learn confs)
    learnable: bool = False
    focal_lr: float = 0.0
    pose_lr: float = 0.0
    focal_lr_gamma: float = 1.0
    pose_lr_gamma: float = 1.0
    step_size: int = 1
    start_refine_pose_iter: int = 0
    start_refine_focal_iter: int = 0
    # the SDF value+gradient+feature block in bf16 (models/precision.py)
    bf16: bool = False

    def __post_init__(self):
        # split a batch above MAX_MONOLITHIC_BATCH into the fewest
        # microbatches that divide it, as the JAX package does
        accum = max(self.grad_accum, 1)
        if self.batch_size // accum > MAX_MONOLITHIC_BATCH:
            new_accum = -(-self.batch_size // MAX_MONOLITHIC_BATCH)
            while self.batch_size % new_accum:
                new_accum += 1
            log.warning(
                "batch_size %d / grad_accum %d = %d rays per gradient exceeds %d; "
                "setting grad_accum=%d, as the JAX package does",
                self.batch_size, accum, self.batch_size // accum,
                MAX_MONOLITHIC_BATCH, new_accum,
            )
            object.__setattr__(self, "grad_accum", new_accum)

    @classmethod
    def from_conf(cls, conf: Config) -> "TrainConfig":
        t = conf["train"]
        extract_depth = t.get_bool("extract_depth", default=False)
        learnable = t.get_bool("focal_learnable", default=False)
        kw = dict(
            learning_rate=t.get_float("learning_rate"),
            learning_rate_alpha=t.get_float("learning_rate_alpha"),
            end_iter=t.get_int("end_iter"),
            batch_size=t.get_int("batch_size"),
            validate_resolution_level=t.get_int("validate_resolution_level"),
            warm_up_end=t.get_int("warm_up_end", default=0),
            anneal_end=t.get_int("anneal_end", default=0),
            use_white_bkgd=t.get_bool("use_white_bkgd"),
            save_freq=t.get_int("save_freq"),
            val_freq=t.get_int("val_freq"),
            val_mesh_freq=t.get_int("val_mesh_freq"),
            report_freq=t.get_int("report_freq"),
            igr_weight=t.get_float("igr_weight"),
            mask_weight=t.get_float("mask_weight"),
            use_mask=t.get_bool("use_mask", default=False),
            grad_accum=t.get_int("grad_accum", default=1),
            steps_per_call=t.get_int("steps_per_call", default=1),
            resample_from=t.get_int("resample_from", default=0),
            lr_end_iter=t.get_int("lr_end_iter", default=0),
            extract_depth=extract_depth,
            rgb_dims=t.get_int("rgb_dims", default=3) if extract_depth else 3,
            learnable=learnable,
            bf16=t.get_bool("bf16", default=False),
        )
        if extract_depth:
            kw.update(
                only_depth=t.get_bool("only_depth", default=False),
                depth_before_color=t.get_bool("depth_before_color", default=False),
                depth_start_iter=t.get_int("depth_start_iter"),
                depth_weight=t.get_float("depth_weight", default=0.0),
                depth_loss_scale=t.get_float("depth_loss_scale", default=1.0),
            )
        if learnable:
            kw.update(
                focal_lr=t.get_float("focal_lr"),
                pose_lr=t.get_float("pose_lr"),
                focal_lr_gamma=t.get_float("focal_lr_gamma"),
                pose_lr_gamma=t.get_float("pose_lr_gamma"),
                step_size=t.get_int("step_size"),
                start_refine_pose_iter=t.get_int("start_refine_pose_iter"),
                start_refine_focal_iter=t.get_int("start_refine_focal_iter"),
            )
        return cls(**kw)
