"""Traffic kind ``train_window_full``: ``train_window`` at the program that
``Runner.train`` runs at the window's steps, with learned cameras where the
conf learns them.

- The program: before ``train.resample_from`` the runner trains the faithful
  core (its renderer's ``n_render_samples`` set to 0), after it the
  resampled one. The driver gives the timed path that program's networks,
  and the reference and :func:`vdnbench.work.counts` that program's model
  conf; a cell whose steps would cross the switch raises.
- Learned cameras (``train.focal_learnable``): set-up writes
  ``image/cameras_sphere_colmap.npz`` (the conf's camera file) with each
  true pose perturbed from the seed at the mix's ``pose_noise`` (a rotation
  vector of ``rot_rad`` a component left-multiplied, ``trans`` added to each
  translation component: COLMAP-grade noise), the focal the scene's; the
  colour targets stay the true renders. The check adds the camera leaves
  ``r``, ``t`` and ``fx``: the first gradient as the camera Adams' first
  moments hold it, and the change after ``change_after`` steps, against
  :mod:`vdnbench.reference.learned_cameras` from the same perturbed poses:
  ``cam_grad_diff`` and ``cam_change_diff``, the worst leaf's ||program -
  reference|| over the leaf's own reference norm. Adam's first updates are
  ``lr`` times the sign of each element's gradient, near enough, so the
  change leaves out each element of ``r`` and ``t`` whose reference gradient
  at a checked step is under :data:`SIGN_FLOOR` of its camera's row there:
  rounding decides its sign (the base check leaves out whole leaves that
  move by round-off alone). Every number ``train_window`` compares is kept.

With fixed cameras the check is ``train_window``'s.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys

import numpy as np
import torch

from vdnbench.drivers import train_window
from vdnbench.drivers.common import own_diffs, worse, worst_of
from vdnbench.reference import learned_cameras
from vdnbench.scene import pixel_table

CAMERA_LEAVES = ("r", "t", "fx")
# an element of r or t whose gradient is under this share of its camera's
# row (the program's camera gradient departs by up to 5e-3 of it, PERF.md
# section 2) is left out of the change: rounding may flip its Adam update
SIGN_FLOOR = 0.1


def sign_decided(steps: list[dict]) -> dict[str, torch.Tensor]:
    """Per camera leaf, the elements whose every nonzero gradient over the
    checked steps ``steps`` ([{"r", "t", "fx"}]) is at least
    :data:`SIGN_FLOOR` of its camera's row (``fx``: always)."""
    keep = {}
    for k in CAMERA_LEAVES:
        ok = torch.ones_like(steps[0][k], dtype=torch.bool)
        if k != "fx":
            for g in steps:
                row = g[k].norm(dim=-1, keepdim=True)
                ok &= (row == 0) | (g[k].abs() >= SIGN_FLOOR * row)
        keep["cam." + k] = ok.cpu()
    return keep


def resample_boundary(train_cfg: dict, model_cfg: dict, start: int) -> int:
    """The step at which ``Runner.train`` started at ``start`` switches to
    the resampled core (0: no switch ahead)."""
    n_core = model_cfg["neus_renderer"].get("n_render_samples", 0)
    resample_from = train_cfg.get("resample_from", 0)
    if n_core > 0 and resample_from > start:
        return min(resample_from, train_cfg["end_iter"])
    return 0


def rotation(v: np.ndarray) -> np.ndarray:
    """The rotation matrix of a rotation vector (Rodrigues, float64)."""
    theta = float(np.linalg.norm(v))
    if theta == 0.0:
        return np.eye(3)
    k = v / theta
    skew = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(theta) * skew + (1.0 - np.cos(theta)) * skew @ skew


def perturbed_poses(c2w: np.ndarray, seed: int, rot_rad: float, trans: float) -> np.ndarray:
    """Each c2w's rotation left-multiplied by a rotation vector drawn with
    ``rot_rad`` a component, and ``trans`` drawn into each translation
    component; a numpy stream of its own from the seed."""
    rng = np.random.default_rng([seed, 1])
    out = np.array(c2w, dtype=np.float64, copy=True)
    for i in range(out.shape[0]):
        out[i, :3, :3] = rotation(rng.normal(scale=rot_rad, size=3)) @ out[i, :3, :3]
        out[i, :3, 3] += rng.normal(scale=trans, size=3)
    return out


def write_cameras(path: str, c2w: np.ndarray, K: np.ndarray) -> None:
    """A cameras npz (``world_mat_<stem>`` = K w2c, ``scale_mat_<stem>`` the
    identity) of the poses ``c2w``."""
    cams = {}
    for i, pose in enumerate(c2w):
        cams[f"world_mat_{i:03d}"] = (K @ np.linalg.inv(pose)).astype(np.float32)
        cams[f"scale_mat_{i:03d}"] = np.eye(4, dtype=np.float32)
    np.savez(path, **cams)


class Driver(train_window.Driver):
    def __init__(self, cell: dict, seed: int, device, workdir: str):
        super().__init__(cell, seed, device, workdir)
        start = self.traffic["start_step"]
        self.boundary = resample_boundary(self.train_cfg, self.model_cfg, start)
        self.faithful = 0 < start + 1 <= self.boundary
        if self.faithful:
            self.model_cfg = {**self.model_cfg,
                              "neus_renderer": {**self.model_cfg["neus_renderer"],
                                                "n_render_samples": 0}}
        self.learnable = bool(self.train_cfg.get("focal_learnable", False))

    def mark(self, phase: str) -> None:
        """``Base.mark``; with learned cameras the scene's phase ends with the
        perturbed camera file written beside the scene ``Base.make_runner``
        made, before the Runner reads it."""
        if phase == "scene" and self.learnable:
            noise = self.traffic["pose_noise"]
            self.init_c2w = perturbed_poses(self.made["c2w"], self.seed, noise["rot_rad"],
                                            noise["trans"])
            name = os.path.basename(self.config["conf"]["dataset"]["render_cameras_name"])
            write_cameras(os.path.join(self.workdir, "scene", "image", name), self.init_c2w,
                          self.made["K"])
        super().mark(phase)

    def make_runner(self, mode: str):
        """``Base.make_runner``, with the faithful core's networks before the
        switch."""
        runner = super().make_runner(mode)
        if self.faithful:
            runner.nets = dataclasses.replace(runner.nets, renderer=dataclasses.replace(
                runner.nets.renderer, n_render_samples=0))
        if self.learnable:
            self.cam_init = {k: v.detach().clone() for k, v in runner.cams.named_parameters()}
        return runner

    def one_window(self, n: int):
        if self.boundary and (self.step + 1 <= self.boundary) != (self.step + n <= self.boundary):
            raise ValueError(f"steps {self.step}-{self.step + n - 1} cross the core switch at "
                             f"{self.boundary}")
        return super().one_window(n)

    def adam_gradients(self) -> dict[str, torch.Tensor]:
        """``train_window``'s, and with learned cameras each camera leaf's
        first gradient as its Adam's first moment holds it (``cam.<leaf>``)."""
        out = super().adam_gradients()
        if self.learnable:
            state = {}
            for opt in self.runner.trainer.camera_optimizers():
                state.update(opt.state)
            with torch.no_grad():
                for k, p in self.runner.cams.named_parameters():
                    s = state.get(p, {})
                    out["cam." + k] = (s["exp_avg"] / 0.1 if "exp_avg" in s
                                       else torch.zeros_like(p)).cpu()
        return out

    def changes(self) -> dict[str, torch.Tensor]:
        out = super().changes()
        if self.learnable:
            with torch.no_grad():
                for k, p in self.runner.cams.named_parameters():
                    out["cam." + k] = (p - self.cam_init[k]).cpu()
        return out

    def batches(self, n: int) -> tuple[list[dict], float]:
        """The first n checked steps' batches for the reference, from the
        scene's pixels at the seed's draws, and ``batch_gap`` (as
        ``train_window``'s reference builds them)."""
        dev = self.device
        table = pixel_table(self.made)
        out, gap = [], 0.0
        for b, (img, px, py) in zip(self.checked["batches"][:n], self.pixel_draws(n)):
            color = table["color"][img, py, px]
            feats = (table["feats"][img, py, px].astype(np.float32) if table["feats"] is not None
                     else np.zeros((len(px), 1), np.float32))
            same = (int(b["img_idx"]) == img and np.array_equal(b["pixels_x"], px)
                    and np.array_equal(b["pixels_y"], py))
            gap = worse(gap, 0.0 if same else 1.0)
            if same:
                gap = worse(gap, worse(float(np.abs(b["color"] - color).max()),
                                       float(np.abs(b["feats"] - feats).max())))
            out.append({"img": img, "px": torch.as_tensor(px, device=dev),
                        "py": torch.as_tensor(py, device=dev),
                        "color": torch.as_tensor(color, device=dev),
                        "feats": torch.as_tensor(feats, device=dev)})
        return out, gap

    def reference(self, precision: str = "f32") -> dict:
        """``train_window``'s reference readings, with the learned cameras'
        (``cam.r``, ``cam.t``, ``cam.fx`` in ``grad`` and ``change``) where
        the conf learns them."""
        if not self.learnable:
            return super().reference(precision)
        from vdnbench.reference import neus

        neus.plain_numerics()
        n = self.traffic["change_after"]
        batches, batch_gap = self.batches(n)
        scene_cfg = self.config["scene"]
        cams = {"init_c2w": torch.as_tensor(self.init_c2w, dtype=torch.float32,
                                            device=self.device),
                "focal": float(self.made["K"][0, 0]), "H": scene_cfg["H"], "W": scene_cfg["W"],
                "order": self.model_cfg.get("focal", {}).get("order", 2)}
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        ref = learned_cameras.train_steps(self.train_cfg, self.model_cfg, self.weights, batches,
                                          cams, self.checked["steps"][:n], gen, precision)
        init_fx = learned_cameras.init_fx(cams["focal"], cams["W"], cams["order"])
        cam_start = {"r": 0.0, "t": 0.0, "fx": init_fx}
        grad = {k: g.cpu() for k, g in ref["first_grad"].items()}
        change = {k: (v - self.weights[k]).cpu() for k, v in ref["params"].items()}
        for k in CAMERA_LEAVES:
            grad["cam." + k] = ref["cam_grads"][0][k].cpu()
            change["cam." + k] = (ref["cam_params"][k] - cam_start[k]).cpu()
        return {"losses": ref["losses"], "rows": ref["metrics"], "grad": grad, "change": change,
                "cam_keep": sign_decided(ref["cam_grads"]), "batch_gap": batch_gap}

    @staticmethod
    def compare(got: dict, ref: dict) -> dict:
        """``train_window``'s numbers over the networks' leaves, and with
        learned cameras ``cam_grad_diff`` and ``cam_change_diff``: the worst
        camera leaf's ||program - reference|| over its own reference norm,
        the change over the elements ``ref["cam_keep"]`` holds."""

        def networks(readings):
            return {**readings, **{part: {k: v for k, v in readings[part].items()
                                          if not k.startswith("cam.")}
                                   for part in ("grad", "change")}}

        out = train_window.Driver.compare(networks(got), networks(ref))
        cams = [k for k in ref["grad"] if k.startswith("cam.")]
        if cams:
            out["cam_grad_diff"], out["worst"]["cam_grad_diff"] = worst_of(
                own_diffs(got["grad"], ref["grad"], cams))
            keep = ref["cam_keep"]
            out["cam_change_diff"], out["worst"]["cam_change_diff"] = worst_of(own_diffs(
                {k: got["change"][k][keep[k]] for k in cams},
                {k: ref["change"][k][keep[k]] for k in cams}, cams))
        return out


# -- planted faults of the learned cameras, for the controls and the tests ----


@contextlib.contextmanager
def planted(fault: str):
    """The program with a fault of its learned cameras planted under the
    timed path: ``cam_grad_zero`` (the cameras' gradients zeroed before the
    update), ``cam_adam_skipped`` (the camera Adams never step), or
    ``poses_clean`` (the camera file holds the true poses, while the
    reference starts from the perturbed ones)."""
    from vdnerf_tpu_torch.train.step import Trainer

    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if fault == "cam_grad_zero":
        gradients = Trainer.device_gradients

        def zeroed(self, *args, **kw):
            metrics = gradients(self, *args, **kw)
            for p in self.cam_params:
                p.grad.zero_()
            return metrics

        patch(Trainer, "device_gradients", zeroed)
    elif fault == "cam_adam_skipped":
        patch(Trainer, "camera_optimizers", lambda self: [])
    elif fault == "poses_clean":
        module = sys.modules[__name__]
        perturb, write, true = module.perturbed_poses, module.write_cameras, []

        def remembered(c2w, *args):
            true.append(c2w)
            return perturb(c2w, *args)

        patch(module, "perturbed_poses", remembered)
        patch(module, "write_cameras", lambda path, c2w, K: write(path, true[-1], K))
    else:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)

