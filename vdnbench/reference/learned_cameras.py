"""Plain PyTorch reference of the learned cameras and their training steps.

Written out from VDN-NeRF's learned poses and focal (``dpt_models/poses.py``,
``lie_group_helper.py``): per camera an axis-angle ``r`` and a translation
``t`` (zero at the start), the learned pose ``make_c2w(r, t) @ init_c2w``
with ``make_c2w`` the Rodrigues exponential of ``r`` beside ``t``; one focal
parameter ``fx``, the focal ``fx^2 W`` at order 2 (``fx W`` at order 1), the
principal point at (W/2, H/2), the rays through ``K^-1`` of that K. The pose
and focal learning rates are multistep (``gamma`` per milestone passed), each
leaf set stepped by an Adam of its own past ``start_refine_pose_iter``.

Departures, each shared with the program and the JAX package:

- the reference reads the focal through ``.item()`` (``poses.py:77-93``), so
  no gradient reaches ``fx``; here K is built from ``fx`` differentiably and
  ``fx`` learns;
- the focal milestones are the reference's literal tuple ``(warm_up_end,
  end_iter, step_size)`` (a tuple where a range was meant), as the program
  and the JAX package read them (``train/schedules.py``); the pose
  milestones are every ``step_size`` steps from ``warm_up_end``.

Imports neither JAX nor the program: the networks, the render and the loss
are :mod:`vdnbench.reference.neus`'s, called unchanged with each step's
learned c2w and ``K^-1``, with one function in its place while they run
(:func:`points_in_graph`): ``neus.sdf_value_grad_feat`` detaches its input
points, whose gradient is no leaf's with fixed cameras; with learned cameras
the SDF value, its spatial gradient and the feature reach ``r``, ``t`` and
``fx`` through the points, as in the model.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from vdnbench.reference import neus


def vec2skew(v: torch.Tensor) -> torch.Tensor:
    """[3] -> the [3, 3] skew-symmetric matrix of the cross product."""
    zero = torch.zeros_like(v[0])
    return torch.stack([torch.stack([zero, -v[2], v[1]]),
                        torch.stack([v[2], zero, -v[0]]),
                        torch.stack([-v[1], v[0], zero])])


def so3_exp(r: torch.Tensor) -> torch.Tensor:
    """Rodrigues: I + sin|r|/|r| [r]x + (1 - cos|r|)/|r|^2 [r]x^2, with the
    reference's 1e-15 added to |r| (``lie_group_helper.py`` ``Exp``)."""
    skew = vec2skew(r)
    norm = r.norm() + 1e-15
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    return (eye + (torch.sin(norm) / norm) * skew
            + ((1.0 - torch.cos(norm)) / norm**2) * (skew @ skew))


def make_c2w(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[3] rotation vector, [3] translation -> [4, 4]."""
    top = torch.cat([so3_exp(r), t[:, None]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=r.dtype, device=r.device)
    return torch.cat([top, bottom], dim=0)


def intrinsics(fx: torch.Tensor, H: int, W: int, order: int) -> torch.Tensor:
    """[4, 4] K of the focal parameter, differentiable in ``fx``."""
    f = fx**2 * W if order == 2 else fx * W
    centre = torch.tensor([[0.0, 0.0, W / 2.0, 0.0], [0.0, 0.0, H / 2.0, 0.0],
                           [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]],
                          dtype=fx.dtype, device=fx.device)
    focal = torch.tensor([[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0],
                          [0.0, 0.0, 0.0, 0.0]], dtype=fx.dtype, device=fx.device)
    return centre + f * focal


def init_fx(focal: float, W: int, order: int) -> float:
    """The focal parameter of an initial focal length, in f32."""
    ratio = np.float32(focal / float(W))
    return float(np.sqrt(ratio) if order == 2 else ratio)


def multistep(base: float, gamma: float, milestones, step: int) -> float:
    """``base * gamma ** (milestones <= step)``, in f32."""
    n = sum(step >= m for m in milestones)
    return float(np.float32(base) * np.float32(float(np.float32(gamma)) ** n))


def pose_lr_at(tc: dict, step: int) -> float:
    milestones = range(tc["warm_up_end"], tc["end_iter"], max(tc["step_size"], 1))
    return multistep(tc["pose_lr"], tc["pose_lr_gamma"], milestones, step)


def focal_lr_at(tc: dict, step: int) -> float:
    milestones = (tc["warm_up_end"], tc["end_iter"], tc["step_size"])
    return multistep(tc["focal_lr"], tc["focal_lr_gamma"], milestones, step)


def sdf_value_grad_feat(cfg, p, pts, mm, create_graph: bool):
    """:func:`neus.sdf_value_grad_feat` with ``pts`` kept in the graph where
    it carries a gradient."""
    with torch.enable_grad():
        x = pts if pts.requires_grad else pts.detach().requires_grad_(True)
        out = neus.sdf_forward(cfg, p, x, mm)
        sdf = out[:, :1]
        (grad,) = torch.autograd.grad(sdf, x, torch.ones_like(sdf), create_graph=create_graph)
    if not create_graph:
        return sdf.detach(), grad.detach(), out[:, 1:].detach()
    return sdf, grad, out[:, 1:]


@contextlib.contextmanager
def points_in_graph():
    """:mod:`neus` with :func:`sdf_value_grad_feat` in place of its own."""
    saved = neus.sdf_value_grad_feat
    neus.sdf_value_grad_feat = sdf_value_grad_feat
    try:
        yield
    finally:
        neus.sdf_value_grad_feat = saved


def train_steps(tc: dict, cfg: dict, params: dict, batches: list[dict], cams: dict,
                steps: list[int], generator: torch.Generator, precision: str = "f32") -> dict:
    """:func:`neus.train_steps` with learned cameras: each step's c2w and
    ``K^-1`` from ``r``, ``t`` and ``fx``, the loss :func:`neus.loss`, the
    networks' Adam, and past ``start_refine_pose_iter`` the pose Adam over
    (r, t) and the focal Adam over fx. ``cams``: {"init_c2w" [n, 4, 4],
    "focal", "H", "W", "order"}. -> :func:`neus.train_steps`'s readings,
    and ``cam_grads`` (each step's), ``cam_params``: {"r", "t", "fx"}."""
    mm = neus.MM[precision]
    dev = cams["init_c2w"].device
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    n = cams["init_c2w"].shape[0]
    cam = {"r": torch.zeros(n, 3, device=dev, requires_grad=True),
           "t": torch.zeros(n, 3, device=dev, requires_grad=True),
           "fx": torch.tensor(init_fx(cams["focal"], cams["W"], cams["order"]), device=dev,
                              requires_grad=True)}
    opt, pose_opt = neus.Adam(p), neus.Adam({k: cam[k] for k in ("r", "t")})
    focal_opt = neus.Adam({"fx": cam["fx"]})
    losses, rows, first_grad, cam_steps = [], [], None, []
    for batch, step in zip(batches, steps):
        i = batch["img"]
        dr = neus.draws(cfg, batch["px"].shape[0], generator)
        c2w = make_c2w(cam["r"][i], cam["t"][i]) @ cams["init_c2w"][i]
        K_inv = torch.linalg.inv(intrinsics(cam["fx"], cams["H"], cams["W"], cams["order"]))
        with points_in_graph():
            value, row = neus.loss(tc, cfg, p, batch, c2w, K_inv, dr, mm, step)
        rows.append(row)
        leaves = {**p, **{"cam." + k: v for k, v in cam.items()}}
        grads = torch.autograd.grad(value, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)}
        net_grads = {k: grads[k] for k in p}
        cam_grads = {k: grads["cam." + k] for k in cam}
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in net_grads.items()}
        cam_steps.append({k: g.detach().clone() for k, g in cam_grads.items()})
        opt.step(p, net_grads, neus.lr_at(tc, step))
        if step > tc["start_refine_pose_iter"]:
            pose_opt.step({k: cam[k] for k in ("r", "t")}, cam_grads, pose_lr_at(tc, step))
            focal_opt.step({"fx": cam["fx"]}, cam_grads, focal_lr_at(tc, step))
        losses.append(float(value.detach()))
    return {"losses": losses, "metrics": rows, "first_grad": first_grad,
            "params": {k: v.detach() for k, v in p.items()},
            "cam_grads": cam_steps,
            "cam_params": {k: v.detach() for k, v in cam.items()}}
