"""Checkpoint loading for the port.

Reads two formats into a :class:`NeuSModel`:

- the JAX package's ``checkpoints/ckpt_<iter:06d>.npz``: flattened state
  leaves keyed ``NNNNN|params/sdf/layers/0/v``, ``NNNNN|step`` (read with
  numpy alone);
- a reference ``ckpt_<iter:06d>.pth``: one ``state_dict`` per network under
  ``nerf`` / ``sdf_network_fine`` / ``variance_network_fine`` /
  ``color_network_fine`` (/ ``depth_network_fine`` for the wdepth confs),
  plus ``iter_step`` and, from training, ``optimizer`` (the torch Adam
  ``state_dict``, parameters in that network order).

Training writes the second format (:func:`save_training_checkpoint`), with the
optimizer's state on the host whatever device trained; the JAX package's
``import_torch_checkpoint(..., with_optimizer=True)`` reads its parameters and
Adam moments.

The learnable confs' cameras go beside each checkpoint into the reference's
``pnf_checkpoints/pnf_<iter:06d>.pth`` (:func:`save_pnf_checkpoint`):
``pose_param_net`` {r, t, init_c2w}, ``intrin_net`` {fx}, ``poses_iter_step``,
and the two camera Adams under ``optimizer_pose`` / ``optimizer_focal``;
the JAX package's ``import_torch_pnf_checkpoint`` reads the cameras. A JAX
``ckpt_*.npz`` of a learnable run holds them as ``cams/...`` leaves
(:func:`read_jax_cams`).

:func:`from_jax_params` carries a JAX parameter tree over: ``[in, out]``
weights become ``[out, in]``, ``g`` becomes ``weight_g`` of shape ``[out, 1]``;
:func:`from_jax_cams` does the same for the JAX ``cams`` tree.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

NETS = ("nerf", "sdf_network_fine", "variance_network_fine", "color_network_fine",
        "depth_network_fine")


def _nets_of(model: torch.nn.Module) -> list[str]:
    """The networks of NETS the model has (the depth head only with one)."""
    return [name for name in NETS if hasattr(model, name)]


def _tensor(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32))


def linear_state(prefix: str, p: dict) -> dict[str, torch.Tensor]:
    """One JAX linear ({v, g, b} or {w, b}) -> state_dict entries under ``prefix``."""
    if "v" in p:
        return {
            f"{prefix}.weight_v": _tensor(np.asarray(p["v"]).T),
            f"{prefix}.weight_g": _tensor(p["g"]).reshape(-1, 1),
            f"{prefix}.bias": _tensor(p["b"]),
        }
    return {f"{prefix}.weight": _tensor(np.asarray(p["w"]).T), f"{prefix}.bias": _tensor(p["b"])}


def from_jax_params(params_np: dict) -> dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> the port's ``NeuSModel`` state_dict."""
    sd: dict[str, torch.Tensor] = {}
    for l, p in enumerate(params_np["sdf"]["layers"]):
        sd.update(linear_state(f"sdf_network_fine.lin{l}", p))
    for l, p in enumerate(params_np["color"]["layers"]):
        sd.update(linear_state(f"color_network_fine.lin{l}", p))
    for l, p in enumerate(params_np.get("depth", {}).get("layers", [])):
        sd.update(linear_state(f"depth_network_fine.lin{l}", p))
    nerf = params_np["nerf"]
    for i, p in enumerate(nerf["pts_linears"]):
        sd.update(linear_state(f"nerf.pts_linears.{i}", p))
    sd.update(linear_state("nerf.views_linears.0", nerf["views_linears"][0]))
    for head in ("feature_linear", "alpha_linear", "rgb_linear", "dpt_linear"):
        if head in nerf:
            sd.update(linear_state(f"nerf.{head}", nerf[head]))
    sd["variance_network_fine.variance"] = _tensor(params_np["variance"]["variance"]).reshape(())
    return sd


def from_jax_cams(cams_np: dict) -> dict[str, torch.Tensor]:
    """JAX learned-camera tree ({pose: {r, t}, focal: {fx}, init_c2w}, numpy
    leaves) -> the port's ``LearnedCameras`` state_dict."""
    sd = {"r": _tensor(cams_np["pose"]["r"]), "t": _tensor(cams_np["pose"]["t"]),
          "fx": _tensor(cams_np["focal"]["fx"]).reshape(())}
    if "init_c2w" in cams_np:
        sd["init_c2w"] = _tensor(cams_np["init_c2w"])
    return sd


def _unflatten(flat: dict[str, np.ndarray]) -> Any:
    """{'a/0/b': x} -> {'a': [{'b': x}]}: numeric keys become list indices."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [fix(node[str(i)]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}

    return fix(tree)


def _read_npz_tree(path: str, prefix: str) -> tuple[dict, int]:
    """The leaves of a JAX ``ckpt_*.npz`` under ``prefix/`` as a tree of
    numpy arrays, and iter_step."""
    flat, step = {}, 0
    with np.load(path) as data:
        for key in data.files:
            leaf_path = key.split("|", 1)[1]
            if leaf_path.startswith(prefix + "/"):
                flat[leaf_path[len(prefix) + 1:]] = data[key]
            elif leaf_path == "step":
                step = int(data[key])
    return _unflatten(flat), step


def read_jax_checkpoint(path: str) -> tuple[dict, int]:
    """A JAX ``ckpt_*.npz`` -> (params tree of numpy arrays, iter_step)."""
    return _read_npz_tree(path, "params")


def read_jax_cams(path: str) -> dict | None:
    """The learned cameras of a JAX ``ckpt_*.npz`` (numpy tree), or None when
    the run had fixed cameras."""
    cams, _ = _read_npz_tree(path, "cams")
    return cams if "pose" in cams else None


def load_jax_checkpoint(path: str, model: torch.nn.Module) -> int:
    params, step = read_jax_checkpoint(path)
    model.load_state_dict(from_jax_params(params))
    return step


def load_reference_checkpoint(path: str, model: torch.nn.Module,
                              optimizer: torch.optim.Optimizer | None = None) -> int:
    """Load the networks (and, when given, the optimizer) -> iter_step."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for name in _nets_of(model):
        getattr(model, name).load_state_dict(ckpt[name])
    if optimizer is not None:
        load_optimizer_state(optimizer, ckpt["optimizer"])
    return int(ckpt.get("iter_step", 0))


def load_optimizer_state(optimizer: torch.optim.Optimizer, state_dict: dict) -> None:
    """``load_state_dict`` that keeps a capturable optimizer (the card's)
    capturable: its lr tensor, which the captured step reads, is rebound, and
    its step counts go to the device."""
    keep = [(g["lr"], g.get("capturable", False)) for g in optimizer.param_groups]
    optimizer.load_state_dict(state_dict)
    for group, (lr, capturable) in zip(optimizer.param_groups, keep):
        if capturable:
            group.update(lr=lr, capturable=True)
            for p in group["params"]:
                if p in optimizer.state:
                    state = optimizer.state[p]
                    state["step"] = state["step"].to(p.device, torch.float32)


def reference_optimizer_state(optimizer: torch.optim.Optimizer) -> dict:
    """The optimizer's ``state_dict`` in the reference format, whatever the
    device: host tensors, a float learning rate, ``capturable`` off."""
    sd = optimizer.state_dict()
    return {
        "state": {i: {k: v.detach().cpu() if torch.is_tensor(v) else v for k, v in st.items()}
                  for i, st in sd["state"].items()},
        "param_groups": [{**g, "lr": float(g["lr"]), "capturable": False}
                         for g in sd["param_groups"]],
    }


def save_training_checkpoint(path: str, model: torch.nn.Module, iter_step: int,
                             optimizer: torch.optim.Optimizer | None = None) -> None:
    """Write the networks in the reference ``ckpt_*.pth`` layout, plus the
    optimizer when given, atomically (``.tmp`` then ``os.replace``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    ckpt = {name: getattr(model, name).state_dict() for name in _nets_of(model)}
    if optimizer is not None:
        ckpt["optimizer"] = reference_optimizer_state(optimizer)
    ckpt["iter_step"] = iter_step
    _save_atomic(ckpt, path)


def _save_atomic(obj: dict, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_pnf_checkpoint(path: str, cams: torch.nn.Module, iter_step: int,
                        pose_optimizer: torch.optim.Optimizer | None = None,
                        focal_optimizer: torch.optim.Optimizer | None = None) -> None:
    """Write ``LearnedCameras`` in the reference ``pnf_*.pth`` layout, plus
    the camera Adams when given (reference format), atomically."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    sd = {k: v.detach().cpu() for k, v in cams.state_dict().items()}
    ckpt = {"pose_param_net": {k: sd[k] for k in ("r", "t", "init_c2w")},
            "intrin_net": {"fx": sd["fx"]}, "poses_iter_step": iter_step}
    for key, opt in (("optimizer_pose", pose_optimizer), ("optimizer_focal", focal_optimizer)):
        if opt is not None:
            ckpt[key] = reference_optimizer_state(opt)
    _save_atomic(ckpt, path)


def load_pnf_checkpoint(path: str, cams: torch.nn.Module,
                        pose_optimizer: torch.optim.Optimizer | None = None,
                        focal_optimizer: torch.optim.Optimizer | None = None) -> int:
    """Load a reference ``pnf_*.pth`` into ``LearnedCameras`` (and, when given
    and saved, the camera Adams) -> poses_iter_step."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    pose, intrin = ckpt["pose_param_net"], ckpt["intrin_net"]
    sd = {"r": pose["r"], "t": pose["t"], "fx": intrin["fx"].reshape(()),
          "init_c2w": pose.get("init_c2w", cams.init_c2w)}
    cams.load_state_dict(sd)
    for key, opt in (("optimizer_pose", pose_optimizer), ("optimizer_focal", focal_optimizer)):
        if opt is not None and key in ckpt:
            load_optimizer_state(opt, ckpt[key])
    return int(ckpt.get("poses_iter_step", 0))


def checkpoint_path(base_exp_dir: str, iter_step: int) -> str:
    return os.path.join(base_exp_dir, "checkpoints", f"ckpt_{iter_step:06d}.pth")


def pnf_path(base_exp_dir: str, iter_step: int) -> str:
    return os.path.join(base_exp_dir, "pnf_checkpoints", f"pnf_{iter_step:06d}.pth")


def latest_checkpoint(base_exp_dir: str) -> str | None:
    """The lexicographically latest ``checkpoints/ckpt_*.pth``, or None."""
    d = os.path.join(base_exp_dir, "checkpoints")
    if not os.path.isdir(d):
        return None
    names = sorted(n for n in os.listdir(d) if n.startswith("ckpt") and n.endswith(".pth"))
    return os.path.join(d, names[-1]) if names else None
