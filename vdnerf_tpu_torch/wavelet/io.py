"""Checkpoint and opts I/O for the monodepth side-car.

Counterpart of ``vdnerf_tpu/wavelet/io.py``: per-epoch model folders
(``models/weights_<epoch>/model.npz``), the tolerant partial restore (keys
present in both checkpoint and model with the same shape are restored, the
rest keep their values) and the ``opts.json`` dump.

``model.npz`` holds the JAX package's flattened flax keys
(``params/encoder/denseblock1/DenseLayer_0/Conv_0/kernel``,
``batch_stats/encoder/norm0/mean``) with HWIO conv kernels, so the JAX
``load_model`` restores a port checkpoint and this ``load_model`` a JAX one.
:func:`from_jax_variables` and :func:`to_jax_variables` translate between
that tree and the port's ``state_dict``:

- leaves: conv ``kernel`` [kh, kw, in, out] <-> ``weight`` [out, in, kh, kw];
  BatchNorm ``scale`` / ``bias`` (params) and ``mean`` / ``var``
  (batch_stats) <-> ``weight`` / ``bias`` / ``running_mean`` /
  ``running_var``;
- DenseNet scopes <-> torchvision names: ``denseblock{i}/DenseLayer_{j}/
  {BatchNorm_0, Conv_0, BatchNorm_1, Conv_1}`` <-> ``features.denseblock{i}.
  denselayer{j+1}.{norm1, conv1, norm2, conv2}``, ``transition{i}/
  {BatchNorm_0, Conv_0}`` <-> ``features.transition{i}.{norm, conv}``,
  ``conv0`` / ``norm0`` <-> ``features.conv0`` / ``features.norm0``;
- decoder scopes: each flax ``Conv3x3`` wraps one ``Conv_0``, which the port's
  plain conv drops, and an up block's ``Conv3x3_0`` is its ``conv``;
- ResNet and MobileNet scopes are the port's module names already.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

_LEAF = {("params", "kernel"): "weight", ("params", "scale"): "weight",
         ("params", "bias"): "bias", ("batch_stats", "mean"): "running_mean",
         ("batch_stats", "var"): "running_var"}
_DENSE_LAYER = {"BatchNorm_0": "norm1", "Conv_0": "conv1", "BatchNorm_1": "norm2",
                "Conv_1": "conv2"}
_TRANSITION = {"BatchNorm_0": "norm", "Conv_0": "conv"}
_DENSE_LAYER_INV = {v: k for k, v in _DENSE_LAYER.items()}
_TRANSITION_INV = {v: k for k, v in _TRANSITION.items()}


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _is_dense_scope(name: str) -> bool:
    return name in ("conv0", "norm0") or name.startswith(("denseblock", "transition"))


def _port_key(flax_key: str) -> str:
    col, *scope, leaf = flax_key.split("/")
    if scope[0] == "encoder" and _is_dense_scope(scope[1]):
        out = ["encoder", "features", scope[1]]
        if scope[1].startswith("denseblock"):
            out += [f"denselayer{int(scope[2].rsplit('_', 1)[1]) + 1}", _DENSE_LAYER[scope[3]]]
        elif scope[1].startswith("transition"):
            out.append(_TRANSITION[scope[2]])
    elif scope[0] == "decoder":
        out = ["conv" if s == "Conv3x3_0" else s for s in scope if s != "Conv_0"]
    else:
        out = scope
    return ".".join(out + [_LEAF[(col, leaf)]])


def _flax_key(port_key: str, ndim: int) -> str:
    *scope, leaf = port_key.split(".")
    if scope[0] == "encoder" and scope[1] == "features":
        out = ["encoder", scope[2]]
        if scope[2].startswith("denseblock"):
            out += [f"DenseLayer_{int(scope[3][len('denselayer'):]) - 1}",
                    _DENSE_LAYER_INV[scope[4]]]
        elif scope[2].startswith("transition"):
            out.append(_TRANSITION_INV[scope[3]])
    elif scope[0] == "decoder":
        out = scope[:-1] + (["Conv3x3_0"] if scope[-1] == "conv" else [scope[-1]]) + ["Conv_0"]
    else:
        out = scope
    col, name = {"weight": ("params", "kernel" if ndim == 4 else "scale"),
                 "bias": ("params", "bias"), "running_mean": ("batch_stats", "mean"),
                 "running_var": ("batch_stats", "var")}[leaf]
    return "/".join([col] + out + [name])


def from_jax_variables(variables: dict) -> dict[str, torch.Tensor]:
    """JAX ``{"params": ..., "batch_stats": ...}`` -> the port's state_dict."""
    sd = {}
    for key, val in _flatten(variables).items():
        val = np.asarray(val, np.float32)
        if val.ndim == 4:
            val = val.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        sd[_port_key(key)] = torch.tensor(val)
    return sd


def to_jax_variables(state_dict: dict) -> dict:
    """The port's state_dict -> the JAX variables tree (numpy leaves)."""
    flat = {}
    for key, val in state_dict.items():
        val = val.detach().cpu().numpy()
        if val.ndim == 4:
            val = val.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        flat[_flax_key(key, val.ndim)] = np.ascontiguousarray(val)
    return _unflatten(flat)


def save_model(model: torch.nn.Module, logpath: str, epoch: int) -> str:
    folder = os.path.join(logpath, "models", f"weights_{epoch}")
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, "model.npz")
    np.savez(path, **_flatten(to_jax_variables(model.state_dict())))
    return path


def load_model(model: torch.nn.Module, ckpt_path: str) -> torch.nn.Module:
    """Tolerant partial restore (reference load_save_utils.py:37-44), in place."""
    with np.load(ckpt_path) as data:
        flat_ckpt = {k: data[k] for k in data.files}
    flat_model = _flatten(to_jax_variables(model.state_dict()))
    for k in flat_model:
        if k in flat_ckpt and flat_ckpt[k].shape == flat_model[k].shape:
            flat_model[k] = flat_ckpt[k]
    model.load_state_dict(from_jax_variables(_unflatten(flat_model)))
    return model


def load_model_from_folder(model: torch.nn.Module, folder: str,
                           name: str = "model.npz") -> torch.nn.Module:
    return load_model(model, os.path.join(folder, name))


def save_opts(logpath: str, opts) -> None:
    os.makedirs(logpath, exist_ok=True)
    if dataclasses.is_dataclass(opts):
        opts = dataclasses.asdict(opts)
    elif not isinstance(opts, dict):
        opts = vars(opts)
    with open(os.path.join(logpath, "opts.json"), "w") as f:
        json.dump({k: str(v) for k, v in opts.items()}, f, indent=2)
