"""The cell's weights, made from the seed on the device in two draws.

The networks of the conf's ``model`` tree under the reference checkpoint's
names, in the program's ``[out, in]`` layout: the SDF with its geometric
(sphere) init, weight-normed; the colour and depth heads weight-normed with
the default uniform init; the background NeRF plain, uniform; the variance
at its ``init_val``. One normal and one uniform draw from a
``torch.Generator`` on the device feed every leaf. The benchmark hands the
same tensors to the program (``load_state_dict``) and to the reference.
"""

from __future__ import annotations

import math

import torch


def _embed_dim(multires: int, d: int) -> int:
    return d * (1 + 2 * multires) if multires > 0 else d


def sdf_layers(sdf: dict) -> list[tuple[int, int]]:
    """(in, out) of each SDF layer; the layer before a skip gives up the
    embedded input's width."""
    d0 = _embed_dim(sdf["multires"], sdf["d_in"])
    dims = [d0] + [sdf["d_hidden"]] * sdf["n_layers"] + [sdf["d_out"]]
    return [(dims[l], dims[l + 1] - d0 if (l + 1) in sdf["skip_in"] else dims[l + 1])
            for l in range(len(dims) - 1)]


def idr_layers(head: dict) -> list[tuple[int, int]]:
    d0 = head["d_in"] + head["d_feature"] + _embed_dim(head["multires_view"], 3) - 3
    dims = [d0] + [head["d_hidden"]] * head["n_layers"] + [head["d_out"]]
    return list(zip(dims[:-1], dims[1:]))


def nerf_layers(nerf: dict) -> dict[str, tuple[int, int]]:
    W = nerf["W"]
    ch = _embed_dim(nerf["multires"], nerf["d_in"])
    ch_view = _embed_dim(nerf["multires_view"], nerf["d_in_view"])
    out = {"pts_linears.0": (ch, W)}
    for i in range(nerf["D"] - 1):
        out[f"pts_linears.{i + 1}"] = (W + ch if i in nerf["skips"] else W, W)
    out.update({"views_linears.0": (ch_view + W, W // 2), "feature_linear": (W, W),
                "alpha_linear": (W, 1), "rgb_linear": (W // 2, nerf["rgb_dims"])})
    if nerf.get("gen_depth_feats", False):
        out["dpt_linear"] = (W // 2, nerf["dpt_dim"])
    return out


def make(model: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """{name: tensor} of every leaf, from ``seed``, on ``device``."""
    sdf = model["sdf_network"]
    heads = {"color_network_fine": model["rendering_network"]}
    if "depth_extract_network" in model:
        heads["depth_network_fine"] = model["depth_extract_network"]
    sdf_l = sdf_layers(sdf)
    head_l = {k: idr_layers(v) for k, v in heads.items()}
    nerf_l = nerf_layers(model["nerf"])
    n_normal = sum(i * o for i, o in sdf_l)
    n_uniform = (sum(i * o + o for ls in head_l.values() for i, o in ls)
                 + sum(i * o + o for i, o in nerf_l.values()))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device) * 2.0 - 1.0
    out: dict[str, torch.Tensor] = {}

    def weight_norm(name, w, b):
        out[name + ".weight_v"] = w
        out[name + ".weight_g"] = w.norm(dim=1, keepdim=True)
        out[name + ".bias"] = b

    pos = 0
    d0 = sdf_l[0][0]
    for l, (i, o) in enumerate(sdf_l):
        z = normal[pos:pos + i * o].reshape(o, i)
        pos += i * o
        if l == len(sdf_l) - 1:
            w = math.sqrt(math.pi) / math.sqrt(i) + 1e-4 * z
            b = torch.full((o,), -sdf["bias"], device=device)
        else:
            w = math.sqrt(2.0) / math.sqrt(o) * z
            if sdf["multires"] > 0 and l == 0:
                w = torch.cat([w[:, :3], torch.zeros_like(w[:, 3:])], dim=1)
            elif sdf["multires"] > 0 and l in sdf["skip_in"]:
                w = torch.cat([w[:, :i - (d0 - 3)], torch.zeros_like(w[:, i - (d0 - 3):])], dim=1)
            b = torch.zeros(o, device=device)
        weight_norm(f"sdf_network_fine.lin{l}", w, b)

    pos = 0

    def uniform_linear(i, o):
        nonlocal pos
        bound = 1.0 / math.sqrt(i)
        w = uniform[pos:pos + i * o].reshape(o, i) * bound
        b = uniform[pos + i * o:pos + i * o + o] * bound
        pos += i * o + o
        return w, b

    for prefix, layers in head_l.items():
        for l, (i, o) in enumerate(layers):
            weight_norm(f"{prefix}.lin{l}", *uniform_linear(i, o))
    for name, (i, o) in nerf_l.items():
        out[f"nerf.{name}.weight"], out[f"nerf.{name}.bias"] = uniform_linear(i, o)
    out["variance_network_fine.variance"] = torch.tensor(
        float(model["variance_network"]["init_val"]), device=device)
    return out
