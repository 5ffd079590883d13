"""Operations and bytes of a cell's step or frame, from the configuration's
widths and the traffic's sizes, frozen here so that they do not move with
the program; and the card's peaks.

Operations are the products' multiply-adds, two operations each, every f32
product counted once whatever implements it (3xTF32, split bf16 or f32), so
a kernel's roofline reads the same work under any implementation. Per row:

- K1 (the ladder's SDF value): the SDF network forward with its last layer
  cut to the SDF column;
- the SDF block (value + feature, and the gradient at the point by reverse
  mode): a forward F and one input-gradient pass F; in training its backward
  through both (each product's two transposed products) adds 4 F;
- the colour and depth heads (K2, K3) and the background NeRF (K4, K5): a
  forward, and in training a backward of twice it.

Model operations leave out what the kernels recompute (K3 and K5 run their
forward again) and count the ladder as forward only. Bytes count each input
read once and each output written once: rows in and out and the weights
(and in a backward the cotangents and the weights' gradients).
"""

from __future__ import annotations

from vdnbench.weights import idr_layers, nerf_layers, sdf_layers

# NVIDIA H100 SXM, dense: TF32 tensor-core rate (the highest rate at which
# the card multiplies f32 operands) and HBM3 bandwidth, at 700 W
PEAK_FLOPS = 495e12
PEAK_BYTES = 3.35e12
F32 = 4


def _macs(layers) -> int:
    return sum(i * o for i, o in layers)


def _params(layers) -> int:
    return sum(i * o + o for i, o in layers)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take, and what bounds it."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rows(model: dict, traffic: dict) -> dict:
    """Rows of each component in one unit of work (a step or a frame)."""
    r = model["neus_renderer"]
    if traffic["kind"] == "views":
        level = traffic["resolution_level"]
        rays = (traffic["W"] // level) * (traffic["H"] // level)
    else:
        rays = traffic["batch_size"]
    n_all = r["n_samples"] + r["n_importance"]
    n_core = r.get("n_render_samples", 0)
    if not 0 < n_core < n_all:
        n_core = n_all
    per = r["n_importance"] // r["up_sample_steps"]
    # the last round's SDF values are read only by a weight estimate of a
    # resampled core with a floor below 1
    queried = r["up_sample_steps"] - 1
    if n_core < n_all and r.get("resample_uniform_frac", 0.25) < 1.0:
        queried += 1
    n_bg = 0
    if r["n_outside"] > 0:
        n_bg = r["n_outside"] + 1 if r.get("skip_bg_inside", False) else n_all + r["n_outside"]
    return {"rays": rays, "ladder": rays * (r["n_samples"] + per * queried),
            "ladder_launches": 1 + queried, "core": rays * n_core, "bg": rays * n_bg}


def counts(model: dict, traffic: dict) -> dict:
    """{"rays", "K1": {flops, bytes}, "mlp": {flops, bytes}, "sdf_block":
    {flops}, "model_flops"} for one unit of the traffic."""
    train = traffic["kind"] != "views"
    n = rows(model, traffic)
    sdf = sdf_layers(model["sdf_network"])
    k1 = sdf[:-1] + [(sdf[-1][0], 1)]
    heads = [model["rendering_network"]]
    if "depth_extract_network" in model:
        heads.append(model["depth_extract_network"])
    nerf = list(nerf_layers(model["nerf"]).values())
    nerf_cfg = model["nerf"]

    k1_flops = 2 * n["ladder"] * _macs(k1)
    k1_bytes = F32 * (n["ladder"] * (3 + 1) + n["ladder_launches"] * _params(k1))

    passes = 3 if train else 1
    mlp_flops = mlp_bytes = 0
    for h in heads:
        layers = idr_layers(h)
        mlp_flops += passes * 2 * n["core"] * _macs(layers)
        d_in, d_out = 9 + h["d_feature"], h["d_out"]
        mlp_bytes += F32 * (n["core"] * (d_in + d_out) + _params(layers))
        if train:  # inputs and the output's cotangent in, their cotangents out
            mlp_bytes += F32 * (n["core"] * (2 * d_in + 2 * d_out) + 2 * _params(layers))
    if n["bg"]:
        d_out = 1 + nerf_cfg["rgb_dims"] + (nerf_cfg["dpt_dim"]
                                            if nerf_cfg.get("gen_depth_feats") else 0)
        d_in = nerf_cfg["d_in"] + nerf_cfg["d_in_view"]
        mlp_flops += passes * 2 * n["bg"] * _macs(nerf)
        mlp_bytes += F32 * (n["bg"] * (d_in + d_out) + _params(nerf))
        if train:
            mlp_bytes += F32 * (n["bg"] * (2 * d_in + 2 * d_out) + 2 * _params(nerf))

    sdf_flops = (6 if train else 2) * 2 * n["core"] * _macs(sdf)
    return {"rays": n["rays"], "rows": n,
            "K1": {"flops": k1_flops, "bytes": k1_bytes},
            "mlp": {"flops": mlp_flops, "bytes": mlp_bytes},
            "sdf_block": {"flops": sdf_flops},
            "model_flops": k1_flops + mlp_flops + sdf_flops}
