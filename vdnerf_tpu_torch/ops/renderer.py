"""NeuS volume renderer: hierarchical sampling + logistic-CDF compositing.

Counterpart of ``vdnerf_tpu/ops/renderer.py``: the SDF-guided up-sample
ladder (K1 for its value-only SDF queries), the optional importance-resampled
core, the background NeRF over the outside block (K4, backward K5; with the
dpt head it also gives each sample's depth features), and the render core (SDF
value + gradient + feature through ``ops/sdf_block.py``'s Function under the
f32 policy, by autograd under bf16; colour head through K2, backward K3,
logistic-CDF alpha, transmittance composite). With a depth head (wdepth
confs) the core also runs it through K2/K3 on the same inputs, blends its
features with the background NeRF's outside the unit sphere and composites
them with the colour weights into ``render_feats``; ``depth_before_color``
appends those features to the colour head's feature input.

Serving runs it under ``torch.no_grad()`` (the SDF block's forward gives the
gradient analytically; under bf16 the render core switches grad mode on
locally for it). Training runs it with grad mode on: the
ladder, the resampled ``z_vals`` and the inside-sphere masks carry no
gradient, as the ``stop_gradient``s of the JAX renderer say; everything in the
render core does.

Spans (``utils/trace.py``): ``render.rays`` (z init, outside z, jitter),
``render.ladder``, ``render.nerf`` (the outside block's merge and the
background NeRF), ``render.sdf`` (the SDF value, gradient and feature),
``render.depth_head``, ``render.colour_head`` and ``render.composite``
(alpha, transmittance, blends, sums, the output's tail); backward points
``bwd.nerf``, ``bwd.sdf``, ``bwd.depth_head`` and ``bwd.colour_head`` on
those layers' outputs, so that a backward splits into their pieces.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from vdnerf_tpu_torch.models.fields import (
    NeRF,
    NeRFConfig,
    RenderConfig,
    RenderingNetwork,
    SDFConfig,
    SDFNetwork,
    SingleVarianceNetwork,
)
from vdnerf_tpu_torch.ops.sampling import (
    merge_z_vals,
    sample_pdf,
    section_weights,
    transmittance,
    up_sample,
)
from vdnerf_tpu_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class RendererConfig:
    """Sampling budget (conf ``model.neus_renderer``); see the JAX
    RendererConfig for what ``skip_bg_inside`` and the resampled core
    (``n_render_samples``, ``resample_uniform_frac``) trade."""

    n_samples: int = 64
    n_importance: int = 64
    n_outside: int = 32
    up_sample_steps: int = 4
    perturb: float = 1.0
    skip_bg_inside: bool = False
    n_render_samples: int = 0
    resample_uniform_frac: float = 0.25


@dataclasses.dataclass(frozen=True)
class NeuSNetworks:
    sdf: SDFConfig
    color: RenderConfig
    nerf: NeRFConfig
    renderer: RendererConfig
    depth: RenderConfig | None = None


class NeuSModel(nn.Module):
    """The networks under the reference checkpoint's names, registered (and
    drawn from ``generator``) in the reference's ``params_to_train`` order:
    nerf, sdf, variance, colour, then the depth head when ``nets.depth`` is
    set. ``matmul_dtype``: the SDF network's precision policy; ``mlp_dtype``:
    the operand mode of the colour head, the depth head and the NeRF (K2-K5),
    both from ``models/precision.py``."""

    def __init__(self, nets: NeuSNetworks, variance_init: float, generator: torch.Generator,
                 matmul_dtype: torch.dtype | None = None, *, mlp_dtype: torch.dtype):
        super().__init__()
        self.nerf = NeRF(nets.nerf, generator, mlp_dtype)
        self.sdf_network_fine = SDFNetwork(nets.sdf, generator, matmul_dtype)
        self.variance_network_fine = SingleVarianceNetwork(variance_init)
        self.color_network_fine = RenderingNetwork(nets.color, generator, mlp_dtype)
        if nets.depth is not None:
            self.depth_network_fine = RenderingNetwork(nets.depth, generator, mlp_dtype)


def render_core_outside(
    nets: NeuSNetworks,
    model: NeuSModel,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    z_vals: torch.Tensor,
    sample_dist: float,
    eval_tail: int | None = None,
) -> dict[str, torch.Tensor]:
    """Background NeRF over inverted-sphere coordinates -> each sample's
    colour, alpha, mid z and, with the dpt head, depth features
    (``sampled_feat``, else None). ``eval_tail``: evaluate only the last that
    many samples; the skipped ones get colour and features 0 and alpha
    exactly 0 (the ``skip_bg_inside`` path)."""
    batch_size, n_samples = z_vals.shape
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], sample_dist)], dim=-1)
    mid_z_vals = z_vals + dists * 0.5

    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z_vals[..., :, None]
    dis_to_center = torch.clamp(torch.linalg.norm(pts, dim=-1, keepdim=True), 1.0, 1e10)
    pts4 = torch.cat([pts / dis_to_center, 1.0 / dis_to_center], dim=-1)
    dirs = rays_d[:, None, :].expand(pts.shape)

    d_in = 3 + int(nets.renderer.n_outside > 0)
    n_skip = 0
    if eval_tail is not None and eval_tail < n_samples:
        n_skip = n_samples - eval_tail
    density, color, feat = model.nerf(
        pts4[:, n_skip:].reshape(-1, d_in), dirs[:, n_skip:].reshape(-1, 3)
    )
    n_eval = n_samples - n_skip
    alpha = 1.0 - torch.exp(-F.softplus(density.reshape(batch_size, n_eval)) * dists[:, n_skip:])

    def fill(t):
        t = t.reshape(batch_size, n_eval, -1)
        if not n_skip:
            return t
        return torch.cat([t.new_zeros(batch_size, n_skip, t.shape[-1]), t], dim=1)

    if n_skip:
        alpha = torch.cat([alpha.new_zeros(batch_size, n_skip), alpha], dim=1)
    color = fill(color)
    if feat is None:
        alpha, color = trace.point("bwd.nerf", alpha, color)
    else:
        alpha, color, feat = trace.point("bwd.nerf", alpha, color, fill(feat))
    return {"sampled_color": color, "sampled_feat": feat, "alpha": alpha, "z_vals": mid_z_vals}


def render_core(
    nets: NeuSNetworks,
    model: NeuSModel,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    z_vals: torch.Tensor,
    sample_dist: float,
    background_alpha: torch.Tensor | None = None,
    background_sampled_color: torch.Tensor | None = None,
    background_rgb: torch.Tensor | None = None,
    cos_anneal_ratio: float | torch.Tensor = 0.0,
    est_dist_cap: float | None = None,
    depth_before_color: bool = False,
    background_sampled_feat: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """SDF-based alpha compositing core. ``est_dist_cap`` bounds the
    section-alpha estimator's half-width (resampled core only). With a depth
    head, ``d_feats`` is the composite of its features (blended with
    ``background_sampled_feat`` outside the unit sphere), else None."""
    batch_size, n_samples = z_vals.shape
    with trace.span("render.sdf"):
        dists = z_vals[..., 1:] - z_vals[..., :-1]
        dists = torch.cat([dists, torch.full_like(dists[..., :1], sample_dist)], dim=-1)
        mid_z_vals = z_vals + dists * 0.5

        pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z_vals[..., :, None]
        dirs = rays_d[:, None, :].expand(pts.shape)
        pts_flat = pts.reshape(-1, 3)
        dirs_flat = dirs.reshape(-1, 3)

        sdf, gradients, feature_vector = trace.point(
            "bwd.sdf", *model.sdf_network_fine.sdf_value_grad_feat(pts_flat))
    sampled_feat = None
    if nets.depth is not None:
        with trace.span("render.depth_head"):
            feat_flat = trace.point("bwd.depth_head", model.depth_network_fine(
                pts_flat, gradients, dirs_flat, feature_vector))
        sampled_feat = feat_flat.reshape(batch_size, n_samples, -1)
    with trace.span("render.colour_head"):
        if sampled_feat is not None and depth_before_color:
            feature_vector = torch.cat([feature_vector, feat_flat], dim=-1)
        sampled_color = trace.point("bwd.colour_head", model.color_network_fine(
            pts_flat, gradients, dirs_flat, feature_vector).reshape(batch_size, n_samples, -1))
    with trace.span("render.composite"):
        inv_s = torch.clamp(model.variance_network_fine(), 1e-6, 1e6)

        true_cos = torch.sum(dirs_flat * gradients, dim=-1, keepdim=True)
        iter_cos = -(
            F.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
            + F.relu(-true_cos) * cos_anneal_ratio
        )
        est_dists = dists if est_dist_cap is None else torch.clamp(dists, max=est_dist_cap)
        dists_flat = est_dists.reshape(-1, 1)
        estimated_next_sdf = sdf + iter_cos * dists_flat * 0.5
        estimated_prev_sdf = sdf - iter_cos * dists_flat * 0.5
        prev_cdf = torch.sigmoid(estimated_prev_sdf * inv_s)
        next_cdf = torch.sigmoid(estimated_next_sdf * inv_s)
        p = prev_cdf - next_cdf
        c = prev_cdf
        alpha = torch.clamp(((p + 1e-5) / (c + 1e-5)).reshape(batch_size, n_samples), 0.0, 1.0)

        pts_norm = torch.linalg.norm(pts_flat, dim=-1).reshape(batch_size, n_samples)
        inside_sphere = (pts_norm < 1.0).to(alpha.dtype)
        relax_inside_sphere = (pts_norm < 1.2).to(alpha.dtype)

        if background_alpha is not None:
            alpha = alpha * inside_sphere + background_alpha[:, :n_samples] * (1.0 - inside_sphere)
            alpha = torch.cat([alpha, background_alpha[:, n_samples:]], dim=-1)
            sampled_color = (
                sampled_color * inside_sphere[:, :, None]
                + background_sampled_color[:, :n_samples] * (1.0 - inside_sphere)[:, :, None]
            )
            sampled_color = torch.cat(
                [sampled_color, background_sampled_color[:, n_samples:]], dim=1
            )
            if sampled_feat is not None:
                sampled_feat = (
                    sampled_feat * inside_sphere[:, :, None]
                    + background_sampled_feat[:, :n_samples] * (1.0 - inside_sphere)[:, :, None]
                )
                sampled_feat = torch.cat(
                    [sampled_feat, background_sampled_feat[:, n_samples:]], dim=1
                )

        weights = alpha * transmittance(alpha)
        weights_sum = torch.sum(weights, dim=-1, keepdim=True)
        color = torch.sum(sampled_color * weights[:, :, None], dim=1)
        d_feats = None
        if sampled_feat is not None:
            d_feats = torch.sum(sampled_feat * weights[:, :, None], dim=1)
        if background_rgb is not None:
            color = color + background_rgb * (1.0 - weights_sum)

        gradient_error_pt = (
            torch.linalg.norm(gradients.reshape(batch_size, n_samples, 3), dim=-1) - 1.0
        ) ** 2
        gradient_error_num = torch.sum(relax_inside_sphere * gradient_error_pt, dim=-1)
        gradient_error_den = torch.sum(relax_inside_sphere, dim=-1)
        return {
            "gradient_error_num": gradient_error_num,
            "gradient_error_den": gradient_error_den,
            "color": color,
            "d_feats": d_feats,
            "sdf": sdf,
            "gradients": gradients.reshape(batch_size, n_samples, 3),
            "s_val": 1.0 / inv_s,
            "mid_z_vals": mid_z_vals,
            "weights": weights,
            "cdf": c.reshape(batch_size, n_samples),
            "inside_sphere": inside_sphere,
        }


def _ladder(model, rcfg, rays_o, rays_d, z_vals, resample, perturb, generator):
    """The SDF-guided up-sample ladder (K1 for its SDF queries) and, with
    ``resample``, the importance-resampled core positions -> sorted z."""
    sdf_net = model.sdf_network_fine
    batch_size = rays_o.shape[0]
    dev = rays_o.device
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., :, None]
    sdf = sdf_net.sdf_value(pts.reshape(-1, 3)).reshape(batch_size, rcfg.n_samples)
    per_round = rcfg.n_importance // rcfg.up_sample_steps
    for i in range(rcfg.up_sample_steps):
        new_z_vals = up_sample(rays_o, rays_d, z_vals, sdf, per_round, 64 * 2**i)
        # the last round's SDF values are read only by a weight estimate
        # of the resampled core with frac < 1
        needs_weight_est = resample and rcfg.resample_uniform_frac < 1.0
        last = i + 1 == rcfg.up_sample_steps and not needs_weight_est
        new_sdf = None
        if not last:
            new_pts = rays_o[:, None, :] + rays_d[:, None, :] * new_z_vals[..., :, None]
            new_sdf = sdf_net.sdf_value(new_pts.reshape(-1, 3)).reshape(batch_size, per_round)
        z_vals, sdf = merge_z_vals(z_vals, new_z_vals, None if last else sdf, new_sdf)
    n_samples = rcfg.n_samples + rcfg.n_importance

    if resample:
        if rcfg.n_render_samples < 2:
            raise ValueError("n_render_samples must be >= 2 (endpoint pinning)")
        frac = rcfg.resample_uniform_frac
        if frac >= 1.0:
            w_mix = torch.full(
                (batch_size, n_samples - 1), 1.0 / (n_samples - 1), device=dev
            )
        else:
            inv_s_est = torch.clamp(model.variance_network_fine(), 1e-6, 1e6)
            w = section_weights(rays_o, rays_d, z_vals, sdf, inv_s_est)
            w_norm = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-6)
            w_mix = (1.0 - frac) * w_norm + frac / (n_samples - 1)
        if perturb > 0:
            z_core = sample_pdf(z_vals, w_mix, rcfg.n_render_samples,
                                stratified=True, generator=generator)
        else:
            z_core = sample_pdf(z_vals, w_mix, rcfg.n_render_samples, det=True)
        # pin the endpoints to the ladder's first/last z
        z_vals = torch.cat([z_vals[..., :1], z_core[..., 1:-1], z_vals[..., -1:]], dim=-1)

    return z_vals


def _initial_z(rcfg, near, far, perturb, generator):
    """The ladder's first z (uniform between near and far) and the outside
    block's (uniform in inverse depth past far, None without it), jittered
    with ``perturb``."""
    dev = near.device
    batch_size = near.shape[0]
    z_vals = torch.linspace(0.0, 1.0, rcfg.n_samples, device=dev)
    z_vals = near + (far - near) * z_vals[None, :]

    z_vals_outside = None
    if rcfg.n_outside > 0:
        z_vals_outside = torch.linspace(
            1e-3, 1.0 - 1.0 / (rcfg.n_outside + 1.0), rcfg.n_outside, device=dev
        )

    if perturb > 0:
        if generator is None:
            raise ValueError("perturbed rendering needs a generator")

        def rand(*shape):
            return torch.rand(*shape, generator=generator, device=generator.device).to(dev)

        z_vals = z_vals + (rand(batch_size, 1) - 0.5) * 2.0 / rcfg.n_samples
        if rcfg.n_outside > 0:
            mids = 0.5 * (z_vals_outside[..., 1:] + z_vals_outside[..., :-1])
            upper = torch.cat([mids, z_vals_outside[..., -1:]], dim=-1)
            lower = torch.cat([z_vals_outside[..., :1], mids], dim=-1)
            z_vals_outside = lower[None, :] + (upper - lower)[None, :] * rand(
                batch_size, rcfg.n_outside)

    if rcfg.n_outside > 0:
        z_vals_outside = far / torch.flip(z_vals_outside, dims=[-1]) + 1.0 / rcfg.n_samples
    return z_vals, z_vals_outside


def render(
    nets: NeuSNetworks,
    model: NeuSModel,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    generator: torch.Generator | None = None,
    perturb_overwrite: int = -1,
    background_rgb: torch.Tensor | None = None,
    cos_anneal_ratio: float | torch.Tensor = 0.0,
    depth_before_color: bool = False,
) -> dict[str, torch.Tensor]:
    """Full NeuS render of a ray batch. rays_o/rays_d: [N, 3]; near/far:
    [N, 1]. ``generator`` drives the jitter and the stratified resample when
    perturb > 0. With a depth head the result also holds ``render_feats``
    [N, c], its features' composite."""
    rcfg = nets.renderer
    batch_size = rays_o.shape[0]
    sample_dist = 2.0 / rcfg.n_samples
    perturb = rcfg.perturb if perturb_overwrite < 0 else perturb_overwrite
    with trace.span("render.rays"):
        z_vals, z_vals_outside = _initial_z(rcfg, near, far, perturb, generator)

    resample = (
        0 < rcfg.n_render_samples < rcfg.n_samples + rcfg.n_importance
        and rcfg.n_importance > 0
    )
    if rcfg.n_importance > 0:
        # gradient-free, as the JAX renderer's stop_gradients
        with trace.span("render.ladder"), torch.no_grad():
            z_vals = _ladder(model, rcfg, rays_o, rays_d, z_vals, resample, perturb, generator)

    background_alpha = background_sampled_color = background_sampled_feat = None
    background_zvals = None
    if rcfg.n_outside > 0:
        with trace.span("render.nerf"):
            z_vals_feed, _ = merge_z_vals(z_vals, z_vals_outside, None, None)
            ret_outside = render_core_outside(
                nets, model, rays_o, rays_d, z_vals_feed, sample_dist,
                eval_tail=rcfg.n_outside + 1 if rcfg.skip_bg_inside else None,
            )
        background_sampled_color = ret_outside["sampled_color"]
        background_sampled_feat = ret_outside["sampled_feat"]
        background_alpha = ret_outside["alpha"]
        background_zvals = ret_outside["z_vals"]

    ret_fine = render_core(
        nets, model, rays_o, rays_d, z_vals, sample_dist,
        background_alpha=background_alpha,
        background_sampled_color=background_sampled_color,
        background_rgb=background_rgb,
        cos_anneal_ratio=cos_anneal_ratio,
        est_dist_cap=sample_dist if resample else None,
        depth_before_color=depth_before_color,
        background_sampled_feat=background_sampled_feat,
    )
    weights = ret_fine["weights"]
    with trace.span("render.composite"):
        out = {
            "color_fine": ret_fine["color"],
            "gradient_error_num": ret_fine["gradient_error_num"],
            "gradient_error_den": ret_fine["gradient_error_den"],
            "s_val": ret_fine["s_val"].expand(batch_size, 1),
            "cdf_fine": ret_fine["cdf"],
            "weight_sum": torch.sum(weights, dim=-1, keepdim=True),
            "weight_max": torch.amax(weights, dim=-1, keepdim=True),
            "gradients": ret_fine["gradients"],
            "weights": weights,
            "z_vals": ret_fine["mid_z_vals"] if background_zvals is None else background_zvals,
            "inside_sphere": ret_fine["inside_sphere"],
        }
    if ret_fine["d_feats"] is not None:
        out["render_feats"] = ret_fine["d_feats"]
    return out
