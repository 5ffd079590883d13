"""Ray-sampling primitives: inverse-CDF sampling and SDF-guided up-sampling.

Counterpart of ``vdnerf_tpu/ops/sampling.py``:

- :func:`transmittance`: exp of the exclusive cumulative sum of
  log(1 - alpha + 1e-7), clamped at 1e-30 (not a cumulative product).
- :func:`sample_pdf`: inverse CDF in the masked max/min form, which treats
  ties in the CDF as the JAX package does.
- :func:`section_weights`, :func:`up_sample`: the NeuS section-alpha
  estimate and one round of the up-sample ladder.
- :func:`merge_z_vals`: a stable sort of the merged sample sets; the sdf
  values travel with the sort indices.
"""

from __future__ import annotations

import torch


def transmittance(alpha: torch.Tensor) -> torch.Tensor:
    """prod_{j<i} (1 - alpha_j + 1e-7) along the last axis."""
    log_t = torch.log(torch.clamp(1.0 - alpha + 1e-7, min=1e-30))
    exclusive = torch.cat(
        [torch.zeros_like(log_t[..., :1]), torch.cumsum(log_t[..., :-1], dim=-1)], dim=-1
    )
    return torch.exp(exclusive)


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    det: bool = False,
    stratified: bool = False,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Inverse-CDF sample ``n_samples`` positions per ray.

    bins: [N, S] sorted; weights: [N, S-1]. ``det`` uses the midpoint grid;
    ``stratified`` one uniform phase per ray, u_i = (i + xi) / n; otherwise
    u is iid uniform. The random modes draw from ``generator``.
    """
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [N, S]

    batch = cdf.shape[0]
    dev = cdf.device
    if det:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples, device=dev)
        u = u.expand(batch, n_samples)
    elif stratified:
        if generator is None:
            raise ValueError("stratified sample_pdf needs a generator")
        xi = torch.rand(batch, 1, generator=generator, device=generator.device).to(dev)
        u = (torch.arange(n_samples, device=dev, dtype=cdf.dtype)[None, :] + xi) / n_samples
    else:
        if generator is None:
            raise ValueError("stochastic sample_pdf needs a generator")
        u = torch.rand(batch, n_samples, generator=generator, device=generator.device).to(dev)

    # below = max over s with cdf[s] <= u; above = min over s with cdf[s] > u
    mask = cdf[:, None, :] <= u[:, :, None]  # [N, n_new, S]
    big = torch.finfo(torch.float32).max
    cdf_b = cdf[:, None, :].expand_as(mask)
    bins_b = bins[:, None, :].expand_as(mask)
    cdf_below = torch.where(mask, cdf_b, -big).amax(dim=-1)
    cdf_above = torch.where(mask, big, cdf_b).amin(dim=-1)
    bins_below = torch.where(mask, bins_b, -big).amax(dim=-1)
    bins_above = torch.where(mask, big, bins_b).amin(dim=-1)
    # clamp the above-end when u exceeds the whole cdf
    cdf_above = torch.minimum(cdf_above, cdf[:, -1:])
    bins_above = torch.minimum(bins_above, bins[:, -1:])

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def section_weights(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    z_vals: torch.Tensor,
    sdf: torch.Tensor,
    inv_s: float | torch.Tensor,
) -> torch.Tensor:
    """Per-section importance weights [N, S-1] from SDF samples at fixed
    sharpness (the estimator inside the reference's ``up_sample``)."""
    batch_size = z_vals.shape[0]
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., :, None]
    radius = torch.linalg.norm(pts, dim=-1)
    inside_sphere = (radius[:, :-1] < 1.0) | (radius[:, 1:] < 1.0)

    prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
    prev_z, next_z = z_vals[:, :-1], z_vals[:, 1:]
    mid_sdf = (prev_sdf + next_sdf) * 0.5
    cos_val = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-5)

    # min(cos, prev_cos): robust against SDF zero-crossing double-dips
    prev_cos = torch.cat(
        [torch.zeros(batch_size, 1, dtype=cos_val.dtype, device=cos_val.device),
         cos_val[:, :-1]], dim=-1,
    )
    cos_val = torch.minimum(prev_cos, cos_val)
    cos_val = torch.clamp(cos_val, -1e3, 0.0) * inside_sphere

    dist = next_z - prev_z
    prev_esti = mid_sdf - cos_val * dist * 0.5
    next_esti = mid_sdf + cos_val * dist * 0.5
    prev_cdf = torch.sigmoid(prev_esti * inv_s)
    next_cdf = torch.sigmoid(next_esti * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    return alpha * transmittance(alpha)


def up_sample(rays_o, rays_d, z_vals, sdf, n_importance: int, inv_s: float) -> torch.Tensor:
    """One round of SDF-guided importance sampling (det inverse CDF)."""
    weights = section_weights(rays_o, rays_d, z_vals, sdf, inv_s)
    return sample_pdf(z_vals, weights, n_importance, det=True)


def merge_z_vals(
    z_vals: torch.Tensor,
    new_z_vals: torch.Tensor,
    sdf: torch.Tensor | None,
    new_sdf: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Merge two per-ray sample sets by a stable sort, carrying SDF values."""
    z_all = torch.cat([z_vals, new_z_vals], dim=-1)
    z_sorted, idx = torch.sort(z_all, dim=-1, stable=True)
    if sdf is None:
        return z_sorted, None
    sdf_all = torch.cat([sdf, new_sdf], dim=-1)
    return z_sorted, torch.gather(sdf_all, -1, idx)
