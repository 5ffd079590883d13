"""Plain PyTorch reference of the NeuS step and render that the cells drive.

Written out from the model's description (NeuS, and the VDN-NeRF additions:
the 96-channel depth head, the NeRF's ``dpt`` head, the feature-L1
distillation), with the repository's operating point: the resampled core
(``n_render_samples`` of the ladder's positions, stratified, uniform over its
sections at ``resample_uniform_frac`` 1), ``skip_bg_inside`` (the background
NeRF only at the outside block and its boundary sample), the background
colour taken raw (no sigmoid), as the model definition of this repository
has it. Imports no kernel, no cache and nothing of the program: every
product is an f32 ``matmul`` (TF32 off), or, for the control, the same
product with its operands rounded to TF32 (:func:`tf32_mm`).

Parameters are a dict under the reference checkpoint's names
(``sdf_network_fine.lin0.weight_v``, ``nerf.pts_linears.0.weight``, ...),
weights in ``[out, in]``; the SDF and the two IDR heads are weight-normed
(W = g v / ||v||, the norm over the input dimension).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# -- products -----------------------------------------------------------------


def f32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), nearest even, as f32."""
    u = x.contiguous().view(torch.int32)
    r = (u + 0x0FFF + ((u >> 13) & 1)) & ~0x1FFF
    return r.view(torch.float32)


class _TF32MM(torch.autograd.Function):
    """a @ b with both operands rounded to TF32 and f32 accumulation, in the
    forward and in every product of the backward (differentiable again, so
    the eikonal term's second order runs in TF32 too)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return _TF32MM.apply(g, b.t()), _TF32MM.apply(a.t(), g)


def tf32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _TF32MM.apply(a, b)


MM = {"f32": f32_mm, "tf32": tf32_mm}


def plain_numerics() -> None:
    """f32 products in f32 on the card: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- networks -----------------------------------------------------------------


def embed(x: torch.Tensor, multires: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(L-1) x), cos(2^(L-1) x)]."""
    if multires <= 0:
        return x
    parts = [x]
    for i in range(multires):
        f = float(2.0**i)
        parts += [torch.sin(x * f), torch.cos(x * f)]
    return torch.cat(parts, dim=-1)


def softplus100(x: torch.Tensor) -> torch.Tensor:
    """softplus(100 x) / 100 in its stable form, with no linear cut-off."""
    bx = 100.0 * x
    return (torch.clamp(bx, min=0) + torch.log1p(torch.exp(-bx.abs()))) / 100.0


def _wn(p: dict, name: str) -> torch.Tensor:
    v, g = p[name + ".weight_v"], p[name + ".weight_g"]
    return v * (g / v.norm(dim=1, keepdim=True))


def _lin(x, w, b, mm):
    return mm(x, w.t()) + b


def sdf_forward(cfg: dict, p: dict, pts: torch.Tensor, mm) -> torch.Tensor:
    """[N, 3] -> [N, d_out]: the SDF in column 0, the feature after it."""
    inputs = embed(pts * cfg["scale"], cfg["multires"])
    x = inputs
    n = cfg["n_layers"] + 1
    for l in range(n):
        name = f"sdf_network_fine.lin{l}"
        if l in cfg["skip_in"]:
            x = torch.cat([x, inputs], dim=-1) * (1.0 / math.sqrt(2.0))
        x = _lin(x, _wn(p, name), p[name + ".bias"], mm)
        if l < n - 1:
            x = softplus100(x)
    return torch.cat([x[:, :1] / cfg["scale"], x[:, 1:]], dim=-1)


def sdf_value_grad_feat(cfg, p, pts, mm, create_graph: bool):
    """(sdf [N, 1], its gradient at pts [N, 3], feature [N, d_out - 1])."""
    with torch.enable_grad():
        x = pts.detach().requires_grad_(True)
        out = sdf_forward(cfg, p, x, mm)
        sdf = out[:, :1]
        (grad,) = torch.autograd.grad(sdf, x, torch.ones_like(sdf), create_graph=create_graph)
    if not create_graph:
        return sdf.detach(), grad.detach(), out[:, 1:].detach()
    return sdf, grad, out[:, 1:]


def idr_head(cfg: dict, p: dict, prefix: str, pts, normals, dirs, feat, mm) -> torch.Tensor:
    """The IDR head (mode idr): [pts, embedded view dirs, normals, feature]
    through relu layers, a sigmoid out."""
    x = torch.cat([pts, embed(dirs, cfg["multires_view"]), normals, feat], dim=-1)
    n = cfg["n_layers"] + 1
    for l in range(n):
        name = f"{prefix}.lin{l}"
        x = _lin(x, _wn(p, name), p[name + ".bias"], mm)
        if l < n - 1:
            x = torch.relu(x)
    return torch.sigmoid(x) if cfg["squeeze_out"] else torch.relu(x)


def nerf_forward(cfg: dict, p: dict, pts4, views, mm):
    """The background NeRF -> (density [N, 1], rgb [N, 3], dpt | None)."""
    emb = embed(pts4, cfg["multires"])
    emb_view = embed(views, cfg["multires_view"])
    h = emb
    for i in range(cfg["D"]):
        name = f"nerf.pts_linears.{i}"
        h = torch.relu(_lin(h, p[name + ".weight"], p[name + ".bias"], mm))
        if i in cfg["skips"]:
            h = torch.cat([emb, h], dim=-1)
    alpha = _lin(h, p["nerf.alpha_linear.weight"], p["nerf.alpha_linear.bias"], mm)
    feature = _lin(h, p["nerf.feature_linear.weight"], p["nerf.feature_linear.bias"], mm)
    h2 = torch.relu(_lin(torch.cat([feature, emb_view], dim=-1),
                         p["nerf.views_linears.0.weight"], p["nerf.views_linears.0.bias"], mm))
    rgb = _lin(h2, p["nerf.rgb_linear.weight"], p["nerf.rgb_linear.bias"], mm)
    dpt = None
    if cfg.get("gen_depth_feats", False):
        dpt = _lin(h2, p["nerf.dpt_linear.weight"], p["nerf.dpt_linear.bias"], mm)
    return alpha, rgb, dpt


# -- sampling -----------------------------------------------------------------


def transmittance(alpha: torch.Tensor) -> torch.Tensor:
    """prod_{j<i} (1 - alpha_j + 1e-7), as exp of an exclusive log-sum."""
    log_t = torch.log(torch.clamp(1.0 - alpha + 1e-7, min=1e-30))
    ex = torch.cat([torch.zeros_like(log_t[..., :1]), torch.cumsum(log_t[..., :-1], dim=-1)],
                   dim=-1)
    return torch.exp(ex)


def sample_pdf(bins, weights, n, det=False, xi=None):
    """Inverse-CDF positions: the midpoint grid (``det``) or one uniform
    phase per ray ``xi`` [N, 1] (stratified)."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]), torch.cumsum(pdf, -1)], -1)
    if det:
        u = torch.linspace(0.5 / n, 1.0 - 0.5 / n, n, device=cdf.device).expand(cdf.shape[0], n)
    else:
        u = (torch.arange(n, device=cdf.device, dtype=cdf.dtype)[None, :] + xi) / n
    below_mask = cdf[:, None, :] <= u[:, :, None]
    big = torch.finfo(torch.float32).max
    c = cdf[:, None, :].expand_as(below_mask)
    b = bins[:, None, :].expand_as(below_mask)
    cdf_lo = torch.where(below_mask, c, -big).amax(-1)
    cdf_hi = torch.minimum(torch.where(below_mask, big, c).amin(-1), cdf[:, -1:])
    bin_lo = torch.where(below_mask, b, -big).amax(-1)
    bin_hi = torch.minimum(torch.where(below_mask, big, b).amin(-1), bins[:, -1:])
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return bin_lo + (u - cdf_lo) / denom * (bin_hi - bin_lo)


def section_weights(rays_o, rays_d, z, sdf, inv_s):
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., :, None]
    radius = pts.norm(dim=-1)
    inside = (radius[:, :-1] < 1.0) | (radius[:, 1:] < 1.0)
    mid = (sdf[:, :-1] + sdf[:, 1:]) * 0.5
    cos = (sdf[:, 1:] - sdf[:, :-1]) / (z[:, 1:] - z[:, :-1] + 1e-5)
    prev = torch.cat([torch.zeros_like(cos[:, :1]), cos[:, :-1]], -1)
    cos = torch.clamp(torch.minimum(prev, cos), -1e3, 0.0) * inside
    dist = z[:, 1:] - z[:, :-1]
    prev_cdf = torch.sigmoid((mid - cos * dist * 0.5) * inv_s)
    next_cdf = torch.sigmoid((mid + cos * dist * 0.5) * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    return alpha * transmittance(alpha)


def merge(z, z_new, sdf=None, sdf_new=None):
    zs, idx = torch.sort(torch.cat([z, z_new], -1), dim=-1, stable=True)
    if sdf is None:
        return zs, None
    return zs, torch.gather(torch.cat([sdf, sdf_new], -1), -1, idx)


# -- render -------------------------------------------------------------------


def _sdf_value(cfg, p, pts, mm):
    with torch.no_grad():
        return sdf_forward(cfg["sdf_network"], p, pts, mm)[:, :1]


def render(cfg: dict, p: dict, rays_o, rays_d, draws: dict | None, mm, train: bool,
           anneal: float = 1.0) -> dict:
    """The NeuS render of a ray batch. ``cfg``: the conf's ``model`` tree;
    ``draws``: the step's random numbers {"jitter" [N, 1], "outside" [N,
    n_outside], "phase" [N, 1]}, None for the deterministic render;
    ``train``: the render core carries gradients (the eikonal term's second
    order included), else it is detached. -> colour, the eikonal sums, the
    depth features' composite when the conf has a depth head."""
    r = cfg["neus_renderer"]
    n_s, n_imp, n_out = r["n_samples"], r["n_importance"], r["n_outside"]
    dev = rays_o.device
    B = rays_o.shape[0]
    a = (rays_d**2).sum(-1, keepdim=True)
    b = 2.0 * (rays_o * rays_d).sum(-1, keepdim=True)
    mid = 0.5 * (-b) / a
    near, far = mid - 1.0, mid + 1.0
    sample_dist = 2.0 / n_s
    z = near + (far - near) * torch.linspace(0.0, 1.0, n_s, device=dev)[None, :]
    z_out = torch.linspace(1e-3, 1.0 - 1.0 / (n_out + 1.0), n_out, device=dev)
    if draws is not None:
        z = z + (draws["jitter"] - 0.5) * 2.0 / n_s
        mids = 0.5 * (z_out[1:] + z_out[:-1])
        upper = torch.cat([mids, z_out[-1:]])
        lower = torch.cat([z_out[:1], mids])
        z_out = lower[None, :] + (upper - lower)[None, :] * draws["outside"]
    z_out = far / torch.flip(z_out, dims=[-1]) + 1.0 / n_s

    # the up-sample ladder, gradient-free
    with torch.no_grad():
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., :, None]
        sdf = _sdf_value(cfg, p, pts.reshape(-1, 3), mm).reshape(B, n_s)
        per = n_imp // r["up_sample_steps"]
        for i in range(r["up_sample_steps"]):
            w = section_weights(rays_o, rays_d, z, sdf, 64 * 2**i)
            z_new = sample_pdf(z, w, per, det=True)
            if i + 1 < r["up_sample_steps"]:
                new_pts = rays_o[:, None, :] + rays_d[:, None, :] * z_new[..., :, None]
                sdf_new = _sdf_value(cfg, p, new_pts.reshape(-1, 3), mm).reshape(B, per)
                z, sdf = merge(z, z_new, sdf, sdf_new)
            else:
                z, _ = merge(z, z_new)
        n_all = n_s + n_imp
        n_core = r.get("n_render_samples", 0)
        resample = 0 < n_core < n_all
        if resample:
            if r.get("resample_uniform_frac", 0.25) < 1.0:
                raise NotImplementedError("the reference has the uniform resample only")
            w_mix = torch.full((B, n_all - 1), 1.0 / (n_all - 1), device=dev)
            if draws is not None:
                zc = sample_pdf(z, w_mix, n_core, xi=draws["phase"])
            else:
                zc = sample_pdf(z, w_mix, n_core, det=True)
            z = torch.cat([z[:, :1], zc[:, 1:-1], z[:, -1:]], -1)
    n = z.shape[1]

    # the background NeRF over the outside block and its boundary sample
    zf, _ = merge(z, z_out)
    d = torch.cat([zf[:, 1:] - zf[:, :-1], torch.full_like(zf[:, :1], sample_dist)], -1)
    mz = zf + d * 0.5
    tail = n_out + 1 if r.get("skip_bg_inside", False) else zf.shape[1]
    skip = zf.shape[1] - tail
    pts = rays_o[:, None, :] + rays_d[:, None, :] * mz[..., :, None]
    dis = torch.clamp(pts.norm(dim=-1, keepdim=True), 1.0, 1e10)
    pts4 = torch.cat([pts / dis, 1.0 / dis], -1)[:, skip:]
    dirs = rays_d[:, None, :].expand(B, tail, 3)
    dens, bg_rgb, bg_dpt = nerf_forward(cfg["nerf"], p, pts4.reshape(-1, 4), dirs.reshape(-1, 3),
                                        mm)
    bg_alpha = 1.0 - torch.exp(-F.softplus(dens.reshape(B, tail)) * d[:, skip:])

    def fill(t):
        t = t.reshape(B, tail, -1)
        return torch.cat([t.new_zeros(B, skip, t.shape[-1]), t], 1)

    bg_alpha = torch.cat([bg_alpha.new_zeros(B, skip), bg_alpha], 1)
    bg_rgb = fill(bg_rgb)
    bg_dpt = None if bg_dpt is None else fill(bg_dpt)

    # the render core
    d = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], sample_dist)], -1)
    mz = z + d * 0.5
    pts = (rays_o[:, None, :] + rays_d[:, None, :] * mz[..., :, None]).reshape(-1, 3)
    dirs = rays_d[:, None, :].expand(B, n, 3).reshape(-1, 3)
    sdf, grad, feat = sdf_value_grad_feat(cfg["sdf_network"], p, pts, mm, create_graph=train)
    sampled_dpt = None
    if "depth_extract_network" in cfg:
        sampled_dpt = idr_head(cfg["depth_extract_network"], p, "depth_network_fine", pts, grad,
                               dirs, feat, mm).reshape(B, n, -1)
    col = idr_head(cfg["rendering_network"], p, "color_network_fine", pts, grad, dirs, feat,
                   mm).reshape(B, n, 3)
    inv_s = torch.clamp(torch.exp(p["variance_network_fine.variance"] * 10.0), 1e-6, 1e6)
    true_cos = (dirs * grad).sum(-1, keepdim=True)
    iter_cos = -(F.relu(-true_cos * 0.5 + 0.5) * (1.0 - anneal) + F.relu(-true_cos) * anneal)
    est = torch.clamp(d, max=sample_dist) if resample else d
    est = est.reshape(-1, 1)
    prev_cdf = torch.sigmoid((sdf - iter_cos * est * 0.5) * inv_s)
    next_cdf = torch.sigmoid((sdf + iter_cos * est * 0.5) * inv_s)
    alpha = torch.clamp(((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)).reshape(B, n), 0.0, 1.0)
    radius = pts.norm(dim=-1).reshape(B, n)
    inside = (radius < 1.0).to(alpha.dtype)
    relax = (radius < 1.2).to(alpha.dtype)
    alpha = torch.cat([alpha * inside + bg_alpha[:, :n] * (1.0 - inside), bg_alpha[:, n:]], -1)
    col = torch.cat([col * inside[..., None] + bg_rgb[:, :n] * (1.0 - inside)[..., None],
                     bg_rgb[:, n:]], 1)
    weights = alpha * transmittance(alpha)
    wsum = weights.sum(-1, keepdim=True)
    color = (col * weights[..., None]).sum(1) + 1.0 * (1.0 - wsum)  # white background
    out = {"color": color, "weight_sum": wsum, "cdf0": prev_cdf.reshape(B, n)[:, :1],
           "weight_max": weights.amax(-1, keepdim=True),
           "eik_num": (relax * (grad.reshape(B, n, 3).norm(dim=-1) - 1.0) ** 2).sum(-1),
           "eik_den": relax.sum(-1)}
    if sampled_dpt is not None:
        sampled_dpt = torch.cat([sampled_dpt * inside[..., None]
                                 + bg_dpt[:, :n] * (1.0 - inside)[..., None], bg_dpt[:, n:]], 1)
        out["feats"] = (sampled_dpt * weights[..., None]).sum(1)
    return out


# -- the training step --------------------------------------------------------


def rays_of_pixels(c2w: torch.Tensor, K_inv: torch.Tensor, px, py):
    """Unit ray directions through pixel coordinates (no half-pixel offset)."""
    q = torch.stack([px.float(), py.float(), torch.ones_like(px, dtype=torch.float32)], -1)
    q = q @ K_inv[:3, :3].t()
    q = q / q.norm(dim=-1, keepdim=True)
    d = q @ c2w[:3, :3].t()
    return c2w[:3, 3].expand(d.shape), d


def loss(tc: dict, cfg: dict, p: dict, batch: dict, c2w, K_inv, draws, mm, step: int):
    """The step's loss: L1 colour + 0.1-weighted eikonal + the mask BCE at
    its weight (+ the distillation L1 at its ramped weight), every mean a
    sum over the batch over its count; no mask (``use_mask`` false). ->
    (loss, the step's metrics as the program names them)."""
    rays_o, rays_d = rays_of_pixels(c2w, K_inv, batch["px"], batch["py"])
    out = render(cfg, p, rays_o, rays_d, draws, mm, train=True, anneal=anneal_at(tc, step))
    if tc.get("use_mask", False):
        raise NotImplementedError("the reference trains the mask-free recipes")
    n = rays_o.shape[0]
    msum = float(n) + 1e-5
    color = (out["color"] - batch["color"]).abs().sum() / msum
    sq = ((out["color"] - batch["color"]) ** 2).sum()
    eik = out["eik_num"].sum() / (out["eik_den"].sum() + 1e-5)
    w = torch.clamp(out["weight_sum"], 1e-3, 1.0 - 1e-3)
    bce = -(torch.log(w)).sum() / float(w.numel())  # mask = 1 everywhere
    total = color + eik * tc["igr_weight"] + bce * tc["mask_weight"]
    metrics = {"color_loss": color, "eikonal_loss": eik, "mask_loss": bce,
               "psnr": 20.0 * torch.log10(1.0 / torch.sqrt(sq / (msum * 3.0))),
               "cdf": out["cdf0"].sum() / msum, "weight_max": out["weight_max"].sum() / msum}
    if "feats" in out:
        depth = (out["feats"] - batch["feats"]).abs().sum() / msum
        dsq = ((out["feats"] - batch["feats"]) ** 2).sum()
        metrics.update(depth_loss=depth,
                       psnr_dfeat=20.0 * torch.log10(1.0 / torch.sqrt(dsq / (msum * 3.0))))
        weight = distill_weight_at(tc, step)
        if weight:
            total = total + weight * depth
    metrics["loss"] = total
    return total, {k: float(v.detach()) for k, v in metrics.items()}


def anneal_at(tc: dict, step: int) -> float:
    """min(1, step / anneal_end); 1 without annealing."""
    end = tc.get("anneal_end", 0)
    return 1.0 if not end else min(1.0, step / end)


def draws(cfg: dict, n_rays: int, generator: torch.Generator) -> dict:
    """One training step's random numbers, in the order the step draws
    them: the rays' jitter, the outside samples' positions in their strata,
    the resampled core's phase."""
    r = cfg["neus_renderer"]
    dev = generator.device

    def rand(*shape):
        return torch.rand(*shape, generator=generator, device=dev)

    out = {"jitter": rand(n_rays, 1)}
    if r["n_outside"] > 0:
        out["outside"] = rand(n_rays, r["n_outside"])
    if 0 < r.get("n_render_samples", 0) < r["n_samples"] + r["n_importance"]:
        out["phase"] = rand(n_rays, 1)
    return out


def lr_at(tc: dict, step: int) -> float:
    """The cosine schedule after a linear warm-up (in f32 on the host)."""
    import numpy as np

    f = np.float32
    warm_end = tc.get("warm_up_end", 0)
    end = tc.get("lr_end_iter", 0) or tc["end_iter"]
    s = f(step)
    if warm_end and s < warm_end:
        factor = s / f(warm_end)
    else:
        prog = np.clip((s - f(warm_end)) / f(max(end - warm_end, 1)), f(0), f(1))
        alpha = tc["learning_rate_alpha"]
        factor = (np.cos(f(math.pi) * prog) + f(1)) * f(0.5) * f(1 - alpha) + f(alpha)
    return float(f(tc["learning_rate"]) * f(factor))


def distill_weight_at(tc: dict, step: int) -> float:
    """The distillation term's weight: a sigmoid ramp over 5,000 steps from
    ``depth_start_iter``, times ``depth_loss_scale``; 0 before the start."""
    import numpy as np

    if not tc.get("extract_depth", False) or step <= tc["depth_start_iter"]:
        return 0.0
    x = np.float32(step - tc["depth_start_iter"] - 1) / np.float32(5000)
    ramp = np.float32(1.0) / (np.exp(np.float32(-10.0) * (x - np.float32(0.5))) + np.float32(1.0))
    return float(ramp) * float(tc.get("depth_loss_scale", 1.0))


class Adam:
    """Adam (0.9, 0.999, 1e-8) with the bias corrections, in f32."""

    def __init__(self, params: dict):
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, params: dict, grads: dict, lr: float) -> None:
        self.t += 1
        c1, c2 = 1.0 - 0.9**self.t, 1.0 - 0.999**self.t
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                self.m[k].mul_(0.9).add_(g, alpha=0.1)
                self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
                p.sub_(lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + 1e-8))


def train_steps(tc: dict, cfg: dict, params: dict, batches: list[dict], cams: dict,
                steps: list[int], generator: torch.Generator, precision: str = "f32") -> dict:
    """Follow the program's first steps from ``params``: each step's loss
    and metrics, the first step's gradient per leaf, and the parameters
    after the last.
    ``cams``: {"c2w" [n, 4, 4], "K_inv" [n, 4, 4]}; ``batches[i]``: {"img",
    "px", "py", "color", "feats"} on the device; ``generator``: seeded as
    the program's training generator."""
    mm = MM[precision]
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    opt = Adam(p)
    losses, rows, first_grad = [], [], None
    for batch, step in zip(batches, steps):
        i = batch["img"]
        dr = draws(cfg, batch["px"].shape[0], generator)
        value, row = loss(tc, cfg, p, batch, cams["c2w"][i], cams["K_inv"][i], dr, mm, step)
        rows.append(row)
        grads = torch.autograd.grad(value, list(p.values()), allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(p.items(), grads)}
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(p, grads, lr_at(tc, step))
        losses.append(float(value.detach()))
    return {"losses": losses, "metrics": rows, "first_grad": first_grad,
            "params": {k: v.detach() for k, v in p.items()}}
