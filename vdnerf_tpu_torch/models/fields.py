"""Neural fields: SDF MLP, colour head, background NeRF, variance scalar.

Counterpart of ``vdnerf_tpu/models/fields.py`` as ``nn.Module``s whose
parameter names are the reference's ``state_dict`` names (``lin{l}.*``,
``pts_linears.{i}.*``, ``views_linears.0.*``, ``{feature,alpha,rgb,dpt}_linear.*``,
``variance``), so a reference checkpoint loads directly.

The forward paths that the TPU package ran through Pallas go through the
port's kernels: :meth:`SDFNetwork.sdf_value` through K1,
:meth:`RenderingNetwork.forward` through K2 and :meth:`NeRF.forward` through
K4, and their gradients through K3 and K5. Each wrapper runs the kernel for
CUDA tensors and its plain version for CPU tensors.
:meth:`SDFNetwork.sdf_value_grad_feat` is a plain forward with
``torch.autograd.grad`` (the TPU package had no kernel there either), in f32
or under the bf16 policy of ``models/precision.py`` (``matmul_dtype``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from vdnerf_tpu_torch.models.embedder import embed, embed_dim
from vdnerf_tpu_torch.models.layers import (
    PlainLinear,
    WeightNormLinear,
    linear,
    make_linear,
    softplus_beta,
    softplus_beta_jax,
)
from vdnerf_tpu_torch.ops.kernels import fused_mlp, sdf_fwd

_INV_SQRT2 = 1.0 / math.sqrt(2.0)
# the skip scale as JAX takes it under bf16: the constant rounded to bf16
_INV_SQRT2_BF16 = float(torch.tensor(_INV_SQRT2, dtype=torch.bfloat16))


@dataclasses.dataclass(frozen=True)
class SDFConfig:
    d_in: int = 3
    d_out: int = 257
    d_hidden: int = 256
    n_layers: int = 8
    skip_in: tuple[int, ...] = (4,)
    multires: int = 6
    bias: float = 0.5
    scale: float = 1.0
    geometric_init: bool = True
    weight_norm: bool = True
    inside_outside: bool = False

    @property
    def dims(self) -> tuple[int, ...]:
        d0 = embed_dim(self.multires, self.d_in)
        return (d0,) + (self.d_hidden,) * self.n_layers + (self.d_out,)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    d_feature: int = 256
    mode: str = "idr"  # 'idr' | 'no_view_dir' | 'no_normal'
    d_in: int = 9
    d_out: int = 3
    d_hidden: int = 256
    n_layers: int = 4
    weight_norm: bool = True
    multires_view: int = 4
    squeeze_out: bool = True

    @property
    def dims(self) -> tuple[int, ...]:
        d0 = self.d_in + self.d_feature
        if self.multires_view > 0:
            d0 += embed_dim(self.multires_view, 3) - 3
        return (d0,) + (self.d_hidden,) * self.n_layers + (self.d_out,)


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    D: int = 8
    W: int = 256
    d_in: int = 4
    d_in_view: int = 3
    multires: int = 10
    multires_view: int = 4
    output_ch: int = 4
    skips: tuple[int, ...] = (4,)
    rgb_dims: int = 3
    use_viewdirs: bool = True
    gen_depth_feats: bool = False
    dpt_dim: int = 1

    @property
    def input_ch(self) -> int:
        return embed_dim(self.multires, self.d_in) if self.multires > 0 else 3

    @property
    def input_ch_view(self) -> int:
        return embed_dim(self.multires_view, self.d_in_view) if self.multires_view > 0 else 3


def _linears(module: nn.Module, n: int, prefix: str = "lin") -> list[nn.Module]:
    return [getattr(module, f"{prefix}{l}") for l in range(n)]


class SDFNetwork(nn.Module):
    """8x256 softplus(100) MLP with the skip at layer 4, [sdf | feature].

    ``matmul_dtype``: the policy of ``models/precision.py`` for
    :meth:`forward_split` (None: f32; ``torch.bfloat16``: bf16 activations
    and products with f32 accumulation). :meth:`sdf_value` (K1) is f32
    under either."""

    def __init__(self, cfg: SDFConfig, generator: torch.Generator,
                 matmul_dtype: torch.dtype | None = None):
        super().__init__()
        self.cfg = cfg
        self.matmul_dtype = matmul_dtype
        dims = cfg.dims
        self.n_linear = len(dims) - 1
        for l in range(self.n_linear):
            d_in_l = dims[l]
            out_dim = dims[l + 1] - dims[0] if (l + 1) in cfg.skip_in else dims[l + 1]
            layer = make_linear(d_in_l, out_dim, cfg.weight_norm, generator)
            if cfg.geometric_init:
                w, b = self._geometric_init(l, d_in_l, out_dim, dims, generator)
                with torch.no_grad():
                    if isinstance(layer, WeightNormLinear):
                        layer.init_from(w.t(), b)
                    else:
                        layer.weight.copy_(w.t())
                        layer.bias.copy_(b)
            setattr(self, f"lin{l}", layer)

    def _geometric_init(self, l, d_in_l, out_dim, dims, gen):
        """Sphere init of radius ``bias``, as fields.py sdf_init ([in, out])."""
        cfg = self.cfg
        if l == self.n_linear - 1:
            mean = math.sqrt(math.pi) / math.sqrt(dims[l])
            if cfg.inside_outside:
                mean = -mean
            w = mean + 1e-4 * torch.randn(d_in_l, out_dim, generator=gen)
            b = torch.full((out_dim,), cfg.bias if cfg.inside_outside else -cfg.bias)
            return w, b
        std = math.sqrt(2) / math.sqrt(out_dim)
        if cfg.multires > 0 and l == 0:
            w = torch.zeros(d_in_l, out_dim)
            w[:3] = std * torch.randn(3, out_dim, generator=gen)
        else:
            w = std * torch.randn(d_in_l, out_dim, generator=gen)
            if cfg.multires > 0 and l in cfg.skip_in:
                w[-(dims[0] - 3):] = 0.0
        return w, torch.zeros(out_dim)

    def weights(self) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        """Effective [in, out] weights and biases."""
        layers = _linears(self, self.n_linear)
        return [m.effective_weight().t() for m in layers], [m.bias for m in layers]

    def forward_split(self, pts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Plain forward: [N, 3] -> (sdf [N, 1] f32, feature [N, d_out-1]).

        Under bf16 (JAX ``sdf_apply_split`` under the policy) the activations
        are bf16, the skip joins the embedded input cast to bf16 and scales by
        the bf16-rounded 1/sqrt(2), softplus runs on bf16, the sdf channel is
        cast to f32 before the division by ``scale``, and the feature stays
        bf16 (its consumer is K2, which rounds it to bf16 anyway)."""
        cfg = self.cfg
        mm = self.matmul_dtype
        inputs = embed(pts * cfg.scale, cfg.multires)
        x = inputs
        for l, layer in enumerate(_linears(self, self.n_linear)):
            if l in cfg.skip_in:
                if mm is None:
                    x = torch.cat([x, inputs], dim=-1) * _INV_SQRT2
                else:
                    x = torch.cat([x, inputs.to(x.dtype)], dim=-1) * _INV_SQRT2_BF16
            x = linear(layer, x, mm)
            if l < self.n_linear - 1:
                x = softplus_beta(x, 100.0) if mm is None else softplus_beta_jax(x, 100.0)
        if mm is None:
            return x[:, :1] / cfg.scale, x[:, 1:]
        return x[:, :1].float() / cfg.scale, x[:, 1:]

    def forward(self, pts: torch.Tensor) -> torch.Tensor:
        sdf, feat = self.forward_split(pts)
        return torch.cat([sdf, feat], dim=-1)

    def sdf_value(self, pts: torch.Tensor) -> torch.Tensor:
        """[N, 3] -> [N, 1], gradient-free, through K1. The last layer's
        weight-norm scale is per output column, so slicing it to the sdf
        column is exact."""
        with torch.no_grad():
            ws, bs = self.weights()
            ws[-1], bs[-1] = ws[-1][:, :1], bs[-1][:1]
            return sdf_fwd.sdf_value(pts, ws, bs, self.cfg.skip_in,
                                     self.cfg.multires, self.cfg.scale)

    def sdf_value_grad_feat(
        self, pts: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(sdf [N,1], grad [N,3], feature [N,256]): one forward, one
        ``autograd.grad``. sdf and grad are f32 (the gradient comes back at
        ``pts`` through the casts' backward); the feature is bf16 under the
        bf16 policy.

        While grad mode is on and the parameters require grad (training), the
        result is differentiable: the gradient is taken with
        ``create_graph=True`` and nothing is detached, so the eikonal term and
        the colour head's dependence on the normals reach the SDF parameters
        through the second-order path (the JAX VJP under the outer grad).
        Otherwise (serving) it is detached, with grad mode switched on locally
        for the spatial gradient, so it works under an outer
        ``torch.no_grad()`` (not under ``inference_mode``)."""
        if torch.is_grad_enabled() and any(p.requires_grad for p in self.parameters()):
            x = pts if pts.requires_grad else pts.detach().requires_grad_(True)
            sdf, feat = self.forward_split(x)
            # on this thread, so that the gradient's graph is ordered with the
            # forward's in the outer backward (autograd numbers its nodes per
            # thread, and runs the highest first): the SDF block's backward
            # then runs whole before the background NeRF's, as on the CPU
            with torch.autograd.set_multithreading_enabled(False):
                (grad,) = torch.autograd.grad(sdf, x, torch.ones_like(sdf), create_graph=True)
            return sdf, grad, feat
        with torch.enable_grad():
            x = pts.detach().requires_grad_(True)
            sdf, feat = self.forward_split(x)
            (grad,) = torch.autograd.grad(sdf, x, torch.ones_like(sdf))
        return sdf.detach(), grad, feat.detach()


class RenderingNetwork(nn.Module):
    """IDR head over [pts, embedded view dirs, normals, features]: the colour
    head, and the wdepth confs' depth-feature head (96 outputs). ``mm_dtype``:
    K2/K3's operand mode (``models/precision.py`` ``mlp_operand_dtype``)."""

    def __init__(self, cfg: RenderConfig, generator: torch.Generator, mm_dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.mm_dtype = mm_dtype
        dims = cfg.dims
        self.n_linear = len(dims) - 1
        for l in range(self.n_linear):
            setattr(self, f"lin{l}", make_linear(dims[l], dims[l + 1], cfg.weight_norm, generator))

    def weights(self):
        layers = _linears(self, self.n_linear)
        return [m.effective_weight().t() for m in layers], [m.bias for m in layers]

    def forward(self, points, normals, view_dirs, feature_vectors) -> torch.Tensor:
        """-> [N, d_out] f32, through K2 (its plain version on the CPU)."""
        ws, bs = self.weights()
        plan = (self.cfg.mode, self.cfg.multires_view, self.cfg.squeeze_out)
        return fused_mlp.render_net(plan, points, normals, view_dirs, feature_vectors, ws, bs,
                                    self.mm_dtype)


class NeRF(nn.Module):
    """Background NeRF over inverted-sphere coordinates; ``mm_dtype`` as
    :class:`RenderingNetwork`'s (K4/K5)."""

    def __init__(self, cfg: NeRFConfig, generator: torch.Generator, mm_dtype: torch.dtype):
        super().__init__()
        if not cfg.use_viewdirs:
            raise NotImplementedError("the reference NeRF asserts use_viewdirs=True")
        self.cfg = cfg
        self.mm_dtype = mm_dtype
        W = cfg.W
        pts = [make_linear(cfg.input_ch, W, False, generator)]
        for i in range(cfg.D - 1):
            d_in = W + cfg.input_ch if i in cfg.skips else W
            pts.append(make_linear(d_in, W, False, generator))
        self.pts_linears = nn.ModuleList(pts)
        self.views_linears = nn.ModuleList(
            [make_linear(cfg.input_ch_view + W, W // 2, False, generator)]
        )
        self.feature_linear = make_linear(W, W, False, generator)
        self.alpha_linear = make_linear(W, 1, False, generator)
        self.rgb_linear = make_linear(W // 2, cfg.rgb_dims, False, generator)
        if cfg.gen_depth_feats:
            self.dpt_linear = make_linear(W // 2, cfg.dpt_dim, False, generator)

    def forward(self, input_pts, input_views):
        """-> (density [N,1], rgb [N,rgb_dims], depth_feat | None), through K4."""
        cfg = self.cfg
        heads: list[PlainLinear] = [self.alpha_linear, self.feature_linear,
                                    self.views_linears[0], self.rgb_linear]
        if cfg.gen_depth_feats:
            heads.append(self.dpt_linear)
        plan = (cfg.multires, cfg.multires_view, cfg.skips, cfg.D, cfg.gen_depth_feats)
        return fused_mlp.nerf(
            plan, input_pts, input_views,
            [m.weight.t() for m in self.pts_linears], [m.bias for m in self.pts_linears],
            [m.weight.t() for m in heads], [m.bias for m in heads], self.mm_dtype,
        )


class SingleVarianceNetwork(nn.Module):
    def __init__(self, init_val: float = 0.3):
        super().__init__()
        self.variance = nn.Parameter(torch.tensor(float(init_val)))

    def forward(self) -> torch.Tensor:
        """inv_s = exp(10 * variance)."""
        return torch.exp(self.variance * 10.0)
