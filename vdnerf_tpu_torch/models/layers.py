"""Dense layers: weight-normalised and plain Linear, and softplus(beta).

Counterpart of ``vdnerf_tpu/models/layers.py``. Parameters are stored in
PyTorch's ``[out, in]`` layout under the reference's names (``weight_v``,
``weight_g``, ``bias`` for weight norm; ``weight``, ``bias`` otherwise), so a
reference ``state_dict`` loads directly. Effective W = g * v / ||v|| with the
norm over the input dimension and no epsilon.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class WeightNormLinear(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight_v = nn.Parameter(torch.empty(d_out, d_in))
        self.weight_g = nn.Parameter(torch.empty(d_out, 1))
        self.bias = nn.Parameter(torch.empty(d_out))

    @torch.no_grad()
    def init_from(self, w: torch.Tensor, b: torch.Tensor) -> None:
        """Set the effective weight [out, in] (g = ||w|| per output unit)."""
        self.weight_v.copy_(w)
        self.weight_g.copy_(w.norm(dim=1, keepdim=True))
        self.bias.copy_(b)

    def effective_weight(self) -> torch.Tensor:
        """[out, in] effective weight, differentiable in (v, g)."""
        return self.weight_v * (self.weight_g / self.weight_v.norm(dim=1, keepdim=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.effective_weight(), self.bias)


class PlainLinear(nn.Linear):
    def effective_weight(self) -> torch.Tensor:
        return self.weight


def linear(layer: nn.Module, x: torch.Tensor, mm_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``layer(x)``; under a matmul dtype (``models/precision.py``) as the JAX
    ``linear``: the input and the f32 effective weight cast to ``mm_dtype``,
    their product accumulated in f32, the f32 bias added, and the sum cast to
    ``mm_dtype``.

    torch has no differentiable bf16 x bf16 -> f32 product (``mm``'s
    ``out_dtype`` overload runs on CUDA only and has no derivative), and
    ``F.linear`` on bf16 tensors rounds the product to bf16 before it adds a
    bf16-rounded bias. So
    the product is an f32 matmul of the rounded operands: a product of two
    bf16 values is exact in f32, and the sums are f32. Its gradients follow
    JAX's transpose rule: the input's and the weight's come back rounded to
    ``mm_dtype`` (by the backward of the casts), the bias's in f32."""
    if mm_dtype is None:
        return layer(x)
    w = layer.effective_weight().to(mm_dtype).float()
    return F.linear(x.to(mm_dtype).float(), w, layer.bias).to(mm_dtype)


def make_linear(d_in: int, d_out: int, weight_norm: bool, generator: torch.Generator):
    """A linear layer with torch's default init drawn from ``generator``:
    U(-1/sqrt(d_in), 1/sqrt(d_in)) for weight and bias."""
    bound = 1.0 / d_in**0.5
    w = (torch.rand(d_out, d_in, generator=generator) * 2 - 1) * bound
    b = (torch.rand(d_out, generator=generator) * 2 - 1) * bound
    if weight_norm:
        layer = WeightNormLinear(d_in, d_out)
        layer.init_from(w, b)
        return layer
    layer = PlainLinear(d_in, d_out)
    with torch.no_grad():
        layer.weight.copy_(w)
        layer.bias.copy_(b)
    return layer


def softplus_beta(x: torch.Tensor, beta: float = 100.0) -> torch.Tensor:
    """(1/beta) * softplus(beta * x) with no identity cut-off.

    ``F.softplus(x, beta)`` returns x itself once beta*x > 20; the JAX side
    has no such cut-off, so this uses the stable form
    max(bx, 0) + log1p(exp(-|bx|)) everywhere.
    """
    bx = beta * x
    return (torch.clamp(bx, min=0) + torch.log1p(torch.exp(-bx.abs()))) / beta


class _Softplus(torch.autograd.Function):
    """softplus(y) = max(y, 0) + log1p(exp(-|y|)) whose derivative is taken
    as JAX takes ``logaddexp(y, 0)``'s: exp(y - softplus(y)), from the saved
    output, so that the derivative's own derivative goes through this
    Function again (the second-order path of the eikonal term)."""

    @staticmethod
    def forward(ctx, y):
        s = torch.clamp(y, min=0) + torch.log1p(torch.exp(-y.abs()))
        ctx.save_for_backward(y, s)
        return s

    @staticmethod
    def backward(ctx, g):
        y, s = ctx.saved_tensors
        return g * torch.exp(y - s)


def softplus_beta_jax(x: torch.Tensor, beta: float = 100.0) -> torch.Tensor:
    """:func:`softplus_beta` with JAX's derivative (``jax.nn.softplus``'s
    ``exp(y - softplus(y))``): the same value, and in bf16 (the SDF block
    under the bf16 policy) the gradients that JAX's bf16 chain gives, each
    op rounding where JAX's does. Autograd of the stable form takes another
    route (1[y > 0] - sigmoid(-|y|) sign(y)), which rounds elsewhere in bf16."""
    return _Softplus.apply(beta * x) / beta
