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
