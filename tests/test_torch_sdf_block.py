"""The SDF block's explicit Function (``vdnerf_tpu_torch/ops/sdf_block.py``)
against autograd's route, on the CPU, where its stages run their plain
formulas.

- Training: ``SDFNetwork.sdf_value_grad_feat`` (the Function) and
  ``_value_grad_feat_autograd`` (``forward_split`` and
  ``autograd.grad(create_graph=True)``) on the same small network and points
  give the same sdf, gradient and feature, and the same gradients of a loss
  that mixes all three (an eikonal term, a linear term in the feature and
  one in the gradient, as the colour head reads the normals) for every SDF
  parameter and, where they require it, the points. Over the skip or none,
  weight norm on or off, ``inside_outside``, a scale of 1 or 0.7 and
  ``multires`` 0 or 6. Tolerance: 1e-5 of each tensor's largest entry, f32
  rounding of equal formulas taken in another order (measured gaps are under
  1e-6).
- Points that do not require grad get none, and the parameters' gradients
  are the same.
- Serving (under ``torch.no_grad()``): the forward alone, detached, equal to
  autograd's serving route.
- The bf16 policy keeps autograd's route: ``sdf_block.autograd`` counts and
  ``sdf_block.fused`` does not; the f32 policy the other way round.
"""

from __future__ import annotations

import itertools

import pytest
import torch

from vdnerf_tpu_torch.models.fields import SDFConfig, SDFNetwork
from vdnerf_tpu_torch.ops import sdf_block
from vdnerf_tpu_torch.utils import trace

N_PTS, D_HIDDEN, N_LAYERS, D_OUT = 41, 48, 4, 9


def _net(skip=(2,), weight_norm=True, inside_outside=False, scale=1.0, multires=6):
    cfg = SDFConfig(d_hidden=D_HIDDEN, n_layers=N_LAYERS, skip_in=skip, multires=multires,
                    weight_norm=weight_norm, inside_outside=inside_outside, scale=scale,
                    d_out=D_OUT)
    return SDFNetwork(cfg, torch.Generator().manual_seed(1))


def _inputs(requires_grad=True):
    g = torch.Generator().manual_seed(2)
    pts = (torch.rand(N_PTS, 3, generator=g) * 2 - 1) * 0.7
    return (pts.requires_grad_(requires_grad), torch.randn(N_PTS, D_OUT - 1, generator=g),
            torch.randn(N_PTS, 3, generator=g))


def _loss(sdf, grad, feat, w_feat, w_grad):
    return ((sdf ** 2).sum() + ((grad.norm(dim=-1) - 1) ** 2).sum() + (feat * w_feat).sum()
            + (grad * w_grad).sum())


def _run(net, route, pts, w_feat, w_grad):
    """The block's outputs, then the loss's gradients: the points' (or None)
    and every parameter's."""
    net.zero_grad()
    pts.grad = None
    fn = net.sdf_value_grad_feat if route == "fused" else net._value_grad_feat_autograd
    sdf, grad, feat = fn(pts)
    _loss(sdf, grad, feat, w_feat, w_grad).backward()
    pts_grad = None if pts.grad is None else pts.grad.clone()
    return ([t.detach().clone() for t in (sdf, grad, feat)], pts_grad,
            {n: p.grad.clone() for n, p in net.named_parameters()})


def _close(got, want, what):
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), (what, err, float(want.abs().max()))


@pytest.mark.parametrize("skip,weight_norm,inside_outside,scale,multires",
                         list(itertools.product([(2,), ()], [True, False], [False, True],
                                                [1.0, 0.7], [0, 6])))
def test_function_matches_autograd(skip, weight_norm, inside_outside, scale, multires):
    net = _net(skip, weight_norm, inside_outside, scale, multires)
    pts, w_feat, w_grad = _inputs()
    got = _run(net, "fused", pts, w_feat, w_grad)
    want = _run(net, "autograd", pts, w_feat, w_grad)
    for name, a, b in zip(("sdf", "grad", "feat"), got[0], want[0]):
        _close(a, b, name)
    _close(got[1], want[1], "pts")
    assert got[2].keys() == want[2].keys()
    for name in want[2]:
        _close(got[2][name], want[2][name], name)


def test_points_without_grad_get_none():
    net = _net()
    pts, w_feat, w_grad = _inputs(requires_grad=False)
    got = _run(net, "fused", pts, w_feat, w_grad)
    want = _run(net, "autograd", pts, w_feat, w_grad)
    assert got[1] is None and want[1] is None
    for name in want[2]:
        _close(got[2][name], want[2][name], name)


@pytest.mark.parametrize("skip,multires", [((2,), 6), ((), 0)])
def test_serving_is_the_forward_alone(skip, multires):
    net = _net(skip, multires=multires)
    pts = _inputs(requires_grad=False)[0]
    with torch.no_grad():
        got = net.sdf_value_grad_feat(pts)
        want = net._value_grad_feat_autograd(pts)
    for name, a, b in zip(("sdf", "grad", "feat"), got, want):
        assert not a.requires_grad and a.grad_fn is None, name
        _close(a, b, name)


def test_block_refuses_a_skip_at_the_ends():
    net = _net()
    ws = [m.effective_weight() for m in (net.lin0, net.lin1, net.lin2, net.lin3, net.lin4)]
    bs = [m.bias for m in (net.lin0, net.lin1, net.lin2, net.lin3, net.lin4)]
    for skip in ((0,), (4,)):
        with pytest.raises(ValueError, match="skip layers"):
            sdf_block.forward(sdf_block.BlockPlan(6, 1.0, skip), _inputs()[0], ws, bs)


def test_bf16_policy_keeps_the_autograd_route():
    pts, w_feat, w_grad = _inputs()
    for policy, taken, not_taken in ((torch.bfloat16, "sdf_block.autograd", "sdf_block.fused"),
                                     (None, "sdf_block.fused", "sdf_block.autograd")):
        net = SDFNetwork(SDFConfig(d_hidden=D_HIDDEN, n_layers=N_LAYERS, skip_in=(2,),
                                   d_out=D_OUT), torch.Generator().manual_seed(1), policy)
        trace.reset()
        sdf, grad, feat = net.sdf_value_grad_feat(pts)
        _loss(sdf, grad, feat.float(), w_feat, w_grad).backward()
        with torch.no_grad():
            net.sdf_value_grad_feat(pts)
        counts = trace.counts()
        assert counts.get(taken) == 2 and not_taken not in counts, (policy, counts)
        assert feat.dtype == (torch.bfloat16 if policy else torch.float32)
