"""The port's full deterministic NeuS render against vdnerf_tpu.ops.renderer.

Same numpy-seeded rays and the same parameters (carried by
``from_jax_params``) through both, ``perturb_overwrite=0``, white
background, in three renderer modes: faithful, ``skip_bg_inside``, and the
resampled core at ``resample_uniform_frac=1.0`` (with ``skip_bg_inside``, as
``confs/womsk_white_tpu.conf`` runs it).

Two numeric policies:

- f32: the JAX default path (no fused kernels, f32 matmuls) against the port
  with its fused-MLP operands in f32. color atol 1e-4: f32 sums in another
  order, amplified by the ladder's data-dependent sample positions.
- bf16: JAX with ``set_fused_mlp(True)`` (the Pallas kernels in interpret mode
  on the CPU) against the port's production bf16 operand rounding. color atol
  5e-3: a bf16 rounding of an activation can land on the other side in the two
  frameworks.

``weight_depth`` (the argmax-weight depth that ``getfeats`` exports) must agree
within 1e-4 on at least 99% of the rays: an argmax between near-equal weights
may flip.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import f32_matmuls, jax_nets, jax_params, port_model, port_nets, rays  # noqa: F401
from vdnerf_tpu.data.dataset import near_far_from_sphere
from vdnerf_tpu.models import precision
from vdnerf_tpu.ops.renderer import render as jax_render
from vdnerf_tpu_torch.data.dataset import near_far_from_sphere as port_near_far
from vdnerf_tpu_torch.ops.renderer import render as port_render

MODES = {
    "faithful": {},
    "skip_bg_inside": dict(skip_bg_inside=True),
    "resample_frac1": dict(skip_bg_inside=True, n_render_samples=24, resample_uniform_frac=1.0),
}
N_RAYS = 64
COLOR_TOL = {"f32": 1e-4, "bf16": 5e-3}


def _weight_depth(out) -> np.ndarray:
    inside = np.asarray(out["inside_sphere"])
    w = np.asarray(out["weights"])[:, : inside.shape[1]] * inside
    return np.take_along_axis(np.asarray(out["z_vals"]), w.argmax(-1)[:, None], axis=-1)


def _jax_render(nets, params, o, d, fused: bool):
    @jax.jit
    def go(params, o, d):
        near, far = near_far_from_sphere(o, d)
        return jax_render(nets, params, o, d, near, far, perturb_overwrite=0,
                          background_rgb=jnp.ones((1, 3)), cos_anneal_ratio=0.5)

    precision.set_fused_mlp(fused)
    try:
        out = go(params, jnp.asarray(o), jnp.asarray(d))
    finally:
        precision.set_fused_mlp(False)
    return {k: np.asarray(v) for k, v in out.items() if v is not None}


def _port_render(nets, params, o, d):
    model = port_model(nets, params)
    ro, rd = torch.from_numpy(o), torch.from_numpy(d)
    near, far = port_near_far(ro, rd)
    with torch.no_grad():
        out = port_render(port_nets(nets), model, ro, rd, near, far, perturb_overwrite=0,
                          background_rgb=torch.ones(1, 3), cos_anneal_ratio=0.5)
    return {k: v.numpy() for k, v in out.items()}


def _compare(mode, policy):
    nets = jax_nets(**MODES[mode])
    params = jax_params(nets, seed=3)
    o, d = rays(N_RAYS, seed=5)
    want = _jax_render(nets, params, o, d, fused=policy == "bf16")
    got = _port_render(nets, params, o, d)

    n_core = MODES[mode].get("n_render_samples", 32)
    assert got["color_fine"].shape == (N_RAYS, 3)
    assert got["inside_sphere"].shape == (N_RAYS, n_core)
    assert np.isfinite(got["color_fine"]).all()
    np.testing.assert_allclose(got["color_fine"], want["color_fine"], atol=COLOR_TOL[policy])
    np.testing.assert_allclose(got["weight_sum"], want["weight_sum"], atol=COLOR_TOL[policy])
    np.testing.assert_allclose(got["inside_sphere"], want["inside_sphere"])
    agree = np.abs(_weight_depth(got) - _weight_depth(want)) <= 1e-4
    assert agree.mean() >= 0.99, f"weight_depth agrees on {agree.mean():.3f} of rays"
    if policy == "f32":
        np.testing.assert_allclose(got["gradient_error_num"], want["gradient_error_num"],
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got["gradient_error_den"], want["gradient_error_den"])


@pytest.mark.parametrize("mode", list(MODES))
def test_render_matches_jax_f32(f32_matmuls, mode):
    _compare(mode, "f32")


@pytest.mark.parametrize("mode", list(MODES))
def test_render_matches_jax_fused_bf16(mode):
    _compare(mode, "bf16")
