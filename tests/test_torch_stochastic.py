"""The port's stochastic render paths under a ``torch.Generator``, checked
statistically: torch and jax draw different numbers from one seed, so the
draws are compared as distributions.

- The per-ray jitter of the base samples, t = (u - 0.5) * 2 / n_samples,
  recovered from a perturbed render: u ~ U(0, 1).
- The stratified resample, u_i = (i + xi) / n with one xi per ray: the phase
  is shared by every sample of a ray, and xi ~ U(0, 1) in the port and in the
  JAX package alike.

Kolmogorov-Smirnov distances over 4096 rays: to U(0, 1) below 1.63 / sqrt(n),
between the two packages' draws below 1.63 * sqrt(2 / n) (both the 1% level).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_parity import one_torch_thread, jax_nets, jax_params, port_model, port_nets, rays  # noqa: F401
from vdnerf_tpu.ops import sampling as js
from vdnerf_tpu_torch.data.dataset import near_far_from_sphere
from vdnerf_tpu_torch.ops import renderer as tr
from vdnerf_tpu_torch.ops import sampling as ts

N = 4096


def _ks_uniform(u: np.ndarray) -> float:
    u = np.sort(u)
    n = len(u)
    return float(max(np.max(np.arange(1, n + 1) / n - u), np.max(u - np.arange(n) / n)))


def _ks_two(a: np.ndarray, b: np.ndarray) -> float:
    grid = np.sort(np.concatenate([a, b]))
    fa = np.searchsorted(np.sort(a), grid, side="right") / len(a)
    fb = np.searchsorted(np.sort(b), grid, side="right") / len(b)
    return float(np.abs(fa - fb).max())


def test_render_jitter_is_uniform_per_ray():
    nets = jax_nets()
    rcfg = tr.RendererConfig(n_samples=16, n_importance=0, n_outside=0, perturb=1.0)
    pnets = dataclasses.replace(port_nets(nets), renderer=rcfg)
    model = port_model(nets, jax_params(nets))
    o, d = (torch.from_numpy(a) for a in rays(N))
    near, far = near_far_from_sphere(o, d)
    outs = []
    for seed in (0, 0, 1):  # the same seed draws the same jitter
        with torch.no_grad():
            outs.append(tr.render(pnets, model, o, d, near, far,
                                  generator=torch.Generator().manual_seed(seed),
                                  background_rgb=torch.ones(1, 3))["z_vals"])
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    step = (far - near)[:, 0] / (rcfg.n_samples - 1)
    t = outs[0][:, 0] - 0.5 * step - near[:, 0]
    u = (t * rcfg.n_samples / 2.0 + 0.5).numpy()
    assert _ks_uniform(u) < 1.63 / np.sqrt(N)


def test_stratified_resample_shares_one_uniform_phase_per_ray():
    n = 24
    bins = np.tile(np.linspace(2.0, 4.0, 49, dtype=np.float32), (N, 1))
    w = np.full((N, 48), 1.0 / 48, np.float32)
    got = ts.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), n, stratified=True,
                        generator=torch.Generator().manual_seed(0)).numpy()
    want = np.asarray(js.sample_pdf(jnp.asarray(bins), jnp.asarray(w), n,
                                    key=jax.random.PRNGKey(0), stratified=True))
    phases = []
    for s in (got, want):
        xi = (s - 2.0) / 2.0 * n - np.arange(n)[None, :]
        assert np.abs(xi - xi[:, :1]).max() < 1e-3
        assert _ks_uniform(xi[:, 0]) < 1.63 / np.sqrt(N)
        phases.append(xi[:, 0])
    assert _ks_two(*phases) < 1.63 * np.sqrt(2.0 / N)
