"""vdnerf_tpu_torch.ops.sampling against vdnerf_tpu.ops.sampling on the same
numpy-seeded inputs. f32 on both sides; atol 1e-5 unless stated (the JAX
side sums by matmul, the port by cumsum)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdnerf_tpu.ops import sampling as js
from vdnerf_tpu_torch.ops import sampling as ts

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.tensor(np.asarray(a))


def _ladder(n_rays=19, n=24, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n_rays, 3))
    o = (3.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)).astype(np.float32)
    d = -o / 3.0 + rng.normal(scale=0.1, size=(n_rays, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    z = np.sort(rng.uniform(2.0, 4.0, size=(n_rays, n)), axis=-1).astype(np.float32)
    pts = o[:, None] + d[:, None] * z[..., None]
    sdf = (np.linalg.norm(pts, axis=-1) - 0.5).astype(np.float32)
    return o, d, z, sdf


def test_transmittance_with_saturated_alpha():
    alpha = np.random.default_rng(1).uniform(0, 1, size=(7, 33)).astype(np.float32)
    alpha[:, 5] = 1.0  # log(0) clamp
    np.testing.assert_allclose(
        ts.transmittance(_t(alpha)).numpy(), np.asarray(js.transmittance(alpha)), **TOL
    )


@pytest.mark.parametrize("uniform", [False, True])
def test_sample_pdf_det(uniform):
    _, _, z, sdf = _ladder()
    w = np.random.default_rng(2).uniform(0, 1, size=(z.shape[0], z.shape[1] - 1)).astype(np.float32)
    if uniform:
        w[:] = 1.0 / w.shape[1]
    w[3, :] = 0.0  # all-zero row: the 1e-5 floor makes it uniform
    w[4, 10:] = 0.0  # zero sections: flat CDF steps (ties)
    got = ts.sample_pdf(_t(z), _t(w), 13, det=True).numpy()
    want = np.asarray(js.sample_pdf(jnp.asarray(z), jnp.asarray(w), 13, det=True))
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert np.all(np.diff(got, axis=-1) >= 0)


def test_sample_pdf_random_modes_stay_in_bins_and_sorted():
    _, _, z, _ = _ladder()
    w = np.ones((z.shape[0], z.shape[1] - 1), np.float32)
    gen = torch.Generator().manual_seed(0)
    strat = ts.sample_pdf(_t(z), _t(w), 9, stratified=True, generator=gen).numpy()
    iid = ts.sample_pdf(_t(z), _t(w), 9, generator=gen).numpy()
    for s in (strat, iid):
        assert np.all(s >= z[:, :1] - 1e-6) and np.all(s <= z[:, -1:] + 1e-6)
    assert np.all(np.diff(strat, axis=-1) >= 0)
    with pytest.raises(ValueError):
        ts.sample_pdf(_t(z), _t(w), 9, stratified=True)


def test_section_weights_and_up_sample():
    o, d, z, sdf = _ladder()
    for inv_s in (64.0, 512.0):
        np.testing.assert_allclose(
            ts.section_weights(_t(o), _t(d), _t(z), _t(sdf), inv_s).numpy(),
            np.asarray(js.section_weights(o, d, z, sdf, inv_s)), **TOL,
        )
        np.testing.assert_allclose(
            ts.up_sample(_t(o), _t(d), _t(z), _t(sdf), 8, inv_s).numpy(),
            np.asarray(js.up_sample(o, d, z, sdf, 8, inv_s)), atol=2e-5,
        )


def test_merge_z_vals_with_ties_carries_sdf():
    rng = np.random.default_rng(4)
    z = np.sort(rng.uniform(0, 1, size=(6, 10)), axis=-1).astype(np.float32)
    new = np.sort(rng.uniform(0, 1, size=(6, 5)), axis=-1).astype(np.float32)
    new[:, 2] = z[:, 4]  # exact ties between the two sets
    sdf = np.sin(7 * z).astype(np.float32)
    new_sdf = np.sin(7 * new).astype(np.float32)  # equal sdf at equal z
    got_z, got_sdf = ts.merge_z_vals(_t(z), _t(new), _t(sdf), _t(new_sdf))
    want_z, want_sdf = js.merge_z_vals(z, new, sdf, new_sdf)
    np.testing.assert_array_equal(got_z.numpy(), np.asarray(want_z))
    np.testing.assert_array_equal(got_sdf.numpy(), np.asarray(want_sdf))
    only_z, none = ts.merge_z_vals(_t(z), _t(new), None, None)
    assert none is None
    np.testing.assert_array_equal(only_z.numpy(), np.asarray(want_z))
