"""The masked regime (``confs/wmask_tpu.conf``) of the port against vdnerf_tpu.

The conf's renderer at small widths: no background NeRF (``n_outside = 0``)
and a 16-of-32 importance-resampled core at the default
``resample_uniform_frac = 0.25``, so the ladder's 4th round queries the SDF
(K1 on the card), ``section_weights`` builds the core's weight estimate at
the learned sharpness, and ``est_dist_cap`` bounds the core's alpha
estimator. The step adds the mask BCE (``use_mask``, ``mask_weight = 0.1``)
and the masked PSNR; it runs on the faithful 32-sample core (before
``resample_from``) and on the resampled one.

Both sides run their fused-MLP operands in f32 (``f32_matmuls``) except in
the bf16 render, which holds the port's production bf16 operands against
JAX's fused path.

Tolerances. Given the same SDF values, each up-sample round of the two
packages agrees within two f32 ulps; but the SDF itself differs by ~4e-7
(f32 summation order), and the rounds at inv_s 256 and 512 amplify that to
~1e-4 in the ladder's positions. The resampled core draws its samples from
those positions through a sharp weight estimate, so its gradients carry that
noise: 1e-4 of the largest entry (``tests/test_torch_train.py``) is not
reachable there. Measured over 3 parameter seeds x 4 steps: gradients of the
resampled core within 5.6e-4 relative L2 of JAX's, of the faithful core 1.5e-4
(the variance scalar), loss and metrics within 4.2e-5 relative.

- Render, deterministic: colour within 1e-5 of the JAX default path (f32), or
  5e-3 of JAX's fused path (bf16: an activation's rounding can land on the
  other side); weight sum, core positions and the eikonal numerator within
  1e-4 (f32); argmax-weight depth within 1e-4 on at least 99% of the rays.
- Step: loss and metrics within 1e-4 relative; each gradient within 5e-4
  (faithful core) or 2e-3 (resampled core) relative L2.
- Trajectory: 20 steps' losses within 1e-4 relative, on both cores.
- The port alone: the background NeRF is never evaluated, gets a zero
  gradient, and Adam leaves it bit for bit as it was (zero moments); the
  checkpoint reads into the JAX package with its Adam moments.
"""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest
import torch

from test_torch_render import _jax_render, _port_render, _weight_depth
from test_torch_train import (  # noqa: F401
    H,
    W,
    _batches,
    _cfgs,
    _jax_tree_as_port,
    _jax_value_and_grad,
    _port_grads,
    fused,
    scene,
)
from torch_parity import f32_matmuls, jax_nets, jax_params, one_torch_thread, port_model, port_nets, rays  # noqa: F401
from vdnerf_tpu.train import SceneStatic, init_state, make_train_step
from vdnerf_tpu.train.step import make_loss_fn
from vdnerf_tpu_torch.models.fields import NeRF, SDFNetwork
from vdnerf_tpu_torch.train.step import Trainer

NETS = jax_nets(n_outside=0, n_render_samples=16, perturb=0.0)
CORES = {"faithful": jax_nets(n_outside=0, perturb=0.0), "resampled": NETS}
MASK = dict(use_mask=True, mask_weight=0.1)
N_RAYS = 64
COLOR_TOL = {"f32": 1e-5, "bf16": 5e-3}


@pytest.fixture
def counted(monkeypatch):
    """Counts the port's SDF value queries (K1's wrapper on the card) and
    fails on any background-NeRF evaluation (K4)."""
    calls = {"sdf_value": 0}
    sdf_value = SDFNetwork.sdf_value

    def count(self, pts):
        calls["sdf_value"] += 1
        return sdf_value(self, pts)

    def refuse(self, *args):
        raise AssertionError("the masked path evaluated the background NeRF")

    monkeypatch.setattr(SDFNetwork, "sdf_value", count)
    monkeypatch.setattr(NeRF, "forward", refuse)
    return calls


def _render_both(policy):
    params = jax_params(NETS, seed=3)
    o, d = rays(N_RAYS, seed=5)
    want = _jax_render(NETS, params, o, d, fused=policy == "bf16")
    return _port_render(NETS, params, o, d,
                        torch.float32 if policy == "f32" else torch.bfloat16), want


@pytest.mark.parametrize("policy", ["f32", "bf16"])
def test_masked_render_matches_jax(request, counted, policy):
    if policy == "f32":
        request.getfixturevalue("f32_matmuls")
    got, want = _render_both(policy)
    # the 64-sample ladder + 3 rounds, and the 4th round the weight estimate reads
    assert counted["sdf_value"] == 5
    assert got["color_fine"].shape == (N_RAYS, 3) and got["weights"].shape == (N_RAYS, 16)
    assert np.isfinite(got["color_fine"]).all()
    tol = COLOR_TOL[policy]
    np.testing.assert_allclose(got["color_fine"], want["color_fine"], atol=tol, rtol=0)
    np.testing.assert_allclose(got["weight_sum"], want["weight_sum"], atol=max(tol, 1e-4), rtol=0)
    np.testing.assert_allclose(got["inside_sphere"], want["inside_sphere"])
    agree = np.abs(_weight_depth(got) - _weight_depth(want)) <= 1e-4
    assert agree.mean() >= 0.99, f"weight_depth agrees on {agree.mean():.3f} of rays"
    if policy == "f32":
        # the resampled core's positions: the weight estimate and the det
        # inverse CDF on the same ladder
        np.testing.assert_allclose(got["z_vals"], want["z_vals"], atol=1e-4, rtol=0)
        np.testing.assert_allclose(got["gradient_error_num"], want["gradient_error_num"],
                                   atol=1e-4, rtol=1e-4)


GRAD_L2_TOL = {"faithful": 5e-4, "resampled": 2e-3}


@pytest.mark.parametrize("step", [0, 30])
@pytest.mark.parametrize("core", list(CORES))
def test_masked_step_matches_jax(scene, f32_matmuls, fused, counted, core, step):
    nets = CORES[core]
    jcfg, tcfg = _cfgs(scene, **MASK)
    params = jax_params(nets)
    (jb,), (tb,) = _batches(scene, 1)
    assert 0 < (tb["mask"] > 0.1).mean() < 1  # the batch sees object and background
    loss, metrics, g = _jax_value_and_grad(scene, jcfg, params, jb, step,
                                           make_loss_fn(nets, jcfg, SceneStatic(H=H, W=W)))

    model = port_model(nets, params, f32_matmuls)
    got = Trainer(tcfg, model, scene["tcams"], None).gradients(port_nets(nets), tb, step)
    assert counted["sdf_value"] == (5 if core == "resampled" else 4)
    assert metrics["mask_loss"] > 0.1
    for k, v in metrics.items():
        assert abs(float(got[k]) - v) <= 1e-4 * max(abs(v), 1e-3), (k, float(got[k]), v)
    grads, want = _port_grads(model), _jax_tree_as_port(g)
    assert set(grads) == set(want)
    for name, gr in grads.items():
        w = want[name].reshape(gr.shape)
        rel = np.linalg.norm(gr - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= GRAD_L2_TOL[core], f"{name}: relative L2 error {rel:.3e}"


@pytest.mark.parametrize("core", list(CORES))
def test_masked_twenty_step_trajectory_matches_jax(scene, f32_matmuls, fused, core):
    nets = CORES[core]
    jcfg, tcfg = _cfgs(scene, warm_up_end=5, **MASK)
    params = jax_params(nets)
    jbs, tbs = _batches(scene, 20, seed=4)
    state = init_state(params, jcfg, scene["jcams"], jax.random.PRNGKey(0))
    step_fn = jax.jit(make_train_step(nets, jcfg, SceneStatic(H=H, W=W)))
    want = []
    for b in jbs:
        state, m = step_fn(state, b)
        want.append(float(m["loss"]))

    model = port_model(nets, params, f32_matmuls)
    trainer = Trainer(tcfg, model, scene["tcams"], None)
    got = [float(trainer.step(port_nets(nets), b, i)["loss"]) for i, b in enumerate(tbs)]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    assert np.mean(want[-5:]) < np.mean(want[:5])  # it trains


def test_background_nerf_gets_no_gradient_no_move_and_the_checkpoint_reads_into_jax(
        scene, tmp_path, counted):
    from vdnerf_tpu.io.checkpoints import import_torch_checkpoint
    from vdnerf_tpu_torch.io.checkpoints import from_jax_params, save_training_checkpoint

    _, tcfg = _cfgs(scene, **MASK)
    model = port_model(NETS, jax_params(NETS), torch.bfloat16)
    nerf0 = {n: p.detach().clone() for n, p in model.nerf.named_parameters()}
    others0 = {n: p.detach().clone() for n, p in model.named_parameters() if not n.startswith("nerf.")}
    trainer = Trainer(tcfg, model, scene["tcams"], None)
    _, tbs = _batches(scene, 3, seed=6)
    for i, b in enumerate(tbs):
        trainer.step(port_nets(NETS), b, i + 100)  # past warm-up: lr > 0
        assert all(not p.grad.any() for p in model.nerf.parameters())
    for n, p in model.nerf.named_parameters():
        assert torch.equal(p.detach(), nerf0[n]), n
        state = trainer.optimizer.state[p]
        assert not state["exp_avg"].any() and not state["exp_avg_sq"].any()
    moved = [n for n, p in model.named_parameters() if n in others0 and not torch.equal(p, others0[n])]
    assert len(moved) == len(others0)

    path = os.path.join(tmp_path, "ckpt_000003.pth")
    save_training_checkpoint(path, model, 3, trainer.optimizer)
    params, step, moments = import_torch_checkpoint(path, NETS, False, with_optimizer=True)
    assert step == 3 and moments is not None
    mu, nu, count = moments
    assert count == 3
    opt_state = trainer.optimizer.state
    for tree, get in ((params, lambda p: p.detach()),
                      (mu, lambda p: opt_state[p]["exp_avg"]),
                      (nu, lambda p: opt_state[p]["exp_avg_sq"])):
        want = from_jax_params(jax.tree_util.tree_map(np.asarray, tree))
        for name, p in model.named_parameters():
            torch.testing.assert_close(want[name].reshape(p.shape), get(p), rtol=0, atol=0)
