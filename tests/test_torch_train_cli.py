"""``--mode train`` through the port's CLI on the CPU, on a synthetic sphere
scene at small widths (as ``tests/test_train_e2e.py`` trains the JAX
package), its checkpoints, and resume.

- PSNR of the training batches rises by more than 1 dB over 60 steps, once
  on the faithful core and once with the resampled core switched on mid-run.
- A checkpoint the port writes after 3 steps reads into the JAX package
  through the unmodified ``import_torch_checkpoint(..., with_optimizer=True)``
  with parameters and Adam moments equal to the port's (exact: both are the
  same f32 values, transposed).
- A run resumed from that checkpoint (``is_continue``, what ``-c`` sets)
  takes the same next step as the run that wrote it, bit for bit.
- A conf that extracts meshes during the run trains and writes them.
"""

from __future__ import annotations

import json
import os
import re
import signal

import numpy as np
import pytest
import torch

from torch_parity import one_torch_thread  # noqa: F401
from vdnerf_tpu.data.synthetic import make_synthetic_scene, write_synthetic_conf

N_IMAGES, H, W, BATCH = 6, 48, 48, 128


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_train_cli"))
    make_synthetic_scene(d, n_images=N_IMAGES, H=H, W=W)
    return d


def _conf(data_dir, name, renderer="", perturb=1.0, **train) -> str:
    path = os.path.join(data_dir, f"{name}.conf")
    write_synthetic_conf(path, data_dir=data_dir, exp_dir=os.path.join(data_dir, name),
                         batch_size=BATCH, **train)
    with open(path) as f:
        text = f.read()
    text, n = re.subn(r"perturb = 1\.0", f"perturb = {perturb}" + renderer, text)
    assert n == 1
    with open(path, "w") as f:
        f.write(text)
    return path


def _psnrs(data_dir, name) -> dict[int, float]:
    with open(os.path.join(data_dir, name, "logs", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return {r["step"]: r["psnr"] for r in recs}


def _train(conf, *extra):
    from vdnerf_tpu_torch.cli import main

    return main(["--conf", conf, "--mode", "train", *extra], device="cpu")


RESAMPLED = ("\n        skip_bg_inside = True\n        n_render_samples = 24"
             "\n        resample_uniform_frac = 1.0")


@pytest.mark.parametrize("name,renderer,resample_from", [
    ("faithful", "", 0), ("resampled_mid_run", RESAMPLED, 30)], ids=["faithful", "resampled"])
def test_cli_training_improves_psnr(data_dir, name, renderer, resample_from):
    conf = _conf(data_dir, name, renderer, end_iter=60, val_freq=30, save_freq=60)
    if resample_from:
        with open(conf) as f:
            text = f.read().replace("rgb_dims = 3", f"rgb_dims = 3\n    resample_from = {resample_from}")
        with open(conf, "w") as f:
            f.write(text)
    summary = _train(conf)
    assert summary is not None and all(np.isfinite(v) for v in summary.values())
    psnr = _psnrs(data_dir, name)
    assert sorted(psnr) == [1, 10, 20, 30, 40, 50, 60]
    first, last = np.mean([psnr[1], psnr[10]]), np.mean([psnr[50], psnr[60]])
    assert last > first + 1.0, psnr
    exp = os.path.join(data_dir, name)
    assert os.listdir(os.path.join(exp, "checkpoints")) == ["ckpt_000060.pth"]
    assert sorted(os.listdir(os.path.join(exp, "validations_fine"))) == sorted(
        os.listdir(os.path.join(exp, "normals")))
    assert len(os.listdir(os.path.join(exp, "normals"))) == 2
    assert os.path.exists(os.path.join(exp, "recording", "config.conf"))


@pytest.fixture(scope="module")
def three_steps(data_dir):
    """A Runner that trained 3 steps (perturb 0) and wrote ckpt_000003.pth."""
    from vdnerf_tpu_torch.runner import Runner

    conf = _conf(data_dir, "three", perturb=0.0, end_iter=3, save_freq=3)
    runner = Runner(conf, device="cpu", mode="train")
    runner.train()
    return conf, runner


def test_checkpoint_reads_into_jax_with_adam_moments(data_dir, three_steps):
    from vdnerf_tpu.io.checkpoints import import_torch_checkpoint
    from vdnerf_tpu.train.builder import build_networks
    from vdnerf_tpu.utils.hocon import load_conf
    from vdnerf_tpu_torch.io.checkpoints import from_jax_params

    conf, runner = three_steps
    path = os.path.join(data_dir, "three", "checkpoints", "ckpt_000003.pth")
    params, step, moments = import_torch_checkpoint(
        path, build_networks(load_conf(conf), False), False, with_optimizer=True)
    assert step == 3 and moments is not None
    mu, nu, count = moments
    assert count == 3
    opt_state = runner.trainer.optimizer.state
    for tree, get in ((params, lambda p: p.detach()),
                      (mu, lambda p: opt_state[p]["exp_avg"]),
                      (nu, lambda p: opt_state[p]["exp_avg_sq"])):
        want = from_jax_params(tree)
        for name, p in runner.model.named_parameters():
            torch.testing.assert_close(want[name].reshape(p.shape), get(p), rtol=0, atol=0)


def test_resume_takes_the_same_next_step(data_dir, three_steps):
    from vdnerf_tpu_torch.runner import Runner

    conf, uninterrupted = three_steps
    resumed = Runner(conf, device="cpu", mode="train", is_continue=True)
    assert resumed.iter_step == 3
    batch = uninterrupted.store.sample_pixels(1, BATCH, np.random.default_rng(9))
    for runner in (uninterrupted, resumed):
        runner.trainer.step(runner.nets, batch, runner.iter_step)
    for a, b in zip(uninterrupted.model.parameters(), resumed.model.parameters()):
        assert torch.equal(a, b)


def test_sigterm_checkpoints_at_the_next_step_and_restores_the_handler(data_dir, monkeypatch):
    from vdnerf_tpu_torch.runner import Runner
    from vdnerf_tpu_torch.train.step import Trainer

    conf = _conf(data_dir, "preempt", end_iter=50)
    runner = Runner(conf, device="cpu", mode="train")
    step = Trainer.step

    def step_then_signal(self, nets, batch, i):
        out = step(self, nets, batch, i)
        if i == 1:  # SIGTERM arrives during step 2: deliver it to the handler
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        return out

    monkeypatch.setattr(Trainer, "step", step_then_signal)
    before = signal.getsignal(signal.SIGTERM)
    assert runner.train() is None
    assert signal.getsignal(signal.SIGTERM) is before
    assert os.listdir(os.path.join(data_dir, "preempt", "checkpoints")) == ["ckpt_000002.pth"]


def test_train_refuses_to_skip_mesh_validation(data_dir, monkeypatch):
    """Training does not skip mesh validation: a conf with val_mesh_freq <=
    end_iter trains, and its loop extracts a mesh at every val_mesh_freq-th
    step at the JAX runner's resolution (lowered here to 24^3 by a
    monkeypatch)."""
    from vdnerf_tpu_torch import runner as runner_mod
    from vdnerf_tpu_torch.mesh import load_ply

    calls, full = [], runner_mod.mesh_resolution

    def small(step):
        calls.append((step, full(step)))
        return 24, full(step)[1]

    monkeypatch.setattr(runner_mod, "mesh_resolution", small)
    conf = _conf(data_dir, "mesh", end_iter=4, val_mesh_freq=2)
    assert _train(conf) is not None
    assert calls == [(2, (128, False)), (4, (128, False))]
    meshes = os.path.join(data_dir, "mesh", "meshes")
    assert sorted(os.listdir(meshes)) == ["00000002.ply", "00000004.ply"]
    for name in os.listdir(meshes):
        verts, tris = load_ply(os.path.join(meshes, name))
        assert len(tris) > 100 and np.isfinite(verts).all()
