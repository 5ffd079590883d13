"""``vdnerf_tpu_torch.tools.flagship_run`` on the CPU at small widths.

The tool's networks are shrunk by monkeypatching ``flagship_nets`` (SDF
4x64, colour head 2x32, background NeRF 2x32, 16+16 samples and 8 outside),
the scene to 4 views of 24^2, the run to 10 steps in one window, the meshes
to 24^3 and the Chamfer sampling to 2,000 points. Held:

- every ``--train-mode`` (womsk with the record's ``--fast-bg
  --render-samples --resample-from --resample-frac``, masked, wdepth) and
  ``--learn`` / ``--learn-frozen`` run to a report whose keys are those of
  the JAX tool's records (``docs/FLAGSHIP_r05_*.json``), the two that time an
  XLA compile renamed to the warm-up-and-capture time, plus ``card`` and
  ``launches``; the curve, the final metrics and the pose statistics carry
  the JAX keys too, every number is finite, the checkpoint (and the learned
  cameras' pnf file) is written;
- the masked PSNR equals the JAX tool's (``val_image_metrics`` over the
  eval mask > 0.1) on the same render;
- the Chamfer ground truth: the grid of ``geometry_qc`` through the torch
  SDFs equals the numpy SDFs' within 1e-6;
- the tool's window rule is the JAX tool's ``k_scan`` rule, and without a card
  the tool refuses to run (only ``device="cpu"`` runs it on the CPU);
- ``--fused`` (or ``VDNERF_FUSED=1``) selects K2-K5's bf16 operand mode
  through ``mlp_operand_dtype``, and the report's ``fused_mlp`` is true
  exactly then, as the JAX tool's is under ``--fused``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from torch_parity import one_torch_thread  # noqa: F401
from vdnerf_tpu.train.validate import val_image_metrics as jax_val_image_metrics
from vdnerf_tpu_torch.data import synthetic
from vdnerf_tpu_torch.mesh import qc
from vdnerf_tpu_torch.mesh.extract import extract_fields
from vdnerf_tpu_torch.models.fields import RenderConfig, SDFConfig
from vdnerf_tpu_torch.models.precision import matmul_dtype, mlp_operand_dtype
from vdnerf_tpu_torch.tools import flagship_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--iters", "10", "--val-every", "10", "--views", "4", "--img-res", "24",
         "--resolution", "24", "--batch", "32"]
RENAMED = {"startup_compile_s": "startup_warmup_capture_s",
           "resample_onset_compile_s": "resample_onset_warmup_capture_s"}
RUNS = {
    "womsk": ["--fast-bg", "--render-samples", "24", "--resample-from", "5",
              "--resample-frac", "1.0"],
    "masked": ["--train-mode", "masked"],
    "wdepth": ["--train-mode", "wdepth"],
    "learn": ["--learn"],
    "learn_frozen": ["--learn-frozen", "--fp32"],
    "fp32_fused": ["--fp32", "--fused"],
}


def _small_nets(train_mode, fast_bg, render_samples, resample_frac):
    nets = _FULL_NETS(train_mode, fast_bg, render_samples, resample_frac)
    return dataclasses.replace(
        nets,
        sdf=SDFConfig(d_out=65, d_hidden=64, n_layers=4, skip_in=(2,)),
        color=RenderConfig(d_feature=64, d_hidden=32, n_layers=2),
        nerf=dataclasses.replace(nets.nerf, D=2, W=32, multires=4, multires_view=2),
        renderer=dataclasses.replace(nets.renderer, n_samples=16, n_importance=16,
                                     n_outside=nets.renderer.n_outside and 8,
                                     up_sample_steps=2),
        depth=None if nets.depth is None else RenderConfig(d_feature=64, d_hidden=32,
                                                           n_layers=2, d_out=96),
    )


_FULL_NETS = flagship_run.flagship_nets


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("VDNERF_FUSED", raising=False)
        mp.setattr(flagship_run, "flagship_nets", _small_nets)
        mp.setattr(flagship_run, "geometry_qc",
                   lambda *a, **k: qc.geometry_qc(*a, **k, n_points=2000))
        out = {}
        for name, flags in RUNS.items():
            d = str(tmp_path_factory.mktemp(f"flagship_{name}"))
            out[name] = (d, flagship_run.main(SMALL + flags + ["--out", d], device="cpu"))
    return out


def _jax_record(name: str) -> dict:
    with open(os.path.join(ROOT, "docs", name)) as f:
        return json.load(f)


def _finite(x) -> bool:
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_finite(v) for v in x)
    if isinstance(x, float):
        return math.isfinite(x)
    return True


# the JAX tool's current report (its r05 records) and, per mode, its metrics
CURRENT = "FLAGSHIP_r05_learn.json"
METRICS = {"wdepth": "FLAGSHIP_r05_learn_wdepth.json"}


@pytest.mark.parametrize("name", list(RUNS))
def test_every_mode_runs_to_the_jax_report(reports, name):
    out_dir, rep = reports[name]
    want = _jax_record(CURRENT)
    assert set(rep) == {RENAMED.get(k, k) for k in want} | {"card", "launches"}
    assert set(want["config"]) <= set(rep["config"])
    assert rep["config"]["bf16"] is ("--fp32" not in RUNS[name])
    assert rep["card"] is None and rep["config"]["device"] == "cpu"
    assert rep["launches"]["train"] == {k: 0 for k in rep["launches"]["train"]}  # plain versions
    assert [set(c) for c in rep["psnr_curve"]] == [set(want["psnr_curve"][0])]
    assert rep["psnr_curve"][0]["iter"] == 10
    metrics = _jax_record(METRICS.get(name, CURRENT))["final_train_metrics"]
    assert set(rep["final_train_metrics"]) == set(metrics)
    assert set(rep["mesh"]) == set(want["mesh"])
    assert set(rep["chamfer"]) == set(want["chamfer"])
    if name == "learn":
        assert set(rep["pose_refinement"]) == set(want["pose_refinement"])
    else:
        assert rep["pose_refinement"] is None
    assert _finite({k: v for k, v in rep.items() if k not in ("chamfer", "mesh_clean")})
    with open(os.path.join(out_dir, "flagship_report.json")) as f:
        assert json.load(f) == json.loads(json.dumps(rep))
    assert os.path.exists(os.path.join(out_dir, "checkpoints", "ckpt_000010.pth"))
    assert os.path.exists(os.path.join(out_dir, "pnf_checkpoints", "pnf_000010.pth")) is (
        name == "learn")
    if name == "wdepth":
        feats = np.load(os.path.join(out_dir, "image", "00", "000.npy"))
        assert feats.shape == (96, 12, 12) and np.isfinite(feats).all()


def test_masked_psnr_equals_the_jax_tools():
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(24, 32, 3))
    gt = np.clip(img + rng.normal(scale=0.05, size=img.shape), 0, 1)
    eval_mask = rng.uniform(size=(24, 32, 1))
    eval_mask[0, :4] = 0.1  # the threshold is strict
    got = flagship_run.masked_metrics(img, gt, eval_mask)
    want = jax_val_image_metrics(img, gt, (eval_mask > 0.1).astype(np.float32))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("geometry", ["compound", "arch"])
def test_chamfer_ground_truth_grid_matches_numpy(geometry):
    np_sdf, torch_sdf = synthetic.GEOMETRIES[geometry]
    lo, hi = np.full(3, -1.01), np.full(3, 1.01)
    got = extract_fields(lo, hi, 40, lambda p: -torch_sdf(p), device="cpu")
    want = extract_fields(lo, hi, 40,
                          lambda p: torch.from_numpy(-np_sdf(p.numpy())).float(),
                          device="cpu")
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got > 0).any() and (got < 0).any()


@pytest.mark.parametrize("val_every,iters,resample_from,want", [
    (2500, 25000, 4170, 10), (100, 300, 150, 10), (25, 300, 0, 5), (7, 21, 0, 1)])
def test_window_rule_is_the_jax_tools(val_every, iters, resample_from, want):
    k = 10
    while val_every % k or iters % k or resample_from % k:
        k //= 2
    assert flagship_run.window_steps(val_every, iters, resample_from) == max(k, 1) == want


def test_tool_refuses_to_run_without_cuda(monkeypatch, tmp_path):
    """Training runs on ``cuda:<--gpu>``: without a card the tool raises
    before it writes anything, unless the caller passes ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        flagship_run.main(SMALL + ["--out", str(out)])
    assert not out.exists()


@pytest.mark.parametrize("name", list(RUNS))
def test_fused_flag_selects_the_operand_mode(reports, name):
    cfg = reports[name][1]["config"]
    fused = "--fused" in RUNS[name]
    assert cfg["fused_mlp"] is fused
    want = mlp_operand_dtype(matmul_dtype("--fp32" not in RUNS[name]), fused)
    assert cfg["mlp_operands"] == {torch.bfloat16: "bf16", torch.float32: "f32"}[want]
    # under --fp32, the split mode unless --fused
    if "--fp32" in RUNS[name]:
        assert cfg["mlp_operands"] == ("bf16" if fused else "f32")


@pytest.mark.parametrize("flags,env,fused", [
    ([], "", False), (["--fused"], "", True), ([], "1", True), (["--fused"], "1", True)])
def test_fused_flag_and_env_select_the_operand_mode(monkeypatch, tmp_path, flags, env, fused):
    """The flag or ``VDNERF_FUSED=1``, read where the model is built: the
    run is stopped there, with the operand mode it chose."""
    monkeypatch.setenv("VDNERF_FUSED", env)
    monkeypatch.setattr(flagship_run, "flagship_nets", _small_nets)
    chosen = []

    class Stop(Exception):
        pass

    def model(*a, mlp_dtype, **k):
        chosen.append(mlp_dtype)
        raise Stop

    monkeypatch.setattr(flagship_run, "NeuSModel", model)
    with pytest.raises(Stop):
        flagship_run.main(SMALL + ["--fp32", "--out", str(tmp_path)] + flags, device="cpu")
    assert chosen == [torch.bfloat16 if fused else torch.float32]
