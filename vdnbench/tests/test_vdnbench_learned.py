"""Traffic kind ``train_window_full`` at a CPU size, against the committed
limits: the learned-camera cell and the fixed-camera cell before
``resample_from`` are correct; each planted fault of the learned cameras
(their gradients zeroed, their Adams skipped, the camera file holding the
true poses while the reference starts from the perturbed ones) fails the
check, and so do the controls in both cells; the driver times the program
``Runner.train`` runs at its steps; the perturbed camera file; the new
readers on synthetic records; the camera change's sign floor."""

from __future__ import annotations

import json
import os
import time
import types

import numpy as np
import pytest
import torch

from vdnbench import control, harness, marks, work
from vdnbench.drivers import train_window_full as twf
from vdnbench.tests.small import REPO, small_root
from vdnbench.tests.test_vdnbench_marks import mark, record

LEARNED = "wdepth_learn.train_cams60k"
CORE128 = "wdepth.train_core128"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The small root, the learned configuration on its faithful core (the
    published conf has no resampled core: the shrink's would be a departure)."""
    out = small_root(str(tmp_path_factory.mktemp("root")))
    path = os.path.join(out, harness.HOME, "configs", "wdepth_learn.json")
    with open(path) as f:
        config = json.load(f)
    config["conf"]["model"]["neus_renderer"].pop("n_render_samples")
    with open(path, "w") as f:
        json.dump(config, f)
    return out


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(root, workload, seed, tmp_path):
    return harness.run_cell(root, workload, seed, 0.3, False, "cpu", str(tmp_path),
                            time.perf_counter())


@pytest.mark.parametrize("workload", [LEARNED, CORE128])
def test_sound_run_is_correct(root, workload, tmp_path):
    out = run(root, workload, 2**31 + 41, tmp_path)
    assert out["correct"] is True, out["checks"]
    assert set(out["checks"]) == set(harness.cell(root, workload)["limits"])
    if workload == LEARNED:
        assert {"cam_grad_diff", "cam_change_diff"} <= set(out["checks"])


@pytest.mark.parametrize("fault", ["cam_grad_zero", "cam_adam_skipped", "poses_clean"])
def test_a_planted_camera_fault_is_not_correct(root, fault, tmp_path):
    with twf.planted(fault):
        out = run(root, LEARNED, 2**31 + 42, tmp_path)
    assert out["correct"] is False, out["checks"]
    failed = {k for k, (v, limit) in out["checks"].items() if not v <= limit}
    assert "cam_grad_diff" in failed or fault == "poses_clean", failed
    assert "cam_change_diff" in failed, failed


@pytest.mark.parametrize("workload, mode", [(w, m) for w in (LEARNED, CORE128)
                                            for m in ("tf32", "half_batch", "unchanged")])
def test_controls_are_not_correct(root, workload, mode):
    cell = harness.cell(root, workload)
    got = control.read(cell, 2**31 + 43, ["program", mode], 0.5, torch.device("cpu"))
    assert harness.judge(got["program"], cell["limits"])[0], got["program"]
    assert not harness.judge(got[mode], cell["limits"])[0], got[mode]


def test_the_program_runner_train_runs_at_the_steps(root, tmp_path):
    """Before resample_from the faithful core (program ``core<all>``), its
    rows in the work counts; from a step past it the resampled core."""
    from vdnerf_tpu_torch.train.dispatch import program_name

    cell = harness.cell(root, CORE128)
    drv = harness.driver("train_window_full")(cell, 5, "cpu", str(tmp_path))
    r = cell["config"]["conf"]["model"]["neus_renderer"]
    n_all = r["n_samples"] + r["n_importance"]
    assert drv.boundary == cell["config"]["conf"]["train"]["resample_from"] and drv.faithful
    assert drv.model_cfg["neus_renderer"]["n_render_samples"] == 0
    drv.runner = drv.make_runner("train")
    assert program_name(drv.runner.nets, True, False) == f"core{n_all}.distill"
    sizes = {"kind": "train_window_full", "batch_size": 16}
    assert work.rows(drv.model_cfg, sizes)["core"] == 16 * n_all
    # steps that cross the switch raise
    drv.step = drv.boundary - 2
    with pytest.raises(ValueError, match="cross the core switch"):
        drv.one_window(4)
    late = {**cell, "traffic": {**cell["traffic"], "start_step": drv.boundary + 10}}
    drv = harness.driver("train_window_full")(late, 5, "cpu", str(tmp_path / "late"))
    assert drv.boundary == 0 and not drv.faithful
    assert drv.model_cfg["neus_renderer"]["n_render_samples"] == r["n_render_samples"]


def test_the_camera_file_holds_the_perturbed_poses(root, tmp_path):
    from vdnerf_tpu_torch.data.dataset import load_K_Rt_from_P

    cell = harness.cell(root, LEARNED)
    drv = harness.driver("train_window_full")(cell, 2**31 + 44, "cpu", str(tmp_path))
    drv.runner = drv.make_runner("train")
    true, init = drv.made["c2w"], drv.init_c2w
    path = os.path.join(str(tmp_path), "scene", "image", "cameras_sphere_colmap.npz")
    with np.load(path) as cams:
        for i in range(len(true)):
            _, pose = load_K_Rt_from_P(None, cams[f"world_mat_{i:03d}"][:3, :4])
            np.testing.assert_allclose(pose, init[i], atol=1e-4)
    np.testing.assert_allclose(drv.runner.cams.init_c2w.numpy(), init, atol=1e-4)
    # about 2 degrees of rotation and 0.02 of translation a component
    angles = [np.degrees(np.arccos(np.clip((np.trace(a[:3, :3].T @ b[:3, :3]) - 1) / 2, -1, 1)))
              for a, b in zip(true, init)]
    assert 0.5 < np.mean(angles) < 5.0
    assert 0.005 < np.abs(init[:, :3, 3] - true[:, :3, 3]).mean() < 0.05
    again = twf.perturbed_poses(true, 2**31 + 44, 0.025, 0.02)
    np.testing.assert_array_equal(again, init)
    assert not np.array_equal(twf.perturbed_poses(true, 7, 0.025, 0.02), init)


def test_camera_readers_on_synthetic_records(monkeypatch):
    layer = harness.reader(REPO, "layer.cameras_ms.train")
    share = harness.reader(REPO, "cameras.refined_share.train")
    steps = [mark("begin", "step", 0.0),
             mark("begin", "render.rays", 0.1), mark("begin", "render.cameras", 0.2),
             ("elementwise_kernel", 0.3, 0.5), mark("end", "render.cameras", 0.5),
             ("elementwise_kernel", 0.6, 0.7), mark("end", "render.rays", 0.7),
             mark("begin", "step.backward", 1.0), ("nerf_bwd_kernel", 1.1, 1.9),
             mark("at", "bwd.nerf", 1.0), mark("at", "bwd.cameras", 2.0),
             ("reduce_kernel", 2.1, 2.4), mark("end", "step.backward", 2.5),
             mark("end", "step", 2.6)]
    rec = record(steps, units=2, window=(0.0, 3.0))
    assert layer(rec) == pytest.approx((0.2 + 0.3) / 2 * 1e3)
    m = marks.of(rec)
    assert m.layer_s("nerf") == pytest.approx(0.8)
    assert m.unmarked_s() == pytest.approx(0.5)  # no layer holds the cameras' pieces
    assert layer(record([mark("begin", "step", 0.0), ("k", 0.1, 0.2)])) is None
    assert layer(record([("k", 0.1, 0.2)])) is None
    monkeypatch.setattr(marks, "program_trace", lambda: None)
    assert share(rec) is None
    counts = {"dispatch.replays.core128.distill.refine": 30, "dispatch.eager_steps.x": 3}
    monkeypatch.setattr(marks, "program_trace",
                        lambda: types.SimpleNamespace(counts=lambda: counts))
    assert share(rec) == 1.0
    counts["dispatch.replays.core128.distill"] = 10
    assert share(rec) == 0.75
    counts.clear()
    assert share(rec) is None


def test_sign_floor_leaves_out_elements_rounding_decides():
    g = {"r": torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.05, -0.5]]),
         "t": torch.tensor([[0.2, -1.0, 0.0], [0.0, 0.0, 0.0]]), "fx": torch.tensor(1e-9)}
    keep = twf.sign_decided([g])
    assert keep["cam.r"].tolist() == [[True, True, True], [True, False, True]]
    assert keep["cam.t"].tolist() == [[True, True, False], [True, True, True]]
    assert bool(keep["cam.fx"])
    # an element left out on any checked step stays out
    later = {"r": torch.tensor([[0.01, 1.0, 1.0], [0.0, 0.0, 0.0]]), "t": g["t"], "fx": g["fx"]}
    assert twf.sign_decided([g, later])["cam.r"].tolist() == [[False, True, True],
                                                             [True, False, True]]
