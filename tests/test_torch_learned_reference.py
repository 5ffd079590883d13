"""The learned-camera recipe (``confs/womsk_learn_white_wdepth_colmap.conf``)
against the benchmark's plain reference, on the CPU at small widths.

The configuration is the benchmark's ``wdepth_learn`` shrunk as the
benchmark's own tests shrink it (``vdnbench/tests/small.py``), on its
faithful core (the published conf has no resampled one) and in windows of one
step; its traffic's driver (``vdnbench/drivers/train_window_full.py``) makes
the seeded scene, the perturbed camera file and the weights.

- 1 and 3 steps of the port's ``Trainer`` with learned cameras, the
  distillation, the 128-of-128 core and the background over every sample,
  against ``vdnbench/reference/learned_cameras.py`` over ``neus.py`` (plain
  torch, f32, neither JAX nor the port): the loss of each step, every
  network leaf's first gradient and change, and ``r``, ``t`` and ``fx``'s.
- The reference's SO(3) exponential, pose, K^-1 and learning rates against
  ``data/cameras.py`` and ``train/schedules.py`` at random ``r`` and ``fx``.
- Tracing: with learned cameras ``render.cameras`` opens inside
  ``render.rays``, and ``bwd.cameras`` opens the backward's last piece, in
  which the cameras' gradients are made (not in ``bwd.nerf``); with fixed
  cameras neither mark exists.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from vdnbench import harness
from vdnbench.drivers.train_window_full import Driver
from vdnbench.reference import learned_cameras as ref_cams
from vdnbench.tests.small import small_root
from vdnerf_tpu_torch.data.cameras import init_focal_params, learn_intrin_K_inv
from vdnerf_tpu_torch.train.schedules import (
    focal_lr_milestones,
    multistep_schedule,
    pose_lr_milestones,
)
from vdnerf_tpu_torch.utils import so3, trace

LEARNED = "wdepth_learn.train_cams60k"
CORE128 = "wdepth.train_core128"

# Tolerances: both sides compute in f32 on the CPU, so they differ by the
# order of their sums alone (measured: loss 1e-7, gradients 4e-6 to 8e-6 of
# the leaf's norm). Adam's first steps divide each element by its own |g|,
# so an element whose gradient is within rounding of 0 can move by up to
# 2 lr: the networks' changes get 1e-3 (measured 4e-5). The cameras' leaves
# are few and their gradients far from 0 (measured 1e-7 to 4e-6).
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
CHANGE_TOL = 1e-3
CAM_TOL = 1e-4


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    out = small_root(str(tmp_path_factory.mktemp("root")))
    path = os.path.join(out, harness.HOME, "configs", "wdepth_learn.json")
    with open(path) as f:
        config = json.load(f)
    config["conf"]["model"]["neus_renderer"].pop("n_render_samples")
    config["conf"]["train"]["steps_per_call"] = 1
    with open(path, "w") as f:
        json.dump(config, f)
    return out


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def driver(root, workload, workdir, steps=1, seed=2**31 + 51) -> Driver:
    """The cell's driver with ``steps`` one-step windows checked, no warm-up."""
    cell = harness.cell(root, workload)
    traffic = {**cell["traffic"], "check_windows": [1] * steps, "change_after": steps,
               "warm_windows": 0}
    return Driver({**cell, "traffic": traffic}, seed, "cpu", str(workdir))


@pytest.mark.parametrize("steps", [1, 3])
def test_learned_steps_match_the_plain_reference(root, tmp_path, steps):
    drv = driver(root, LEARNED, tmp_path, steps)
    trace.reset()
    drv.setup()
    programs = {k for k in trace.counts() if k.startswith("dispatch.eager_steps.")}
    assert programs == {"dispatch.eager_steps.core16.distill.refine"}
    drv.free()
    got, ref = drv.readings(), drv.reference()
    assert len(got["losses"]) == len(ref["losses"]) == steps
    for a, b in zip(got["losses"], ref["losses"]):
        assert abs(a - b) <= LOSS_TOL * abs(b), (a, b)
    nums = drv.compare(got, ref)
    assert nums["grad_diff"] <= GRAD_TOL, nums
    assert nums["change_diff"] <= CHANGE_TOL, nums
    assert nums["cam_grad_diff"] <= CAM_TOL, nums
    assert nums["cam_change_diff"] <= CAM_TOL, nums
    # every leaf was compared, and the cameras' are not trivially zero
    assert set(got["grad"]) == set(ref["grad"]) and {"cam.r", "cam.t", "cam.fx"} <= set(ref["grad"])
    for k in ("cam.r", "cam.t", "cam.fx"):
        assert float(ref["grad"][k].norm()) > 0 and float(ref["change"][k].norm()) > 0, k
    # the image of each step: its camera's rows alone move
    moved = (ref["change"]["cam.r"].abs().sum(1) > 0).sum()
    assert int(moved) == len({int(b["img_idx"]) for b in drv.checked["batches"]})


@pytest.mark.parametrize("seed", range(4))
def test_reference_camera_math_matches_the_port(seed):
    g = torch.Generator().manual_seed(seed)
    r = (torch.randn(3, generator=g) * 0.6).requires_grad_(True)
    t = torch.randn(3, generator=g)
    probe = torch.randn(4, 4, generator=g)
    want = so3.make_c2w(r, t)
    got = ref_cams.make_c2w(r, t)
    assert torch.allclose(got, want, atol=1e-6)
    (g_want,) = torch.autograd.grad((want * probe).sum(), r)
    (g_got,) = torch.autograd.grad((got * probe).sum(), r)
    assert torch.allclose(g_got, g_want, rtol=1e-5, atol=1e-6)
    fx = (0.6 + torch.rand((), generator=g)).requires_grad_(True)
    for order in (1, 2):
        want = learn_intrin_K_inv(fx, 300, 400, order)
        got = torch.linalg.inv(ref_cams.intrinsics(fx, 300, 400, order))
        assert torch.allclose(got, want, rtol=1e-6, atol=1e-9)
        (g_want,) = torch.autograd.grad((want * probe).sum(), fx)
        (g_got,) = torch.autograd.grad((got * probe).sum(), fx)
        assert torch.allclose(g_got, g_want, rtol=1e-5)
        assert ref_cams.init_fx(560.0, 400, order) == init_focal_params(560.0, 400, order)
    tc = {"warm_up_end": 5000, "end_iter": 300000, "step_size": 5000, "pose_lr": 5e-4,
          "focal_lr": 5e-4, "pose_lr_gamma": 0.9, "focal_lr_gamma": 0.9}
    pose = multistep_schedule(5e-4, pose_lr_milestones(5000, 300000, 5000), 0.9)
    focal = multistep_schedule(5e-4, focal_lr_milestones(5000, 300000, 5000), 0.9)
    for step in (0, 4999, 5000, 30000, 60000, 60001, 299999):
        assert ref_cams.pose_lr_at(tc, step) == pose(step)
        assert ref_cams.focal_lr_at(tc, step) == focal(step)


def _one_step_marks(runner, step):
    """One learned step's marks, with an entry ("grad", "r") where the
    cameras' rotation gets its gradient."""
    batch = runner.store.sample_pixels(0, 16, np.random.default_rng(0))
    with trace.recording() as marks:
        hook = None
        if runner.cams is not None:
            hook = runner.cams.r.register_hook(lambda g: marks.append(("grad", "r")))
        try:
            runner.trainer.step(runner.nets, batch, step)
        finally:
            if hook is not None:
                hook.remove()
    return list(marks)


def test_camera_backward_is_a_piece_of_its_own(root, tmp_path):
    drv = driver(root, LEARNED, tmp_path)
    marks = _one_step_marks(drv.make_runner("train"), 60000)
    begins = [n for k, n in marks if k == "begin"]
    assert begins.index("render.cameras") == begins.index("render.rays") + 1
    assert marks.index(("end", "render.cameras")) < marks.index(("end", "render.rays"))
    points = [n for k, n in marks if k == "at"]
    assert points == ["bwd.colour_head", "bwd.depth_head", "bwd.sdf", "bwd.nerf", "bwd.cameras"]
    grad = marks.index(("grad", "r"))
    assert marks.index(("at", "bwd.cameras")) < grad < marks.index(("end", "step.backward"))


def test_fixed_cameras_mark_no_camera_span(root, tmp_path):
    drv = driver(root, CORE128, tmp_path)
    runner = drv.make_runner("train")
    assert runner.cams is None
    marks = _one_step_marks(runner, 30000)
    names = {n for _, n in marks}
    assert "render.rays" in names and "bwd.nerf" in names
    assert not names & {"render.cameras", "bwd.cameras"}
