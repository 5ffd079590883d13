"""The check at a size a CPU test run holds, against the committed limits:
a sound run is correct; the controls (the program's bf16 path; the
reference in TF32 put in the program's place) and each fault the cell can
have, planted under the timed path (a step that returns its state
unchanged; half of each batch left out, the mean taken over the rest; a
chunk of each frame altered where the renderer produces it), are not.
The harness's look for a card is skipped: the run is on the CPU."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from vdnbench import control, harness, scene, weights
from vdnbench.tests.small import small_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(str(tmp_path_factory.mktemp("root")))


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TRAIN = ["womsk.train_rs96", "wdepth.train_rs96"]


def correct(cell, numbers):
    return harness.judge(numbers, cell["limits"])[0]


@pytest.mark.parametrize("workload, mode", [(w, m) for w in TRAIN for m in ("bf16", "tf32")]
                         + [("womsk.views_l4", m) for m in ("tf32", "bf16")])
def test_controls_are_not_correct(root, workload, mode):
    cell = harness.cell(root, workload)
    got = control.read(cell, 2**31 + 21, ["program", mode], 0.5, torch.device("cpu"))
    assert correct(cell, got["program"]), got["program"]
    assert not correct(cell, got[mode]), got[mode]


@pytest.mark.parametrize("workload, fault", [(w, f) for w in TRAIN for f in (
    "half_batch", "unchanged")] + [("womsk.views_l4", "altered")])
def test_a_run_with_a_fault_is_not_correct(root, workload, fault, tmp_path):
    with control.planted(fault):
        out = harness.run_cell(root, workload, 2**31 + 22, 0.3, False, "cpu", str(tmp_path),
                               time.perf_counter())
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("workload", TRAIN + ["womsk.views_l4"])
def test_sound_run_is_correct(root, workload, tmp_path):
    out = harness.run_cell(root, workload, 1234, 0.3, False, "cpu", str(tmp_path),
                           time.perf_counter())
    assert out["correct"] is True, out["checks"]
    assert set(out["checks"]) == set(harness.cell(root, workload)["limits"])


def test_scene_and_weights_follow_the_seed(root, tmp_path):
    config = harness.cell(root, "wdepth.train_rs96")["config"]
    made = [scene.make(str(tmp_path / f"s{i}"), config["scene"], seed, ("wavelet_feats/0", 6))
            for i, seed in enumerate((7, 7, 8))]
    for key in ("images", "feats", "c2w"):
        assert np.array_equal(made[0][key], made[1][key])
        assert not np.array_equal(made[0][key], made[2][key])
    model = config["conf"]["model"]
    w = [weights.make(model, seed, "cpu") for seed in (7, 7, 8)]
    assert all(torch.equal(w[0][k], w[1][k]) for k in w[0])
    assert not torch.equal(w[0]["nerf.pts_linears.0.weight"], w[2]["nerf.pts_linears.0.weight"])
    # the geometric init: the SDF's first layer reads xyz only
    v = w[0]["sdf_network_fine.lin0.weight_v"]
    assert torch.count_nonzero(v[:, 3:]) == 0 and torch.count_nonzero(v[:, :3]) == v.shape[0] * 3



def test_sdf_tf32_control_allows_tf32_in_the_program_and_restores():
    from vdnerf_tpu_torch import runner

    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    configure = runner.configure_numerics
    with control.planted("sdf_tf32"):
        runner.configure_numerics()
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before
    assert runner.configure_numerics is configure
