"""The port's NaN guards and profiler hooks (``vdnerf_tpu_torch/utils/debug.py``).

- ``check_finite`` over a tensor, a dict and a list, as a bool tensor;
- ``VDNERF_DEBUG_NANS=1``: a NaN injected into the SDF's weights raises in
  the backward that makes it, through the CLI's training run; without the
  variable the same step returns a NaN loss and raises nothing; the anomaly
  mode is off again after the block;
- ``profile_trace`` writes a Chrome trace of the block, and nothing without
  a directory; ``Runner.train`` under ``VDNERF_PROFILE_DIR`` traces steps
  10-15 (the windows that hold them) into one trace, ended at the run's end
  if the run stops before step 15.
"""

from __future__ import annotations

import json
import os
import re

import pytest
import torch

from vdnerf_tpu_torch.data.synthetic import make_synthetic_scene, write_synthetic_conf
from vdnerf_tpu_torch.utils import debug


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("debug_scene"))
    make_synthetic_scene(d, n_images=3, H=24, W=32)
    return d


def _conf(d: str, name: str, end_iter: int, steps_per_call: int = 1) -> str:
    path = os.path.join(d, f"{name}.conf")
    write_synthetic_conf(path, data_dir=d, exp_dir=os.path.join(d, name), end_iter=end_iter,
                         batch_size=16)
    with open(path) as f:
        text = f.read()
    text, n = re.subn(r"rgb_dims = 3\n}", f"rgb_dims = 3\n    steps_per_call = {steps_per_call}\n}}",
                      text)
    assert n == 1
    with open(path, "w") as f:
        f.write(text)
    return path


def test_check_finite():
    ok = debug.check_finite([torch.ones(3), torch.zeros(2, 2)])
    assert ok.dtype == torch.bool and ok.shape == () and bool(ok)
    assert bool(debug.check_finite(torch.ones(4)))
    assert bool(debug.check_finite({}))
    assert not bool(debug.check_finite({"a": torch.ones(2), "b": torch.tensor([1.0, float("nan")])}))
    assert not bool(debug.check_finite(torch.tensor([float("inf")])))


@pytest.fixture
def nan_sdf(monkeypatch):
    """Training runners whose SDF has one NaN weight."""
    from vdnerf_tpu_torch import runner as runner_mod

    build = runner_mod.build_model

    def with_nan(*args, **kwargs):
        model = build(*args, **kwargs)
        with torch.no_grad():
            next(model.sdf_network_fine.parameters()).view(-1)[0] = float("nan")
        return model

    monkeypatch.setattr(runner_mod, "build_model", with_nan)


def test_injected_nan_raises_under_vdnerf_debug_nans(scene_dir, nan_sdf, monkeypatch):
    from vdnerf_tpu_torch.cli import main
    from vdnerf_tpu_torch.runner import Runner

    conf = _conf(scene_dir, "nans", end_iter=2)
    monkeypatch.setenv(debug.NANS_ENV, "1")
    assert debug.nans_requested()
    with pytest.raises(RuntimeError, match="returned nan values"):
        main(["--conf", conf, "--mode", "train"], device="cpu")
    assert not torch.is_anomaly_enabled()

    # without the mode the step carries the NaN on and raises nothing
    monkeypatch.delenv(debug.NANS_ENV)
    assert not debug.nans_requested()
    runner = Runner(conf, device="cpu", mode="train")
    metrics = runner.trainer.step(runner.nets, runner.store.sample_pixels(0, 16, runner.rng), 0)
    assert not bool(debug.check_finite(metrics))


def test_nan_debugging_restores_the_previous_mode():
    assert not debug.nan_debugging_enabled()
    with debug.nan_debugging():
        assert debug.nan_debugging_enabled()
    assert not debug.nan_debugging_enabled()
    with debug.nan_debugging(False):
        assert not torch.is_anomaly_enabled()


def _trace_names(path: str) -> set[str]:
    with open(path) as f:
        return {e.get("name", "") for e in json.load(f)["traceEvents"]}


def test_profile_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.delenv(debug.PROFILE_ENV, raising=False)
    with debug.profile_trace() as prof:
        assert prof is None
    with debug.profile_trace(str(tmp_path / "t"), name="block.json") as prof:
        assert prof is not None
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert "aten::matmul" in _trace_names(str(tmp_path / "t" / "block.json"))
    monkeypatch.setenv(debug.PROFILE_ENV, str(tmp_path / "env"))
    with debug.profile_trace():
        torch.ones(4).sum()
    assert os.listdir(tmp_path / "env") == ["trace.json"]


@pytest.mark.parametrize("steps_per_call,end_iter,name", [
    (10, 20, "train_steps_11_20.json"),  # the window of steps 11-20 holds 10-15
    (1, 20, "train_steps_11_16.json"),
    (1, 12, "train_steps_11_12.json"),  # the run ends first: the trace ends with it
])
def test_runner_traces_steps_10_to_15_under_vdnerf_profile_dir(scene_dir, tmp_path, monkeypatch,
                                                               steps_per_call, end_iter, name):
    from vdnerf_tpu_torch.runner import Runner

    conf = _conf(scene_dir, f"profile_{steps_per_call}_{end_iter}", end_iter, steps_per_call)
    monkeypatch.setenv(debug.PROFILE_ENV, str(tmp_path))
    Runner(conf, device="cpu", mode="train").train()
    assert os.listdir(tmp_path) == [name]
    # the traced steps' ops: the render's sort and the backward
    names = _trace_names(str(tmp_path / name))
    assert "aten::sort" in names and any("Backward" in n for n in names)
