"""The side-car's CLIs and cuDNN's determinism, on the CPU.

``wavelet.finetune`` and ``wavelet.predict`` let cuDNN benchmark its f32
algorithms unless the caller set ``torch.backends.cudnn.deterministic``; then
both leave benchmarking off, so that the finetune step and the exported
features repeat bit for bit on a seed (the VDN cycle tool sets it for both
stages: ``tests/test_torch_vdn_cycle_runs.py``). Each CLI is stopped right
after it has chosen, before it reads any data.
"""

from __future__ import annotations

import pytest
import torch

from vdnerf_tpu_torch.wavelet import finetune, predict


class _Stop(Exception):
    pass


def _stop(*_a, **_k):
    raise _Stop


@pytest.fixture
def cudnn_flags():
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    yield
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev


def _run_until_chosen(monkeypatch, tmp_path, cli):
    if cli == "predict":
        monkeypatch.setattr(predict, "WaveletOpts", _stop)
        argv = ["-ckpt", str(tmp_path), "-d", str(tmp_path)]
        run = predict.main
    else:
        monkeypatch.setattr(finetune, "save_opts", _stop)
        argv = ["-r", str(tmp_path), "--case", "c", "--logdir", str(tmp_path)]
        run = finetune.finetune
    with pytest.raises(_Stop):
        run(argv, device="cpu")


@pytest.mark.parametrize("cli", ["predict", "finetune"])
@pytest.mark.parametrize("deterministic", [True, False])
def test_side_car_benchmarks_cudnn_only_when_not_deterministic(
        monkeypatch, tmp_path, cudnn_flags, cli, deterministic):
    torch.backends.cudnn.deterministic = deterministic
    torch.backends.cudnn.benchmark = deterministic  # the opposite of what it must choose
    _run_until_chosen(monkeypatch, tmp_path, cli)
    assert torch.backends.cudnn.benchmark is (not deterministic)
    assert torch.backends.cudnn.deterministic is deterministic
