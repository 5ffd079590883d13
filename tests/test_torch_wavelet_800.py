"""``vdnerf_tpu_torch/tools/wavelet_800_run.py``, the counterpart of
``tools/wavelet_800_run.py``, on the CPU.

- The sphere-traced depth teacher (``image/depth_from_sdf``) and the masks
  mirrored into ``mask/`` are array-equal to the JAX tool's at 64^2 on 2
  views (the JAX tool run with its finetune stopped), on the two packages'
  byte-identical compound scenes.
- One epoch at 64^2 with a small DenseNet in DenseNet-161's place
  (``torch_parity.TINY_DENSENET_CFG``) writes the JAX report's keys, with the
  epoch's seconds, images/s and the cuDNN mode beside them.
- Without a card and an explicit CPU it refuses.
"""

from __future__ import annotations

import importlib.util
import os

import cv2 as cv
import numpy as np
import pytest
import torch

from torch_parity import TINY_DENSENET_CFG, one_torch_thread  # noqa: F401
from vdnerf_tpu_torch.data.synthetic import make_compound_scene
from vdnerf_tpu_torch.tools import wavelet_800_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_REPORT_KEYS = {"config", "stages", "loss_first", "loss_last", "n_loss_records",
                   "losses_finite", "iters_per_epoch", "loss_descended", "checkpoint_saved"}


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_wavelet_800_run", os.path.join(ROOT, "tools", "wavelet_800_run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_teacher_and_masks_equal_the_jax_tools(tmp_path, monkeypatch):
    import vdnerf_tpu.wavelet.finetune as jax_finetune

    log = tmp_path / "jax_log"
    log.mkdir()
    monkeypatch.setattr(jax_finetune, "finetune", lambda argv: str(log))
    _jax_tool().main(["--out", str(tmp_path / "jax"), "--views", "2", "--epochs", "1",
                      "--image-size", "64"])
    port = str(tmp_path / "port" / wavelet_800_run.CASE)
    make_compound_scene(port, n_images=2, H=64, W=64, background="textured")
    assert wavelet_800_run.write_teacher(port, 64) == 2
    jax = str(tmp_path / "jax" / wavelet_800_run.CASE)
    for sub, ext in (("image/depth_from_sdf", ".npy"), ("mask", ".png")):
        names = sorted(os.listdir(os.path.join(jax, sub)))
        assert names == sorted(os.listdir(os.path.join(port, sub))) and len(names) == 2
        for name in names:
            a, b = (os.path.join(d, sub, name) for d in (jax, port))
            if ext == ".npy":
                x, y = np.load(a), np.load(b)
                assert x.shape == (32, 32) and (x < 4.0).any()
            else:
                x, y = cv.imread(a, cv.IMREAD_UNCHANGED), cv.imread(b, cv.IMREAD_UNCHANGED)
                assert x.shape == (64, 64, 3)
            np.testing.assert_array_equal(x, y)


def test_one_epoch_cpu_run_writes_the_report(tmp_path, monkeypatch):
    from vdnerf_tpu_torch.wavelet import encoders

    monkeypatch.setitem(encoders.DENSENET_CONFIGS, 161, TINY_DENSENET_CFG)
    copy = tmp_path / "copy.json"
    report = wavelet_800_run.main(["--out", str(tmp_path / "out"), "--views", "2", "--epochs",
                                   "1", "--bs", "2", "--image-size", "64", "--report",
                                   str(copy)], device="cpu")
    assert JAX_REPORT_KEYS <= set(report)
    assert os.path.exists(tmp_path / "out" / "wavelet_800_report.json") and copy.exists()
    assert set(report["stages"]) == {"scene_gen_s", "depth_gt_s", "finetune_s"}
    assert report["n_loss_records"] == 1 and report["losses_finite"] and report["checkpoint_saved"]
    assert len(report["epoch_s"]) == 1 and report["images_per_s"] > 0
    assert set(report["cudnn"]) == {"deterministic", "benchmark"}
    assert report["config"]["image_size"] == 64 and report["config"]["device"] == "cpu"


def test_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        wavelet_800_run.main(["--out", str(tmp_path)])
