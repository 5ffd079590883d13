"""The port's CLI against vdnerf_tpu's on one scene and one checkpoint.

A synthetic sphere scene (``make_synthetic_scene``) and a conf with the
``womsk_white_tpu`` renderer features (``skip_bg_inside`` and the 24-of-48
resampled core at ``resample_uniform_frac=1.0``) at small widths. The JAX
runner writes ``ckpt_000000.npz``; both CLIs then run ``valimg_0`` and
``getfeats_0`` from it, the port with ``device="cpu"``.

Both sides run their fused-MLP matmul operands in f32 (the JAX default path
has no fused kernels). PSNR within 0.01 dB and L1 within 1e-4; the exported
depth ``.npy`` files agree within 1e-4 on at least 99% of the pixels (an
argmax between near-equal weights may flip, as in test_torch_render).
"""

from __future__ import annotations

import ast
import os
import re

import numpy as np
import pytest

from torch_parity import f32_matmuls  # noqa: F401
from vdnerf_tpu.data.synthetic import make_synthetic_scene, write_synthetic_conf

N_IMAGES, H, W = 2, 32, 40


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from vdnerf_tpu.runner import Runner

    d = str(tmp_path_factory.mktemp("torch_cli"))
    make_synthetic_scene(d, n_images=N_IMAGES, H=H, W=W)
    conf = os.path.join(d, "synthetic.conf")
    write_synthetic_conf(conf, data_dir=d, exp_dir=os.path.join(d, "exp"), batch_size=64)
    with open(conf) as f:
        text = f.read()
    text, n_sub = re.subn(
        r"(perturb = 1\.0)",
        r"\1\n        skip_bg_inside = True\n        n_render_samples = 24"
        r"\n        resample_uniform_frac = 1.0",
        text,
    )
    assert n_sub == 1, "conf template changed; renderer keys not injected"
    with open(conf, "w") as f:
        f.write(text)
    Runner(conf, mode="valimg_0", seed=3).save_checkpoint()
    assert os.path.exists(os.path.join(d, "exp", "checkpoints", "ckpt_000000.npz"))
    return d, conf


def _jax_cli(argv, capsys) -> dict:
    from vdnerf_tpu.cli import main

    capsys.readouterr()
    main(argv)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    return ast.literal_eval(lines[-1])


def _depths(d) -> dict[str, np.ndarray]:
    feats = os.path.join(d, "image", "depth_from_sdf")
    return {f: np.load(os.path.join(feats, f)) for f in sorted(os.listdir(feats))}


def test_valimg_and_getfeats_match_jax_cli(scene, f32_matmuls, capsys):
    from vdnerf_tpu_torch.cli import main as port_main

    d, conf = scene
    argv = ["--conf", conf, "--mode", "valimg_0"]
    want = _jax_cli(argv, capsys)
    got = port_main(argv, device="cpu")
    assert set(got) == set(want)
    for key in ("psnr", "psnr_unmasked"):
        assert abs(got[key] - want[key]) <= 0.01, (key, got[key], want[key])
    for key in ("l1", "l1_unmasked"):
        assert abs(got[key] - want[key]) <= 1e-4, (key, got[key], want[key])
    assert abs(got["gradient_error"] - want["gradient_error"]) <= 1e-4

    argv = ["--conf", conf, "--mode", "getfeats_0"]
    _jax_cli(argv, capsys)
    want_depth = _depths(d)
    port_main(argv, device="cpu")
    got_depth = _depths(d)
    assert sorted(got_depth) == [f"sdf_{i:03d}.npy" for i in range(N_IMAGES)]
    for name, w in want_depth.items():
        g = got_depth[name]
        assert g.shape == w.shape == (H, W, 1)
        assert np.isfinite(g).all()
        agree = np.abs(g - w) <= 1e-4
        assert agree.mean() >= 0.99, f"{name}: depth agrees on {agree.mean():.4f} of pixels"
    assert os.listdir(os.path.join(d, "exp", "weight_max"))


@pytest.mark.parametrize("mode", ["bogus_1", "interpolate_0", "interpolate_a_b", "valimg"])
def test_unknown_mode_exits_with_message(mode):
    """Every JAX mode is ported; a mode the JAX CLI does not know, or one
    without its numbers, exits with JAX's message before a conf is read."""
    from vdnerf_tpu_torch.cli import main as port_main

    with pytest.raises(SystemExit, match=f"unknown mode: {mode}$"):
        port_main(["--mode", mode], device="cpu")
