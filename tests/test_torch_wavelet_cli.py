"""The port's side-car finetune -> predict CLIs against the JAX CLIs, on the CPU.

The chain runs on a 64^2 synthetic scene (the JAX tests'
generator, with an analytic ``depth_from_sdf`` export) from one seeded
checkpoint, at the CLIs' defaults apart from the sizes; the DenseNet-161
entry of both packages' DENSENET_CONFIGS is the small TINY_DENSENET config
for that test, and JAX's ``create_model`` makes its variables from shapes
alone (both CLIs then restore every key from ``-ckpt``; flax's own init
compiles slowly on the CPU). The exported features must agree within 1e-5
relative L2, the checkpoints after 2 and 4 steps within 1e-4. The JAX
finetune step compiles twice (its second call's arguments are the first
call's outputs), about 35 s of this file's time on one core.
"""

from __future__ import annotations

import json
import os

import cv2 as cv
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import (  # noqa: F401
    TINY_DENSENET_CFG,
    jax_create_model_from_shapes,
    jax_wavelet_variables,
    one_torch_thread,
    rel_l2,
)
from vdnerf_tpu.data.synthetic import make_synthetic_scene, render_sphere_image

CASE, HW = "sphere", 64


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("depth_data"))
    d = os.path.join(root, CASE)
    meta = make_synthetic_scene(d, n_images=3, H=HW, W=HW)
    os.makedirs(os.path.join(d, "image", "depth_from_sdf"))
    for i in range(3):
        _, depth = render_sphere_image(meta["poses"][i], meta["K"], HW, HW, meta["radius"])
        np.save(os.path.join(d, "image", "depth_from_sdf", f"sdf_{i:03d}.npy"), depth[..., None])
    return root


@pytest.fixture
def tiny_161(monkeypatch, jax_create_model_from_shapes):
    """DenseNet-161's entry is the tiny config in both packages."""
    from vdnerf_tpu.wavelet import encoders as jax_enc
    from vdnerf_tpu_torch.wavelet import encoders as port_enc

    for table in (jax_enc.DENSENET_CONFIGS, port_enc.DENSENET_CONFIGS):
        monkeypatch.setitem(table, 161, TINY_DENSENET_CFG)


def _losses(logpath):
    with open(os.path.join(logpath, "train", "metrics.jsonl")) as f:
        return [json.loads(line)["loss"] for line in f]


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_finetune_then_predict_match_jax_clis(scene, tiny_161, tmp_path):
    from vdnerf_tpu.wavelet import io as jio
    from vdnerf_tpu.wavelet.finetune import finetune as jax_finetune
    from vdnerf_tpu.wavelet.model import MonodepthModel, WaveletOpts
    from vdnerf_tpu.wavelet.predict import main as jax_predict
    from vdnerf_tpu_torch.wavelet.finetune import finetune
    from vdnerf_tpu_torch.wavelet.predict import main as predict

    init = jax_wavelet_variables(MonodepthModel(WaveletOpts()), jnp.zeros((1, HW, HW, 3)),
                                 seed=0, train=False)
    init_folder = os.path.dirname(jio.save_model(init, str(tmp_path / "init"), 0))
    args = ["-r", scene, "--case", CASE, "--epochs", "2", "--image_size", str(HW), "-bs", "2",
            "-ckpt", init_folder, "--log_every", "1"]
    jlog = jax_finetune(args + ["--logdir", str(tmp_path / "jax")])
    # the port also validates one batch (eval mode: no state changes)
    tlog = finetune(args + ["--logdir", str(tmp_path / "port"), "--val_freq", "3"],
                    device="cpu")

    # 3 views at batch 2: two steps an epoch, every loss logged
    jl, tl = _losses(jlog), _losses(tlog)
    assert len(tl) == len(jl) == 4 and np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for epoch in (0, 1):
        want = _npz(os.path.join(jlog, "models", f"weights_{epoch}", "model.npz"))
        got = _npz(os.path.join(tlog, "models", f"weights_{epoch}", "model.npz"))
        assert set(got) == set(want)
        for k in want:
            assert rel_l2(got[k], want[k]) <= 1e-4, k
    # one validation batch at step 3: its scalars and images
    with open(os.path.join(tlog, "val", "metrics.jsonl")) as f:
        val = [json.loads(line) for line in f]
    assert [r["step"] for r in val] == [3] and "loss/0" in val[0] and "loss_LL3" not in val[0]
    images = os.path.join(tlog, "val", "images")
    assert {"color", "disp_0_gt", "disp_3_pred", "HH_0_pred", "LH_2_gt"} <= set(os.listdir(images))
    assert cv.imread(os.path.join(images, "disp_0_pred", "0", "000003.png")).shape[:2] == (32, 32)

    img_dir = os.path.join(scene, CASE, "image")
    feat_dir = os.path.join(img_dir, "wavelet_feats", "0")
    paths = predict(["-ckpt", os.path.join(tlog, "models", "weights_1"), "-d", img_dir],
                    device="cpu")
    got = {os.path.basename(p): np.load(p) for p in paths}
    jax_predict(["-ckpt", os.path.join(jlog, "models", "weights_1"), "-d", img_dir])
    assert sorted(got) == sorted(os.listdir(feat_dir)) == [f"{i:03d}.npy" for i in range(3)]
    for name, feat in got.items():
        want = np.load(os.path.join(feat_dir, name))
        assert feat.shape == want.shape == (1, 16, HW // 2, HW // 2) and feat.dtype == np.float32
        assert rel_l2(feat, want) <= 1e-5, name
        assert np.abs(feat).max() > 0
