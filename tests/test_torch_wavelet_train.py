"""The port's side-car training machinery against vdnerf_tpu.wavelet on the CPU.

The loss, the epoch cosine, one encoder-only finetune step against
``make_finetune_step`` (loss, every metric, the updated encoder parameters
and BatchNorm running statistics, the frozen decoder; 1e-5 relative L2), a
6-step trajectory across two epoch boundaries (1e-4), the batch loaders
from one seed, ``model.npz`` both ways through the two ``load_model``s, and
the CLIs on their own: predict at an image size the JAX CLI cannot take, one
epoch of NYU pretraining (``mobilenet_light``), and the card requirement.
The model is the TINY_DENSENET encoder with the wavelet decoder at 64^2, at
lr 1e-4, the pretrain CLI's default (finetune's is 1e-5). At 1e-3 the
trajectory's stem BatchNorm scale parts by 2.1e-4 after 6 steps: Adam moves
every element by about the lr whatever the size of its gradient, so an
element whose gradient is at f32 noise level moves by noise.
"""

from __future__ import annotations

import functools
import io
import json
import os
import zipfile

import cv2 as cv
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (  # noqa: F401
    jax_create_model_from_shapes,
    jax_wavelet_variables,
    nchw,
    nhwc,
    one_torch_thread,
    rel_l2,
    tiny_densenet,
)
from vdnerf_tpu.wavelet import data as jdata
from vdnerf_tpu.wavelet import io as jio
from vdnerf_tpu.wavelet import train_lib as jtl
from vdnerf_tpu.wavelet.model import MonodepthModel as JaxModel
from vdnerf_tpu.wavelet.model import WaveletOpts as JaxOpts
from vdnerf_tpu_torch.wavelet import data as tdata
from vdnerf_tpu_torch.wavelet import io as tio
from vdnerf_tpu_torch.wavelet import train_lib as ttl
from vdnerf_tpu_torch.wavelet.model import WaveletOpts, create_model

HW = 64
LR = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup(tiny_densenet):
    """The flax model, seeded variables and the compiled JAX finetune step
    (compiled once for the module)."""
    jm = JaxModel(JaxOpts(num_layers=tiny_densenet))
    variables = jax_wavelet_variables(jm, jnp.zeros((1, HW, HW, 3)), seed=0, train=False)
    init_opt, step_fn = jtl.make_finetune_step(jm, LR, encoder_only=True)
    return {"jm": jm, "variables": variables, "init_opt": init_opt, "step_fn": step_fn,
            "opts": WaveletOpts(num_layers=tiny_densenet)}


def _port(setup, variables=None):
    tm = create_model(setup["opts"], "cpu")
    tm.load_state_dict(tio.from_jax_variables(variables or setup["variables"]))
    return tm


def _batch(seed, n=2):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(size=(n, HW, HW, 3)).astype(np.float32),
            "depth": rng.uniform(0, 200, size=(n, HW // 2, HW // 2, 1)).astype(np.float32),
            "mask": (rng.uniform(size=(n, HW // 2, HW // 2, 1)) > 0.3).astype(np.float32)}


def _port_batch(batch):
    return {k: torch.from_numpy(nchw(v).copy()) for k, v in batch.items()}


def _hold_state(tm, variables, tol, what):
    """Every port tensor against the JAX variables, relative L2."""
    want = tio.from_jax_variables(_np_tree(variables))
    state = tm.state_dict()
    assert set(want) == set(state)
    worst = max((rel_l2(state[k], v), k) for k, v in want.items())
    assert worst[0] <= tol, (what, worst)


# --- the loss and the schedule ------------------------------------------------


@pytest.mark.parametrize("with_ll", [False, True])
def test_multiscale_depth_loss(with_ll):
    rng = np.random.default_rng(3)
    outs = {("disp", s): rng.normal(size=(2, 32 >> s, 32 >> s, 1)).astype(np.float32) * 50
            for s in range(4)}
    if with_ll:
        outs[("wavelets", 3, "LL")] = rng.normal(size=(2, 2, 2, 1)).astype(np.float32) * 800
    b = _batch(4)
    depth_n = b["depth"] * b["mask"]
    total, metrics = jtl.multiscale_depth_loss(
        {k: jnp.asarray(v) for k, v in outs.items()}, jnp.asarray(depth_n), jnp.asarray(b["mask"]))
    ttotal, tmetrics = ttl.multiscale_depth_loss(
        {k: torch.from_numpy(nchw(v).copy()) for k, v in outs.items()},
        torch.from_numpy(nchw(depth_n).copy()), torch.from_numpy(nchw(b["mask"]).copy()))
    assert set(tmetrics) == set(metrics) and ("loss_LL3" in metrics) == with_ll
    for k in metrics:
        np.testing.assert_allclose(float(tmetrics[k]), float(metrics[k]), rtol=1e-5)
    np.testing.assert_allclose(float(ttotal), float(total), rtol=1e-5)


def test_resize_matches_the_align_corners_gather():
    x = np.random.default_rng(5).normal(size=(2, 5, 7, 3)).astype(np.float32)
    want = jtl.resize_bilinear_align_corners(jnp.asarray(x), 20, 13)
    got = ttl.resize_bilinear_align_corners(torch.from_numpy(nchw(x).copy()), 20, 13)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-5)


@pytest.mark.parametrize("scale", [1, 2, 3])
def test_resize_as_two_products_matches_f64_interpolate(scale):
    """The resize runs as two products with the interpolation weights (a
    backward without atomics on the card), at the finetune's shapes: a
    disparity scale of a 400^2 target resized to it. Against torch's own
    align-corners interpolate in f64, forward and backward (the cotangent's
    VJP) within 1e-6; interpolate in f32 is 1e-6 to 2e-5 off, its weights
    being computed in f32."""
    gen = torch.Generator().manual_seed(7 + scale)
    x = torch.rand(2, 1, 400 >> scale, 400 >> scale, generator=gen, dtype=torch.float64)
    g = torch.rand(2, 1, 400, 400, generator=gen, dtype=torch.float64)

    def value_and_vjp(fn, t):
        t = t.clone().requires_grad_(True)
        y = fn(t)
        (gx,) = torch.autograd.grad(y, t, g.to(t.dtype))
        return y.double(), gx.double()

    want = value_and_vjp(lambda t: torch.nn.functional.interpolate(
        t, (400, 400), mode="bilinear", align_corners=True), x)
    got = value_and_vjp(lambda t: ttl.resize_bilinear_align_corners(t, 400, 400), x.float())
    assert float((got[0] - want[0]).abs().max()) <= 1e-6
    assert float((got[1] - want[1]).abs().max()) <= 1e-6 * float(want[1].abs().max())


@pytest.mark.parametrize("epochs,warmup", [(100, 0), (3, 0), (20, 4), (1, 0)])
def test_cosine_epoch_lr(epochs, warmup):
    want = jtl.cosine_epoch_lr(1e-4, epochs, warmup=warmup)
    got = ttl.cosine_epoch_lr(1e-4, epochs, warmup=warmup)
    for e in range(epochs + 1):
        np.testing.assert_allclose(got(e), float(want(e)), rtol=1e-6)


# --- the finetune step --------------------------------------------------------


def test_one_finetune_step(setup):
    variables = setup["variables"]
    batch = _batch(0)
    new_vars, _, metrics = setup["step_fn"](variables, setup["init_opt"](variables), batch, LR)

    tm = _port(setup)
    step = ttl.make_finetune_step(tm, LR, encoder_only=True)
    tmetrics = step(_port_batch(batch), LR)

    assert set(tmetrics) == set(metrics)
    for k in metrics:
        assert rel_l2(float(tmetrics[k]), float(metrics[k])) <= 1e-5, k
    # the encoder moved, its running statistics moved, the decoder did not
    state = tm.state_dict()
    before = tio.from_jax_variables(variables)
    for k, v in tio.from_jax_variables(_np_tree(new_vars)).items():
        assert rel_l2(state[k], v) <= 1e-5, k
        if k.startswith("decoder."):
            assert torch.equal(state[k], before[k]), k
    moved = {k for k in state if not torch.equal(state[k], before[k])}
    assert any(k.endswith("weight") for k in moved)
    assert any(k.endswith("running_var") for k in moved)
    assert all(k.startswith("encoder.") for k in moved)


def test_trajectory_across_epochs(setup):
    """Three epochs of two steps through each package's BatchLoader (with its
    augmentations) and epoch cosine: losses and every tensor within 1e-4."""
    rng = np.random.default_rng(7)
    samples = [{"filename": f"{i}.png", "image": rng.uniform(size=(48, 56, 3)).astype(np.float32),
                "depth": rng.uniform(0, 200, size=(48, 56)).astype(np.float32),
                "mask": (rng.uniform(size=(48, 56)) > 0.2).astype(np.float32)}
               for i in range(4)]
    kw = dict(batch_size=2, seed=0, image_size=HW, depth_size=HW // 2, augment=True)
    jloader, tloader = jdata.BatchLoader(samples, **kw), tdata.BatchLoader(samples, **kw)
    epochs = 3
    jlr, tlr = jtl.cosine_epoch_lr(LR, epochs), ttl.cosine_epoch_lr(LR, epochs)

    variables = setup["variables"]
    opt_state = setup["init_opt"](variables)
    tm = _port(setup)
    step = ttl.make_finetune_step(tm, LR, encoder_only=True)
    losses = []
    for epoch in range(epochs):
        for jb, tb in zip(jloader, tloader):
            variables, opt_state, metrics = setup["step_fn"](variables, opt_state, jb,
                                                             float(jlr(epoch)))
            tmetrics = step({k: torch.from_numpy(v) for k, v in tb.items()}, tlr(epoch))
            losses.append((float(tmetrics["loss"]), float(metrics["loss"])))
    assert len(losses) == 6
    for got, want in losses:
        assert rel_l2(got, want) <= 1e-4, losses
    _hold_state(tm, variables, 1e-4, "after 6 steps")


def test_batch_loader_matches_jax(tmp_path):
    """NeusDataset and BatchLoader are copies: the same batches from one seed
    (NCHW in the port), augmentations included, over two epochs."""
    from vdnerf_tpu.data.synthetic import make_synthetic_scene, render_sphere_image

    d = str(tmp_path)
    meta = make_synthetic_scene(d, n_images=3, H=48, W=40)
    os.makedirs(os.path.join(d, "image", "depth_from_sdf"))
    for i in range(3):
        _, depth = render_sphere_image(meta["poses"][i], meta["K"], 48, 40, meta["radius"])
        np.save(os.path.join(d, "image", "depth_from_sdf", f"sdf_{i:03d}.npy"), depth[..., None])
    jtrain, jtest = jdata.get_neus_train_test_data(d, batch_size=2, image_size=32)
    ttrain, ttest = tdata.get_neus_train_test_data(d, batch_size=2, image_size=32)
    n = 0
    for jl, tl in ((jtrain, ttrain), (jtest, ttest)):
        for _ in range(2):
            for jb, tb in zip(jl, tl, strict=True):
                for k in ("image", "depth", "mask"):
                    np.testing.assert_array_equal(tb[k], nchw(jb[k]))
                    assert tb[k].dtype == np.float32 and tb[k].flags.c_contiguous
                n += 1
    assert n == 8


# --- checkpoints --------------------------------------------------------------


def _jax_taps(setup, variables, x):
    jm = setup["jm"]
    return jax.jit(functools.partial(jm.apply, train=False, method=jm.encode))(variables, x)


def test_model_npz_both_ways(setup, tmp_path):
    x = np.random.default_rng(9).uniform(size=(1, HW, HW, 3)).astype(np.float32)
    tx = torch.from_numpy(nchw(x).copy())

    # a port checkpoint into the unmodified JAX load_model
    port = _port(setup, jax_wavelet_variables(setup["jm"], jnp.zeros((1, HW, HW, 3)), seed=11,
                                              train=False))
    path = tio.save_model(port, str(tmp_path / "port"), 3)
    assert path.endswith(os.path.join("models", "weights_3", "model.npz"))
    with np.load(path) as z:
        assert set(z.files) == set(jio._flatten(setup["variables"]))
    restored = jio.load_model(setup["variables"], path)
    with torch.no_grad():
        want = port.encode(tx)
    for g, w in zip(want, _jax_taps(setup, restored, x)):
        assert rel_l2(nhwc(g), w) <= 1e-5

    # a JAX checkpoint into the port's load_model
    jvars = jax_wavelet_variables(setup["jm"], jnp.zeros((1, HW, HW, 3)), seed=12, train=False)
    folder = os.path.dirname(jio.save_model(jvars, str(tmp_path / "jax"), 0))
    fresh = create_model(setup["opts"], "cpu")
    tio.load_model_from_folder(fresh, folder)
    with torch.no_grad():
        got = fresh.encode(tx)
    for g, w in zip(got, _jax_taps(setup, jvars, x)):
        assert rel_l2(nhwc(g), w) <= 1e-5
    _hold_state(fresh, jvars, 0.0, "restored")


def test_load_model_is_a_tolerant_partial_restore(setup, tmp_path):
    """Keys missing from the checkpoint or of another shape keep the model's
    values; the rest are restored (reference load_save_utils.py:37-44)."""
    flat = jio._flatten(setup["variables"])
    kernel = "params/encoder/conv0/kernel"
    dropped = "params/decoder/wave3/Conv_0/bias"
    flat[kernel] = np.zeros((7, 7, 3, 5), np.float32)  # another shape
    del flat[dropped]
    path = str(tmp_path / "partial.npz")
    np.savez(path, **flat)
    tm = create_model(setup["opts"], "cpu", torch.Generator().manual_seed(3))
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    tio.load_model(tm, path)
    state = tm.state_dict()
    want = tio.from_jax_variables(setup["variables"])
    for k in state:
        if k in ("encoder.features.conv0.weight", "decoder.wave3.bias"):
            assert torch.equal(state[k], before[k]), k
        else:
            assert torch.equal(state[k], want[k]), k


# --- the CLIs (port only: tests/test_torch_wavelet_cli.py holds them against JAX's)


def _write_rgba(folder, h, w, n=2, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    for i in range(n):
        img = rng.integers(0, 256, size=(h, w, 4), dtype=np.uint8)
        cv.imwrite(os.path.join(folder, f"{i:03d}.png"), img)


def test_predict_at_any_size(jax_create_model_from_shapes, tmp_path):
    """40 x 56 is not a multiple of 32: the JAX CLI's whole-model build
    fails there, the port's encoder-only predict gives its encoder's taps."""
    from vdnerf_tpu.wavelet.predict import main as jax_predict
    from vdnerf_tpu_torch.wavelet.io import save_model
    from vdnerf_tpu_torch.wavelet.model import WaveletOpts, create_model
    from vdnerf_tpu_torch.wavelet.predict import main as predict

    model = create_model(WaveletOpts(encoder_type="mobilenet_light"), "cpu")
    folder = os.path.dirname(save_model(model, str(tmp_path), 0))
    img_dir = str(tmp_path / "image")
    _write_rgba(img_dir, 40, 56)
    base = ["-ckpt", folder, "-d", img_dir, "--encoder_type", "mobilenet_light"]
    for extra, scale in (([], 1), (["-full", "--save_vis"], 2)):
        paths = predict(base + extra, device="cpu")
        assert len(paths) == 2
        for p in paths:
            pic = cv.imread(os.path.join(img_dir, os.path.basename(p)[:-4] + ".png"), -1)
            if scale == 2:
                pic = cv.resize(pic, (0, 0), fx=2, fy=2)
            a = pic[..., 3:] / 255.0
            x = ((pic[..., :3] * a + (1.0 - a) * 255).astype(np.float32) / 255.0)
            with torch.no_grad():
                want = model.encode(torch.from_numpy(x.transpose(2, 0, 1).copy())[None])[0]
            feat = np.load(p)
            assert feat.shape == (1, 32, 20 * scale, 28 * scale)
            np.testing.assert_array_equal(feat, want.numpy())
    vis = cv.imread(os.path.join(img_dir, "wavelet_feats_full", "000_vis.png"))
    assert vis.shape == (40, 56, 3)
    with pytest.raises(TypeError):
        jax_predict(base)


@pytest.fixture
def nyu_zip(tmp_path):
    """A DenseDepth-layout zip of 5 pairs and no test list (as
    tests/test_nyu_data.py builds one)."""
    from PIL import Image

    path = str(tmp_path / "nyu_data.zip")
    rng = np.random.default_rng(0)
    with zipfile.ZipFile(path, "w") as zf:
        rows = []
        for i in range(5):
            img = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
            depth = rng.integers(1, 255, (24, 32), dtype=np.uint8)
            ib, db = io.BytesIO(), io.BytesIO()
            Image.fromarray(img).save(ib, format="PNG")
            Image.fromarray(depth).save(db, format="PNG")
            zf.writestr(f"data/img_{i}.png", ib.getvalue())
            zf.writestr(f"data/depth_{i}.png", db.getvalue())
            rows.append(f"data/img_{i}.png,data/depth_{i}.png")
        zf.writestr("data/nyu2_train.csv", "\n".join(rows))
    return path


def test_pretrain_one_epoch(nyu_zip, tmp_path):
    from vdnerf_tpu.wavelet.io import _flatten
    from vdnerf_tpu.wavelet.model import MonodepthModel, WaveletOpts
    from vdnerf_tpu_torch.wavelet.pretrain import pretrain

    logpath = pretrain(["--nyu_zip", nyu_zip, "--epochs", "1", "-bs", "2", "--image_size", "64",
                        "--encoder_type", "mobilenet_light", "--val_freq", "1",
                        "--log_histogram", "--logdir", str(tmp_path)], device="cpu")
    # no test list: one of the 5 pairs held out, two steps over the other 4,
    # each followed by a validation on the held-out pair
    with open(os.path.join(logpath, "val", "metrics.jsonl")) as f:
        val = [json.loads(line) for line in f]
    assert [r["step"] for r in val] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in val) and val[0]["loss"] != val[1]["loss"]
    with open(os.path.join(logpath, "val", "histograms.jsonl")) as f:
        hist = [json.loads(line) for line in f]
    assert {h["tag"] for h in hist} >= {"hist_HH_0_pred/0", "hist_LH_2_gt/0"}
    assert sum(hist[0]["counts"]) > 0
    ckpt = os.path.join(logpath, "models", "weights_0", "model.npz")
    shapes = jax.eval_shape(
        lambda x: MonodepthModel(WaveletOpts(encoder_type="mobilenet_light")).init(
            jax.random.PRNGKey(0), x), jnp.zeros((1, 64, 64, 3)))
    with np.load(ckpt) as z:
        assert set(z.files) == set(_flatten(shapes))
        assert all(np.isfinite(z[k]).all() for k in z.files)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_to_run_without_cuda(no_cuda, nyu_zip, tmp_path):
    from vdnerf_tpu_torch.wavelet.finetune import finetune
    from vdnerf_tpu_torch.wavelet.predict import main as predict
    from vdnerf_tpu_torch.wavelet.pretrain import pretrain

    log = str(tmp_path / "log")
    for call in (lambda: finetune(["-r", str(tmp_path), "--case", "none", "--logdir", log]),
                 lambda: predict(["-ckpt", log, "-d", str(tmp_path)]),
                 lambda: pretrain(["--nyu_zip", nyu_zip, "--logdir", log])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not os.path.exists(log)
