"""The VDN cycle's first distillation loss, factor by factor, in both packages.

Every wdepth leg of the cycle logs its first ``depth_loss`` before the depth
term is on (``depth_start_iter``): the L1 over 96 channels between the
initial composite of the depth features (``render_feats``: the depth head's
sigmoid features inside the sphere, the background NeRF's dpt head outside)
and the side-car's features, z-scored globally and squashed
(``data/rays.py``). The port's records read 33.90-35.43, JAX's 22.91-26.49
(``docs/VDN_CYCLE*``). This file computes each factor from each package's own
seeded initialisation, ``N_SEEDS`` seeds a package, on the same inputs:

- (a) the depth head at full width (289 -> 256 x 4 -> 96, ``squeeze_out``)
  on the same inputs, and the composite ``render_feats`` of the cycle's
  wdepth conf at full width on the same rays (each package's ``init_params``
  / ``build_model`` for the seed, as its runner draws a leg's networks);
- (b) the side-car's exported tap (DenseNet-161's ``relu0``, 96 channels at
  H/2) in eval mode on the synthetic scene's views: at init (flax's own
  initialisers for the JAX stem, ``init_flax_`` for the port), and after
  ``FT_STEPS`` encoder-only finetune steps of each package's step on the
  same images and depths (a small DenseNet from one seeded variable tree);
- (c) the feature file -> batch path (the global z-score, the sigmoid, the
  bilinear upsample, the f16 store) on one 96-channel feature set;
- (d) the arguments each cycle tool hands to the finetune and predict CLIs,
  as each package's CLI parses them, and which checkpoint predict loads;
- (e) the swap: the loss of each package's composite against each
  package's features.

Tolerances: a factor agrees when the two packages' means over their seeds
differ by at most 3 standard errors of that difference (SE from the two
seed samples); the finetune steps from one variable tree agree within 1e-4
relative L2 (``tests/test_torch_wavelet_train.py``'s trajectory tolerance);
the store is byte-identical; the arguments equal.

The finding (ROADMAP §3): every factor agrees, and the first loss is set by
the draw of a leg's networks. The composite's mean over channels ranges
over about 0.12-0.25 from seed to seed in either package (the background
NeRF's dpt head, a linear layer, fills most of an untrained ray), and the
loss with it. The port's and JAX's seed-0 draws fall at the two ends of that
range, and every record of a package repeats its seed-0 draw of the leg's
networks (the seed-1 legs read 33.90 and 26.49). Run with ``-s`` for the
numbers.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import os

import cv2 as cv
import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import TINY_DENSENET, jax_wavelet_variables, nchw, nhwc, one_torch_thread, rel_l2, rays, tiny_densenet  # noqa: F401
from torch_vdn_cycle import jax_tool
from vdnerf_tpu.data.dataset import SceneData as JSceneData
from vdnerf_tpu.data.dataset import near_far_from_sphere
from vdnerf_tpu.data.rays import RayStore as JRayStore
from vdnerf_tpu.models.fields import render_net_apply
from vdnerf_tpu.ops.renderer import render as jax_render
from vdnerf_tpu.train import builder as jbuilder
from vdnerf_tpu.utils.hocon import parse_string as jax_parse
from vdnerf_tpu.wavelet import finetune as jax_finetune
from vdnerf_tpu.wavelet import train_lib as jtl
from vdnerf_tpu.wavelet.model import MonodepthModel as JaxModel
from vdnerf_tpu.wavelet.model import WaveletOpts as JaxOpts
from vdnerf_tpu_torch.data.dataset import SceneData as TSceneData
from vdnerf_tpu_torch.data.rays import RayStore as TRayStore
from vdnerf_tpu_torch.data.synthetic import make_synthetic_scene, write_synthetic_conf
from vdnerf_tpu_torch.ops.renderer import render as port_render
from vdnerf_tpu_torch.tools import vdn_cycle_run as port_tool
from vdnerf_tpu_torch.train import builder as pbuilder
from vdnerf_tpu_torch.utils.hocon import load_conf as port_load_conf
from vdnerf_tpu_torch.utils.hocon import parse_string as port_parse
from vdnerf_tpu_torch.wavelet import finetune as port_finetune
from vdnerf_tpu_torch.wavelet import io as tio
from vdnerf_tpu_torch.wavelet import train_lib as ttl
from vdnerf_tpu_torch.wavelet.model import WaveletOpts, create_model

N_SEEDS = 4
N_RAYS = 128
N_VIEWS, RES = 8, 64
FT_STEPS, FT_HW, FT_LR = 3, 32, 1e-5
F32 = torch.float32


def _agree(jax_vals, port_vals, what: str, k: float = 3.0) -> float:
    """Both packages' seed means within k standard errors -> the gap in SEs."""
    j, p = np.asarray(jax_vals, np.float64), np.asarray(port_vals, np.float64)
    se = np.sqrt(j.var(ddof=1) / len(j) + p.var(ddof=1) / len(p))
    gap = abs(j.mean() - p.mean()) / max(se, 1e-12)
    print(f"\n{what}: JAX {np.round(j, 4).tolist()} (mean {j.mean():.4f}), port "
          f"{np.round(p, 4).tolist()} (mean {p.mean():.4f}): {gap:.2f} SE")
    assert gap <= k, (what, gap)
    return gap


@pytest.fixture(scope="module")
def cycle_conf(tmp_path_factory):
    """The cycle's wdepth leg conf (the tools' shared text) at full width."""
    d = tmp_path_factory.mktemp("cycle_gap")
    path = str(d / "wdepth.conf")
    port_tool.write_conf_file(path, str(d / "exp"), str(d / "scene"), 12000, 512, True,
                              depth_weight_scale=10.0)
    text = open(path).read()
    jconf, pconf = jax_parse(text), port_parse(text)
    return (jconf, jbuilder.build_networks(jconf, extract_depth=True),
            pconf, pbuilder.build_networks(pconf, extract_depth=True))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The synthetic scene's views (both packages' generator writes the same
    bytes), as the side-car reads them: [N_VIEWS, RES, RES, 3] in [0, 1]."""
    d = str(tmp_path_factory.mktemp("cycle_gap_scene"))
    make_synthetic_scene(d, n_images=N_VIEWS, H=RES, W=RES)
    img_dir = os.path.join(d, "image")
    views = [cv.imread(os.path.join(img_dir, f), -1)
             for f in sorted(os.listdir(img_dir)) if f.endswith(".png")]
    return {"dir": d, "images": np.stack([v[..., :3] for v in views]).astype(np.float32) / 255.0}


def _jax_params(jconf, jnets, seed):
    k_params, _ = jax.random.split(jax.random.PRNGKey(seed))  # as the JAX runner splits
    return jbuilder.init_params(k_params, jnets, jconf.get_float("model.variance_network.init_val"))


def _port_model(pconf, pnets, seed):
    return pbuilder.build_model(pconf, pnets, seed=seed, mlp_dtype=F32)


# ---------------------------------------------------------------------------
# (a) the depth head, and the composite the loss reads
# ---------------------------------------------------------------------------


def test_depth_head_initial_output_agrees_across_seeds(cycle_conf):
    jconf, jnets, pconf, pnets = cycle_conf
    rng = np.random.default_rng(0)
    n = 512
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    unit = lambda a: (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)  # noqa: E731
    nrm, dirs = unit(rng.normal(size=(n, 3))), unit(rng.normal(size=(n, 3)))
    feat = rng.normal(size=(n, 256)).astype(np.float32)
    stats = {"jax": [], "port": []}
    for s in range(N_SEEDS):
        jp = _jax_params(jconf, jnets, s)["depth"]
        out_j = np.asarray(render_net_apply(jnets.depth, jp, *map(jnp.asarray, (pts, nrm, dirs, feat))))
        head = _port_model(pconf, pnets, s).depth_network_fine
        assert head.cfg.dims == (289, 256, 256, 256, 256, 96)
        with torch.no_grad():
            out_p = head(*map(torch.from_numpy, (pts, nrm, dirs, feat))).numpy()
        for k, out in (("jax", out_j), ("port", out_p)):
            stats[k].append((out.mean(0).mean(), out.std(0).mean()))
    for i, what in enumerate(("per-channel mean", "per-channel std")):
        _agree([v[i] for v in stats["jax"]], [v[i] for v in stats["port"]],
               f"(a) depth head at init, {what}")


@pytest.fixture(scope="module")
def composites(cycle_conf):
    """Each package's initial render_feats [N_RAYS, 96] per seed, on the same
    deterministic rays."""
    jconf, jnets, pconf, pnets = cycle_conf
    o, d = rays(N_RAYS, seed=5)
    near, far = near_far_from_sphere(jnp.asarray(o), jnp.asarray(d))

    @jax.jit
    def go(params):
        return jax_render(jnets, params, jnp.asarray(o), jnp.asarray(d), near, far,
                          perturb_overwrite=0, background_rgb=jnp.ones((1, 3)))["render_feats"]

    out = {"jax": [], "port": []}
    for s in range(N_SEEDS):
        out["jax"].append(np.asarray(go(_jax_params(jconf, jnets, s))))
        with torch.no_grad():
            r = port_render(pnets, _port_model(pconf, pnets, s), torch.from_numpy(o),
                            torch.from_numpy(d), torch.from_numpy(np.asarray(near)),
                            torch.from_numpy(np.asarray(far)), perturb_overwrite=0,
                            background_rgb=torch.ones(1, 3))
        out["port"].append(r["render_feats"].numpy())
    return out


def test_initial_composite_agrees_across_seeds(composites):
    means = {k: [float(v.mean()) for v in vals] for k, vals in composites.items()}
    _agree(means["jax"], means["port"], "(a) render_feats at init, mean")
    _agree([float(v.std()) for v in composites["jax"]],
           [float(v.std()) for v in composites["port"]], "(a) render_feats at init, std")
    # the draw moves the composite's mean by far more than 3 SE of the gap
    spread = max(max(v) - min(v) for v in means.values())
    assert spread > 0.05, spread


# ---------------------------------------------------------------------------
# (b) the side-car's exported tap
# ---------------------------------------------------------------------------


class _JaxStem(flax_nn.Module):
    """The JAX DenseEncoder's stem (conv0, norm0, relu0) under the same scope
    names, so that flax's initialisers draw its kernel as in the model."""

    @flax_nn.compact
    def __call__(self, x):
        x = flax_nn.Conv(96, (7, 7), strides=(2, 2), padding=3, use_bias=False, name="conv0")(x)
        x = flax_nn.BatchNorm(use_running_average=True, name="norm0")(x)
        return flax_nn.relu(x)


class _JaxRoot(flax_nn.Module):
    def setup(self):
        self.encoder = _JaxStem()

    def __call__(self, x):
        return self.encoder(x)


@pytest.fixture(scope="module")
def taps(scene):
    """The relu0 tap [N_VIEWS, 96, RES/2, RES/2] of each package's seeded
    DenseNet-161 stem in eval mode."""
    x = scene["images"]
    init = jax.jit(lambda key: _JaxRoot().init(key, jnp.asarray(x[:1])))
    apply = jax.jit(lambda v: _JaxRoot().apply(v, jnp.asarray(x)))
    out = {"jax": [], "port": []}
    for s in range(N_SEEDS):
        out["jax"].append(nchw(apply(init(jax.random.PRNGKey(s)))))
        model = create_model(WaveletOpts(), "cpu", torch.Generator().manual_seed(s))
        with torch.no_grad():
            out["port"].append(model.encode(torch.from_numpy(nchw(x)))[0].numpy())
    return out


def _targets(tap):
    """The batch's features as the store computes them (without the resize):
    sigmoid of the globally z-scored tap, [N_VIEWS * h * w, 96]."""
    z = (tap - float(np.mean(tap))) / float(np.std(tap))
    return (1.0 / (1.0 + np.exp(-z))).transpose(0, 2, 3, 1).reshape(-1, tap.shape[1])


def test_side_car_tap_at_init_agrees_across_seeds(taps):
    assert taps["port"][0].shape == (N_VIEWS, 96, RES // 2, RES // 2) == taps["jax"][0].shape
    for what, f in (("mean", np.mean), ("std", np.std),
                    ("zero share", lambda t: np.mean(t == 0.0)),
                    ("target mean", lambda t: _targets(t).mean()),
                    ("target std", lambda t: _targets(t).std())):
        _agree([f(t) for t in taps["jax"]], [f(t) for t in taps["port"]], f"(b) relu0 tap, {what}")


def test_side_car_finetune_moves_the_tap_alike(tiny_densenet):
    """FT_STEPS encoder-only steps of each package's finetune step from one
    seeded variable tree, on the same images and depths: the taps in eval
    mode agree after each step, and the steps move the tap by little against
    its spread between stem draws (tested above)."""
    jm = JaxModel(JaxOpts(num_layers=tiny_densenet))
    variables = jax_wavelet_variables(jm, jnp.zeros((1, FT_HW, FT_HW, 3)), seed=0, train=False)
    init_opt, step_fn = jtl.make_finetune_step(jm, FT_LR, encoder_only=True)
    step_fn = jax.jit(step_fn)
    opt = init_opt(variables)
    tm = create_model(WaveletOpts(num_layers=tiny_densenet), "cpu")
    tm.load_state_dict(tio.from_jax_variables(variables))
    port_step = ttl.make_finetune_step(tm, FT_LR, encoder_only=True)
    rng = np.random.default_rng(2)
    image = rng.uniform(size=(2, FT_HW, FT_HW, 3)).astype(np.float32)
    yy, xx = np.mgrid[:FT_HW // 2, :FT_HW // 2] / (FT_HW // 2) - 0.5
    depth = np.broadcast_to((2.0 - np.sqrt(np.clip(0.25 - xx**2 - yy**2, 0, None)))[None, ..., None],
                            (2, FT_HW // 2, FT_HW // 2, 1)).astype(np.float32)
    batch = {"image": image, "depth": depth, "mask": np.ones_like(depth)}
    tbatch = {k: torch.from_numpy(nchw(v)) for k, v in batch.items()}

    def tap_jax(v):
        return nchw(jm.apply(v, jnp.asarray(image), train=False, method=jm.encode)[0])

    def tap_port():
        tm.eval()
        with torch.no_grad():
            return tm.encode(torch.from_numpy(nchw(image)))[0].numpy()

    first = tap_port()
    for i in range(FT_STEPS):
        variables, opt, _ = step_fn(variables, opt, batch, FT_LR)
        tm.train()
        port_step(tbatch, FT_LR)
        err = rel_l2(tap_port(), tap_jax(variables))
        assert err <= 1e-4, (i, err)
    moved = rel_l2(tap_port(), first)
    print(f"\n(b) {FT_STEPS} finetune steps move the tap by {moved:.3e} relative L2; "
          f"the two packages' taps agree to {err:.1e}")
    assert 0 < moved < 0.05


# ---------------------------------------------------------------------------
# (c) the feature file -> batch path
# ---------------------------------------------------------------------------


def test_feature_store_path_is_byte_identical(scene, taps, tmp_path):
    """One 96-channel feature set, written as predict writes it
    ([1, 96, H/2, W/2] f32 per view), through both packages' stores."""
    d = str(tmp_path)
    make_synthetic_scene(d, n_images=N_VIEWS, H=RES, W=RES)
    out = os.path.join(d, "image", "00")
    os.makedirs(out)
    stems = sorted(os.path.splitext(f)[0] for f in os.listdir(os.path.join(d, "image"))
                   if f.endswith(".png"))
    for stem, f in zip(stems, taps["port"][0]):
        np.save(os.path.join(out, f"{stem}.npy"), f[None])
    conf = os.path.join(d, "synthetic.conf")
    write_synthetic_conf(conf, data_dir=d, exp_dir=os.path.join(d, "exp"))
    from vdnerf_tpu.utils.hocon import load_conf as jax_load_conf

    jsd = JSceneData(jax_load_conf(conf)["dataset"])
    tsd = TSceneData(port_load_conf(conf)["dataset"])
    js = JRayStore(jsd.images_lis, jsd.masks_lis, jsd.depth_lis, with_depth=True)
    ts = TRayStore(tsd.images_lis, tsd.masks_lis, tsd.depth_lis, with_depth=True)
    jf, tf = np.asarray(js.depth_feats), np.asarray(ts.depth_feats)
    assert jf.shape == tf.shape == (N_VIEWS, RES, RES, 96) and jf.dtype == tf.dtype == np.float16
    assert np.array_equal(jf, tf)
    # the store's values are the z-scored, squashed tap, bilinearly upsampled
    assert abs(float(tf.astype(np.float32).mean()) - float(_targets(taps["port"][0]).mean())) < 0.01


# ---------------------------------------------------------------------------
# (d) the cycle tools' glue
# ---------------------------------------------------------------------------


def _jax_stage_argvs(args, scene_dir, ckpt):
    """The argument lists tools/vdn_cycle_run.py hands to finetune and
    predict_main, evaluated from its source with ``args``."""
    tree = ast.parse(open(jax_tool().__file__).read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    env = {"args": args, "case": args.geometry, "scene_dir": scene_dir, "os": os, "str": str,
           "ckpts": [os.path.join(ckpt, "model.npz")]}
    out = {}
    for node in ast.walk(main):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and \
                node.func.id in ("finetune", "predict_main"):
            out[node.func.id] = eval(compile(ast.Expression(node.args[0]), "<jax tool>", "eval"),
                                     env)
    return out["finetune"], out["predict_main"]


def test_cycle_glue_hands_the_same_arguments(tmp_path, monkeypatch):
    flags = ["--iters", "12000", "--depth-weight-scale", "10", "--shading", "camlight",
             "--out", str(tmp_path)]
    args = port_tool.build_parser().parse_args(flags)
    seen = {}
    logpath = str(tmp_path / "log")
    for epoch in (0, args.wavelet_epochs - 1):  # finetune saves epoch 0 and the last
        os.makedirs(os.path.join(logpath, "models", f"weights_{epoch}"))
        open(os.path.join(logpath, "models", f"weights_{epoch}", "model.npz"), "w").close()

    def fake_finetune(argv, device=None):
        seen["finetune"] = argv
        return logpath

    def fake_predict(argv, device=None):
        seen["predict"] = argv
        feat_dir = os.path.join(cyc.scene_dir, "image", "wavelet_feats", "0")
        os.makedirs(feat_dir, exist_ok=True)
        np.save(os.path.join(feat_dir, "000.npy"), np.zeros((1, 96, 2, 2), np.float32))

    monkeypatch.setattr(port_tool.finetune_cli, "finetune", fake_finetune)
    monkeypatch.setattr(port_tool.predict_cli, "main", fake_predict)
    cyc = port_tool.Cycle(args, torch.device("cpu"), port_tool.StageLog(torch.device("cpu"), None))
    ckpt = cyc.finetune(os.path.join(args.out, "wavelet_log"))
    cyc.predict(ckpt)
    jft, jpred = _jax_stage_argvs(args, cyc.scene_dir, ckpt)

    # finetune: every setting the finetune CLI reads, as each package parses it
    drop = {"gpu", "logdir"}
    jft_args = {k: v for k, v in vars(jax_finetune.parse_argument(jft)).items() if k not in drop}
    pft_args = {k: v for k, v in vars(port_finetune.parse_argument(seen["finetune"])).items()
                if k not in drop}
    assert jft_args == pft_args
    for k, want in (("learning_rate", 1e-5), ("epochs", 6), ("batch_size", 2),
                    ("image_size", 256), ("dpt_max", 4.0), ("encoder_type", "densenet")):
        assert pft_args[k] == want, k
    # predict: the same flags; the checkpoint differs by rule
    strip = lambda argv: [a for a in argv if a not in ("--gpu", "0")]  # noqa: E731
    assert strip(seen["predict"])[:-6] == strip(jpred)[:-6]
    assert strip(seen["predict"])[2:] == strip(jpred)[2:]
    # the port loads the last epoch; the JAX tool the first checkpoint os.walk
    # lists, which on this file system is
    walk_first = next(os.path.join(r, f) for r, _, fs in os.walk(logpath) for f in fs
                      if f == "model.npz")
    print(f"\n(d) port predict loads {os.path.basename(ckpt)}; the JAX tool loads "
          f"{os.path.basename(os.path.dirname(walk_first))} here (os.walk order)")
    assert os.path.basename(ckpt) == f"weights_{args.wavelet_epochs - 1}"


# ---------------------------------------------------------------------------
# (e) the swap
# ---------------------------------------------------------------------------


def test_swapped_factors_put_the_gap_on_the_draw(composites, taps):
    """The first loss of each package's composite (per seed) against each
    package's features (seed 0): swapping the features' package moves it by
    less than a quarter of the spread the networks' draw gives (the feature
    draw moves it by about 1 either way), and the two packages' losses agree
    over their seeds."""
    rng = np.random.default_rng(1)
    loss = {}
    for fk in ("jax", "port"):
        t = _targets(taps[fk][0])
        t = t[rng.integers(0, len(t), N_RAYS)]
        for nk in ("jax", "port"):
            loss[nk, fk] = [float(np.abs(rf - t).sum(1).mean()) for rf in composites[nk]]
    for (nk, fk), v in loss.items():
        print(f"\n(e) {nk} networks, {fk} features: {np.round(v, 3).tolist()}")
    spread = max(max(v) - min(v) for v in loss.values())
    for nk in ("jax", "port"):
        swap = max(abs(a - b) for a, b in zip(loss[nk, "jax"], loss[nk, "port"]))
        assert swap < 0.25 * spread, (nk, swap, spread)
    _agree(loss["jax", "jax"], loss["port", "port"], "(e) first loss, own factors")
    _agree(loss["jax", "port"], loss["port", "jax"], "(e) first loss, swapped features")
