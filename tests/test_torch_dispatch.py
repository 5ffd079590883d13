"""Multi-step dispatch (``vdnerf_tpu_torch/train/dispatch.py``) on the CPU,
where a window of K steps is ``Trainer.step`` once per step, against the JAX
package's K-step program and against the port's own K = 1 run.

- (a) A window of K = 4 steps on stacked batches against JAX's
  ``make_train_scan_step`` on the same batches (perturb 0, both sides' MLP
  operands in f32 on JAX's default path, as ``tests/test_scan_step.py`` and
  ``tests/test_torch_train.py`` feed them), mask-free and wdepth across
  ``depth_start_iter``: every step's metrics within 1e-4 relative (floor
  1e-3), ``tests/test_torch_train.py``'s trajectory tolerance, and each final
  parameter tensor within 1e-4 relative L2 error (measured: 6.9e-6 and
  2.6e-5 at worst). The error is f32 summation order; Adam's first updates
  move a near-zero gradient's parameter by about +-lr on its sign alone,
  which a norm over the tensor bounds where an element-wise test would not.
- (b) ``Runner.train`` at ``steps_per_call`` 10 against 1 (perturb 1, so the
  jitter stream counts): ``metrics.jsonl`` equal apart from ``rays_per_sec``,
  every checkpoint tensor-equal, every mesh file byte-equal, with the window
  sizes the JAX runner's gcd rule gives: 2 under a ``save_freq`` of 6, 5 with
  ``resample_from`` at 15, 5 after a resume from iteration 5.
- (c) The step-input record (``Trainer.inputs``) against the floats the step
  took before it: the record's values are those floats in f32, and a step's
  loss, metrics and gradients through the record equal, bit for bit, the
  same step through the floats, before and after ``depth_start_iter``,
  during the anneal and after it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import BATCH, N_IMAGES, H, W, _batches  # noqa: F401
from test_torch_wdepth import DEPTH_KEYS, STEP_NETS, make_scene
from torch_parity import f32_matmuls, jax_nets, jax_params, one_torch_thread, port_model, port_nets  # noqa: F401
from vdnerf_tpu.data.dataset import SceneData as JSceneData
from vdnerf_tpu.data.rays import RayStore as JRayStore
from vdnerf_tpu.data.synthetic import make_synthetic_scene, write_synthetic_conf
from vdnerf_tpu.train import SceneStatic, init_state, make_train_scan_step
from vdnerf_tpu.train.config import TrainConfig as JTrainConfig
from vdnerf_tpu.utils.hocon import load_conf as jload_conf
from vdnerf_tpu_torch.data.dataset import SceneData as TSceneData
from vdnerf_tpu_torch.data.rays import RayStore as TRayStore
from vdnerf_tpu_torch.io.checkpoints import from_jax_params
from vdnerf_tpu_torch.train.config import TrainConfig as TTrainConfig
from vdnerf_tpu_torch.train.dispatch import StepDispatch
from vdnerf_tpu_torch.train.step import Trainer, cos_anneal_ratio, depth_ramp_weight, loss_fn
from vdnerf_tpu_torch.utils.hocon import load_conf as tload_conf

K = 4


def _plain_scene(d: str) -> dict:
    make_synthetic_scene(d, n_images=N_IMAGES, H=H, W=W)
    conf = os.path.join(d, "synthetic.conf")
    write_synthetic_conf(conf, data_dir=d, exp_dir=os.path.join(d, "exp"), batch_size=BATCH)
    jconf, tconf = jload_conf(conf), tload_conf(conf)
    jsd, tsd = JSceneData(jconf["dataset"]), TSceneData(tconf["dataset"])
    return {
        "jcfg": JTrainConfig.from_conf(jconf), "tcfg": TTrainConfig.from_conf(tconf),
        "jstore": JRayStore(jsd.images_lis, jsd.masks_lis),
        "tstore": TRayStore(tsd.images_lis, tsd.masks_lis),
        "jcams": {"pose_all": jnp.asarray(jsd.pose_all),
                  "intrin_inv_all": jnp.asarray(jsd.intrinsics_all_inv)},
        "tcams": {"pose_all": torch.as_tensor(tsd.pose_all),
                  "intrin_inv_all": torch.as_tensor(tsd.intrinsics_all_inv)},
    }


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    return {"plain": _plain_scene(str(tmp_path_factory.mktemp("dispatch_plain"))),
            "wdepth": make_scene(str(tmp_path_factory.mktemp("dispatch_wdepth")))}


# ---------------------------------------------------------------------------
# (a) the window against the JAX scan
# ---------------------------------------------------------------------------


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("regime", ["mask_free", "wdepth"])
def test_window_matches_jax_scan(scenes, f32_matmuls, regime):
    if regime == "wdepth":
        # distillation from the window's third step (step index 2 > 1)
        scene, nets, kw = scenes["wdepth"], STEP_NETS, dict(depth_start_iter=1)
    else:
        scene, nets, kw = scenes["plain"], jax_nets(perturb=0.0, skip_bg_inside=True), {}
    kw.update(warm_up_end=2)
    jcfg, tcfg = (dataclasses.replace(scene[k], **kw) for k in ("jcfg", "tcfg"))
    params = jax_params(nets)
    jbs, tbs = _batches(scene, K, seed=7)

    state = init_state(params, jcfg, scene["jcams"], jax.random.PRNGKey(0))
    scan = jax.jit(make_train_scan_step(nets, jcfg, SceneStatic(H=H, W=W)))
    stacked = {k: jnp.asarray(np.stack([b[k] for b in jbs])) for k in jbs[0]}
    state, want = scan(state, stacked)

    model = port_model(nets, params, f32_matmuls)
    trainer = Trainer(tcfg, model, scene["tcams"], None)
    window = StepDispatch(trainer).run(range(K), [port_nets(nets)] * K, tbs)
    got = window.read()
    assert window.metrics.shape == (K, len(trainer.metric_names))
    if regime == "wdepth":
        assert [trainer.distills(s) for s in range(K)] == [False, False, True, True]
    for name in trainer.metric_names:
        w = np.asarray(want[name], np.float64)
        g = np.array([row[name] for row in got])
        assert np.all(np.abs(g - w) <= 1e-4 * np.maximum(np.abs(w), 1e-3)), (name, g, w)
    final = {k: v.numpy() for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, state["params"])).items()}
    for name, p in model.named_parameters():
        err = _rel_l2(p.detach().numpy(), final[name].reshape(p.shape))
        assert err <= 1e-4, (name, err)


# ---------------------------------------------------------------------------
# (b) Runner.train at steps_per_call 10 against 1
# ---------------------------------------------------------------------------

RESAMPLED = ("\n        skip_bg_inside = True\n        n_render_samples = 24"
             "\n        resample_uniform_frac = 1.0")


def _conf(d, name, k, end_iter, save_freq, resample_from=0, extra_renderer=""):
    path = os.path.join(d, f"{name}_k{k}.conf")
    write_synthetic_conf(path, data_dir=d, exp_dir=os.path.join(d, f"{name}_k{k}"),
                         end_iter=end_iter, batch_size=32, save_freq=save_freq,
                         val_freq=10, val_mesh_freq=10)
    with open(path) as f:
        text = f.read()
    train = f"rgb_dims = 3\n    steps_per_call = {k}"
    if resample_from:
        train += f"\n    resample_from = {resample_from}"
    text = text.replace("rgb_dims = 3", train, 1)
    text, n = re.subn(r"perturb = 1\.0", "perturb = 1.0" + extra_renderer, text)
    assert n == 1
    with open(path, "w") as f:
        f.write(text)
    return path


def _train(conf, windows, is_continue=False):
    from vdnerf_tpu_torch.runner import Runner

    runner = Runner(conf, device="cpu", mode="train", is_continue=is_continue)
    run = StepDispatch.run

    def counted(self, steps, nets, batches):
        windows.append(len(steps))
        return run(self, steps, nets, batches)

    StepDispatch.run = counted
    try:
        return runner.train()
    finally:
        StepDispatch.run = run


def _outputs(exp: str) -> dict:
    with open(os.path.join(exp, "logs", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    for r in recs:
        r.pop("rays_per_sec")
    ckpts = {n: torch.load(os.path.join(exp, "checkpoints", n), weights_only=True)
             for n in sorted(os.listdir(os.path.join(exp, "checkpoints")))}
    meshes = {}
    for n in sorted(os.listdir(os.path.join(exp, "meshes"))):
        with open(os.path.join(exp, "meshes", n), "rb") as f:
            meshes[n] = f.read()
    return {"metrics": recs, "ckpts": ckpts, "meshes": meshes}


def _equal_trees(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_trees(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal_trees(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return a == b


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dispatch_runs"))
    make_synthetic_scene(d, n_images=5, H=24, W=32)
    return d


# case -> (conf kwargs, windows of the K = 10 run, windows of a resumed leg)
CASES = {
    "save_freq_gives_k2": (dict(end_iter=12, save_freq=6), [2] * 6, None),
    "resample_inside_window": (dict(end_iter=20, save_freq=20, resample_from=15,
                                    extra_renderer=RESAMPLED), [5] * 4, None),
    "unaligned_resume": (dict(end_iter=5, save_freq=5), [5], [5] * 3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_steps_per_call_10_equals_1(run_dir, monkeypatch, case):
    from vdnerf_tpu_torch import runner as runner_mod

    full = runner_mod.mesh_resolution
    monkeypatch.setattr(runner_mod, "mesh_resolution", lambda step: (16, full(step)[1]))
    kw, want_windows, want_resumed = CASES[case]
    outs = {}
    for k in (10, 1):
        windows = []
        summary = _train(_conf(run_dir, case, k, **kw), windows)
        assert summary is not None and all(np.isfinite(v) for v in summary.values())
        if want_resumed is not None:
            # a second leg to 20 steps from the checkpoint at 5: the resume
            # iteration clips K to 5 (its save_freq of 20 would allow 10)
            windows.append("resume")
            conf = _conf(run_dir, case, k, **{**kw, "end_iter": 20, "save_freq": 20})
            assert _train(conf, windows, is_continue=True) is not None
        want = want_windows + (["resume"] + want_resumed if want_resumed else [])
        if k == 1:
            want = [w if w == "resume" else 1 for w in want for _ in range(w if w != "resume"
                                                                           else 1)]
        assert windows == want, (k, windows)
        outs[k] = _outputs(os.path.join(run_dir, f"{case}_k{k}"))
    assert outs[10]["metrics"] == outs[1]["metrics"]
    assert [r["step"] for r in outs[1]["metrics"]] == sorted(
        {1, *range(10, kw["end_iter"] + 1, 10)} | (
            {10, 20} if want_resumed else set()))
    assert outs[10]["ckpts"].keys() == outs[1]["ckpts"].keys() and outs[1]["ckpts"]
    assert _equal_trees(outs[10]["ckpts"], outs[1]["ckpts"])
    assert outs[10]["meshes"] == outs[1]["meshes"] and outs[1]["meshes"]


# ---------------------------------------------------------------------------
# (c) the step-input record against the floats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [3, 7, 60],
                         ids=["before_depth_start", "after_depth_start", "after_anneal"])
def test_step_inputs_record_equals_the_floats(scenes, step):
    scene = scenes["wdepth"]
    tcfg = dataclasses.replace(scene["tcfg"], anneal_end=50, warm_up_end=4)
    assert tcfg.depth_start_iter == DEPTH_KEYS["depth_start_iter"] == 5
    nets = port_nets(STEP_NETS)
    params = jax_params(STEP_NETS)
    _, (tb,) = _batches(scene, 1, seed=8)

    model = port_model(STEP_NETS, params, torch.bfloat16)
    trainer = Trainer(tcfg, model, scene["tcams"], None)
    got = trainer.gradients(nets, tb, step)
    got_grads = [p.grad.clone() for p in model.parameters()]

    # the floats as the step took them: cos_anneal_ratio, and the ramp times
    # depth_loss_scale as a Python float product, past depth_start_iter only
    distill = step > tcfg.depth_start_iter
    ramp = depth_ramp_weight(max(step - tcfg.depth_start_iter - 1, 0), tcfg.depth_ramp_iters)
    floats = [cos_anneal_ratio(step, tcfg.anneal_end), ramp * tcfg.depth_loss_scale,
              trainer.schedule(step)]
    record = trainer.step_inputs(step)
    assert record.dtype == np.float32
    assert record[0] == floats[0] and record[2] == floats[2]
    assert record[1] == (np.float32(floats[1]) if distill else 0.0)
    assert torch.equal(trainer.inputs, torch.from_numpy(record))
    assert trainer.distills(step) == distill
    assert 0.0 < floats[0] < 1.0 if step < 50 else floats[0] == 1.0

    model = port_model(STEP_NETS, params, torch.bfloat16)
    batch = {k: torch.as_tensor(v) for k, v in tb.items()}
    for p in model.parameters():
        p.grad = None
    loss, want = loss_fn(nets, tcfg, model, scene["tcams"], batch, floats, distill, None)
    loss.backward()
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name
    for g, p in zip(got_grads, model.parameters()):
        # a parameter the loss does not reach (the depth head before
        # depth_start_iter) gets the Trainer's zero gradient
        assert torch.equal(g, torch.zeros_like(p) if p.grad is None else p.grad)
