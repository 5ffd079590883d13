"""Data parallelism over rays (``vdnerf_tpu_torch/parallel/mesh.py``) on 2
gloo ranks of the CPU, against the JAX package's sharded step on a 2-device
mesh and against the port's own single-process step.

The ranks are processes spawned through ``tests/torch_dist.py`` (it imports
no JAX, so a rank starts in a few seconds); the cases share two spawns. The
steps are the parity tests' (``test_torch_train.py``, ``test_torch_wdepth.py``,
``test_torch_learned.py``): small nets from one seed, the same numpy pixel
batches, ``perturb`` 0, JAX's fused path (Pallas in interpret mode) and both
sides' fused-MLP operands in f32.

Tolerances, those of ``test_torch_train.py``: the loss and every metric
within 1e-5 relative (f32 summation order: each rank sums its block, then
the blocks are summed); every summed gradient, the cameras' r, t and fx too,
within 1e-4 of its tensor's largest entry.

The JAX sharded step's gradient is N times the single-device one: it
differentiates through ``psum``, which ``shard_map(check_vma=False)``
transposes to another ``psum`` before the gradients are summed (Adam's
update hides the factor up to ``eps``). The port's ``global_sum`` sends the
cotangent to the local term alone, so its summed gradient is the
single-process one; the JAX side is held divided by N, and the factor itself
is asserted against JAX's unsharded step.

Runs: a 2-rank ``Runner.train`` of 20 steps at ``steps_per_call`` 10 against
a 1-process run: the logged steps (1, 10, 20) equal, and every logged loss
within 1e-5 relative at every logged step but one term: past the first
update the eikonal term is held at 3e-4, twice its measured drift. From the
first update on, a gradient entry near zero moves its parameter by about
+-lr on its sign alone (Adam's first steps are lr * g / |g|), and the
eikonal term, a mean of squared residuals (|grad f| - 1)^2, moves
relatively most (1.7e-5 at step 10, 1.4e-4 at step 20; the objective under
7e-7, the colour term under 7e-7, the mask term 0). Rank 0 writes every file and rank 1 none. A SIGTERM on
one rank stops both at the same window with one checkpoint.
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

import torch_dist
from test_torch_learned import NETS as LEARN_NETS
from test_torch_learned import SCENE as LEARN_SCENE
from test_torch_learned import _cams, _learn_scene
from test_torch_train import BATCH, H, W, _batches, _jax_tree_as_port, scene  # noqa: F401
from test_torch_wdepth import STEP_NETS as WDEPTH_NETS
from test_torch_wdepth import make_scene as make_wdepth_scene
from torch_parity import jax_nets, jax_params, one_torch_thread, port_model, port_nets  # noqa: F401
from vdnerf_tpu.models import precision
from vdnerf_tpu.ops.pallas import fused_mlp as jax_fused
from vdnerf_tpu.parallel.mesh import make_mesh, make_sharded_train_step
from vdnerf_tpu.parallel.mesh import shard_batch as jax_shard_batch
from vdnerf_tpu.train import SceneStatic, init_state, make_train_step
from vdnerf_tpu_torch import parallel
from vdnerf_tpu_torch.data.synthetic import make_synthetic_scene, write_synthetic_conf
from vdnerf_tpu_torch.train.step import Trainer

N_RANKS = 2
PLAIN_NETS = jax_nets(perturb=0.0, skip_bg_inside=True)
CASES = ("mask_free", "wdepth", "learnable", "grad_accum_2")


def _case(name, scene, tmp_path_factory):
    """-> (JAX nets, jcfg, tcfg, JAX scene static, JAX cams, the port's cams
    spec for a rank and its cams for the parent, step)."""
    if name in ("mask_free", "grad_accum_2"):
        accum = 2 if name == "grad_accum_2" else 1
        jcfg = dataclasses.replace(scene["jcfg"], grad_accum=accum)
        tcfg = dataclasses.replace(scene["tcfg"], grad_accum=accum)
        spec = {k: v.numpy() for k, v in scene["tcams"].items()}
        return (PLAIN_NETS, scene, jcfg, tcfg, SceneStatic(H=H, W=W), scene["jcams"], spec,
                scene["tcams"], 30)
    if name == "wdepth":
        wscene = make_wdepth_scene(str(tmp_path_factory.mktemp("parallel_wdepth")))
        spec = {k: v.numpy() for k, v in wscene["tcams"].items()}
        return (WDEPTH_NETS, wscene, wscene["jcfg"], wscene["tcfg"], SceneStatic(H=H, W=W),
                wscene["jcams"], spec, wscene["tcams"], 30)
    lscene = _learn_scene(str(tmp_path_factory.mktemp("parallel_learned")))
    jcams, cams = _cams(lscene, True)
    state = {k: v.detach().numpy() for k, v in cams.state_dict().items()}
    spec = {"learned": (lscene["pose_all"], lscene["focal"], H, W, state)}
    # start_refine_pose_iter -1: step 7 refines the cameras
    return (LEARN_NETS, lscene, lscene["jcfg"], lscene["tcfg"], LEARN_SCENE, jcams, spec, cams,
            7)


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):  # noqa: F811
    """Every step case through JAX's 2-device sharded step, the port's single
    process and the port's 2 ranks (with the collectives on their own, in the
    same spawn) -> ({case: {jax, single, ranks}}, [collectives per rank])."""
    mesh = make_mesh(jax.devices()[:N_RANKS])
    out = {name: {} for name in CASES}
    rank_cases = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_fused, "_BF16", jnp.float32)
        precision.set_fused_mlp(True)
        try:
            for name in CASES:
                nets, sc, jcfg, tcfg, static, jcams, spec, tcams, step = _case(
                    name, scene, tmp_path_factory)
                (jb,), (tb,) = _batches(sc, 1, seed=11)
                params = jax_params(nets)
                state = dict(init_state(params, jcfg, jcams, jax.random.PRNGKey(0)),
                             step=jnp.asarray(step, jnp.int32))
                sharded = make_sharded_train_step(nets, jcfg, static, mesh,
                                                  grad_accum=jcfg.grad_accum)
                s2, m2 = sharded(state, jax_shard_batch(jb, mesh))
                rec = out[name]
                rec["jax"] = {"metrics": {k: float(v) for k, v in m2.items()},
                              "grads": _mu_grads(s2["opt_state"])}
                if tcfg.learnable:
                    pose, focal = _mu(s2["pose_opt_state"]), _mu(s2["focal_opt_state"])
                    rec["jax"]["cam_grads"] = {k: np.asarray(v) / 0.1 for k, v in
                                               (("r", pose["r"]), ("t", pose["t"]),
                                                ("fx", focal["fx"]))}
                if name == "mask_free":
                    # JAX's unsharded step on the same batch, for the factor N
                    s1, _ = jax.jit(make_train_step(nets, jcfg, static))(state, jb)
                    rec["jax_single_grads"] = _mu_grads(s1["opt_state"])
                pnets = port_nets(nets)
                model = port_model(nets, params, torch.float32)
                rank_cases.append({"nets": pnets, "tcfg": tcfg, "cams": spec, "batch": tb,
                                   "step": step, "state": {k: v.numpy() for k, v in
                                                           model.state_dict().items()}})
                if jcfg.grad_accum == 1:
                    metrics = Trainer(tcfg, model, tcams, None).gradients(pnets, tb, step)
                    rec["single"] = {
                        "metrics": {k: float(v) for k, v in metrics.items()},
                        "grads": {n: p.grad.numpy() for n, p in model.named_parameters()}}
                    if tcfg.learnable:
                        rec["single"]["cam_grads"] = {n: p.grad.numpy()
                                                      for n, p in tcams.named_parameters()}
        finally:
            precision.set_fused_mlp(False)
    ranks = torch_dist.run("several", N_RANKS, calls=[("step_cases", {"cases": rank_cases}),
                                                      ("collectives", {"seed": 3})])
    for i, name in enumerate(CASES):
        out[name]["ranks"] = [r[0][i] for r in ranks]
    return out, [r[1] for r in ranks]


def _mu(opt_state):
    """The first moment of an optax Adam state."""
    if hasattr(opt_state, "mu"):
        return opt_state.mu
    return next(s.mu for s in opt_state if hasattr(s, "mu"))


def _mu_grads(opt_state) -> dict[str, np.ndarray]:
    """After one Adam update from zero, mu = (1 - b1) g: the port's names."""
    return {k: v / 0.1 for k, v in _jax_tree_as_port(_mu(opt_state)).items()}


def _close_rel(got, want, rel, what="") -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = float(np.abs(got - want.reshape(got.shape)).max())
    assert err <= rel * scale, f"{what}: max abs err {err:.3e} > {rel:.0e} x {scale:.3e}"
    return err / scale


def _hold(got: dict, want: dict, grad_scale: float = 1.0) -> float:
    """Metrics within 1e-5 relative, every gradient (``want`` divided by
    ``grad_scale``) within 1e-4 of its largest entry -> the worst gradient
    error relative to its tensor's largest entry."""
    for k, v in want["metrics"].items():
        g = got["metrics"][k]
        assert abs(g - v) <= 1e-5 * max(abs(v), 1e-3), (k, g, v)
    worst = 0.0
    for key in ("grads", "cam_grads"):
        if key not in want:
            continue
        assert set(got[key]) == set(want[key]), key
        for name, w in want[key].items():
            worst = max(worst, _close_rel(got[key][name], np.asarray(w) / grad_scale, 1e-4,
                                          f"{key}.{name}"))
    return worst


@pytest.mark.parametrize("case", ["mask_free", "wdepth", "learnable"])
def test_two_rank_step_matches_jax_sharded_and_single_process(runs, case):
    rec = runs[0][case]
    r0, r1 = rec["ranks"]
    # each rank a 32-ray block of the 64-ray batch; the same sums on both
    assert r0["rays"] == r1["rays"] == BATCH // N_RANKS
    assert r0["metrics"] == r1["metrics"]
    for key in ("grads", "cam_grads"):
        for name, g in r0.get(key, {}).items():
            np.testing.assert_array_equal(g, r1[key][name], err_msg=name)
    if case == "learnable":
        assert set(r0["cam_grads"]) == {"r", "t", "fx"}
        assert all(np.abs(g).max() > 0 for g in r0["cam_grads"].values())
    if case == "wdepth":
        assert "depth_loss" in r0["metrics"]
    vs_jax = _hold(r0, rec["jax"], grad_scale=N_RANKS)
    vs_single = _hold(r0, rec["single"])
    print(f"\n{case}: worst gradient error vs JAX sharded / N {vs_jax:.2e}, vs the "
          f"single process {vs_single:.2e} (of the tensor's largest entry)")


def test_jax_sharded_gradient_is_n_times_the_single_device_one(runs):
    """What the JAX side is divided by: its sharded step's gradient against
    its unsharded step's on the same batch."""
    rec = runs[0]["mask_free"]
    for name, g in rec["jax_single_grads"].items():
        _close_rel(rec["jax"]["grads"][name], N_RANKS * g, 1e-4, name)


def test_two_rank_grad_accum_2_matches_jax_sharded(runs):
    """2 microbatches of 16 rays on each rank's 32: the normalisers are
    global per microbatch, as in JAX's scan inside shard_map."""
    rec = runs[0]["grad_accum_2"]
    r0, r1 = rec["ranks"]
    assert r0["metrics"] == r1["metrics"]
    _hold(r0, rec["jax"], grad_scale=N_RANKS)


def test_global_sum_gradient_is_local_and_gradients_sum_once(runs):
    """global_sum(3 x) on ranks holding x = 1 and 2: the value is 9 on both,
    the gradient 3 (not 3 N); all_reduce_grads sums each .grad once."""
    for r in runs[1]:
        assert r["sum"] == 9.0 and r["sum_grad"] == 3.0
        np.testing.assert_array_equal(r["p_grad"], np.full((2, 3), 3.0))
        np.testing.assert_array_equal(r["q_grad"], np.arange(4.0) * 3)
        assert r["any"] is True and r["object"] == {"rank": 0}


def test_rank_jitter_streams_differ_and_rank_0_is_the_single_stream(runs):
    r0, r1 = runs[1]
    want = torch.rand(8, generator=torch.Generator().manual_seed(3)).numpy()
    np.testing.assert_array_equal(r0["jitter"], want)
    assert not np.array_equal(r0["jitter"], r1["jitter"])
    assert parallel.rank_seed(3, 0) == 3 and parallel.rank_seed(3, 1) != 3
    assert parallel.rank_seed(3, 1) != parallel.rank_seed(4, 1)


def test_shard_batch_blocks_and_refusals():
    """Contiguous row blocks of one step's batch, img_idx whole, on each
    rank; a world of 1 keeps the batch; a batch or block that does not
    divide raises."""
    batch = {"img_idx": np.int32(2), "pixels_x": np.arange(8), "color": np.zeros((8, 3))}
    for rank in range(2):
        world = parallel.World(rank=rank, size=2, grouped=True)
        got = parallel.shard_batch(batch, world, grad_accum=2)
        np.testing.assert_array_equal(got["pixels_x"], np.arange(4 * rank, 4 * rank + 4))
        assert got["img_idx"] == 2 and got["color"].shape == (4, 3)
    assert parallel.shard_batch(batch, parallel.World()) is batch
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        parallel.shard_batch(batch, parallel.World(rank=0, size=3))
    with pytest.raises(ValueError, match="into 3 microbatches"):
        parallel.shard_batch(batch, world, grad_accum=3)


# ---------------------------------------------------------------------------
# Runner.train on 2 ranks
# ---------------------------------------------------------------------------

def _conf(d, name, end_iter, save_freq, val_freq) -> str:
    """The synthetic conf at steps_per_call 10, perturb 0, batch 32."""
    path = os.path.join(d, f"{name}.conf")
    write_synthetic_conf(path, data_dir=d, exp_dir=os.path.join(d, name), end_iter=end_iter,
                         batch_size=32, save_freq=save_freq, val_freq=val_freq,
                         val_mesh_freq=20)
    with open(path) as f:
        text = f.read()
    for old, new in (("rgb_dims = 3\n}", "rgb_dims = 3\n    steps_per_call = 10\n}"),
                     ("perturb = 1.0", "perturb = 0.0")):
        text, n = re.subn(re.escape(old), new, text)
        assert n == 1, old
    with open(path, "w") as f:
        f.write(text)
    return path


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("parallel_runs"))
    make_synthetic_scene(d, n_images=5, H=24, W=32)
    confs = {"one": _conf(d, "one", 20, 10, 10), "two": _conf(d, "two", 20, 10, 10),
             "sigterm": _conf(d, "sigterm", 20, 20, 20)}
    ranks = torch_dist.run("train_runs", N_RANKS, conf=confs["two"],
                           sigterm_conf=confs["sigterm"])
    from vdnerf_tpu_torch import runner as runner_mod

    with pytest.MonkeyPatch.context() as mp:
        full = runner_mod.mesh_resolution
        mp.setattr(runner_mod, "mesh_resolution", lambda step: (16, full(step)[1]))
        one = runner_mod.Runner(confs["one"], device="cpu", mode="train")
        seed = one.trainer.generator.initial_seed()
        summary = one.train()
    return {"dir": d, "ranks": ranks, "one": {"summary": summary, "seed": seed}}


def _metrics(exp: str) -> list[dict]:
    with open(os.path.join(exp, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_two_rank_runner_matches_one_process_and_only_rank_0_writes(train_runs):
    d, (r0, r1) = train_runs["dir"], train_runs["ranks"]
    one, two = _metrics(os.path.join(d, "one")), _metrics(os.path.join(d, "two"))
    assert [r["step"] for r in two] == [r["step"] for r in one] == [1, 10, 20]
    errs = [{k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for k in b if k.endswith("loss")}
            for a, b in zip(two, one)]
    print(f"\n2 ranks vs 1 process, rel err per logged loss at steps 1, 10, 20: {errs}")
    # step 1 precedes every update; after it only the eikonal term drifts past 1e-5
    assert all(e <= 1e-5 for e in errs[0].values())
    for e in errs[1:]:
        assert all(v <= 1e-5 for k, v in e.items() if k != "eikonal_loss"), e
        assert e["eikonal_loss"] <= 3e-4, e
    # the closing evaluation is rank 0's, broadcast to both
    assert r0["run"]["summary"] == r1["run"]["summary"]
    assert set(r0["run"]["summary"]) == set(train_runs["one"]["summary"])
    assert r0["run"]["iter_step"] == r1["run"]["iter_step"] == 20
    # rank 0 writes one set of files; rank 1 none
    assert r0["run"]["counts"] == {"record_run": 1, "save_checkpoint": 2, "validate_image": 2,
                                   "validate_mesh": 1, "val_all_imgs": 1, "write": 3}
    assert r1["run"]["counts"] == {}
    exp = os.path.join(d, "two")
    assert sorted(os.listdir(os.path.join(exp, "checkpoints"))) == ["ckpt_000010.pth",
                                                                   "ckpt_000020.pth"]
    assert len(os.listdir(os.path.join(exp, "validations_fine"))) == 2
    assert sorted(os.listdir(os.path.join(exp, "meshes"))) == ["00000020.ply"]
    # each rank its own jitter stream; rank 0's is the single-process one
    assert r0["run"]["seed"] == train_runs["one"]["seed"] == 0
    assert r1["run"]["seed"] == parallel.rank_seed(0, 1) != 0


def test_sigterm_on_one_rank_stops_both_at_one_window(train_runs):
    d, (r0, r1) = train_runs["dir"], train_runs["ranks"]
    for r in (r0, r1):
        assert r["sigterm"]["summary"] is None and r["sigterm"]["iter_step"] == 10
    assert r0["sigterm"]["counts"] == {"record_run": 1, "save_checkpoint": 1, "write": 2}
    assert r1["sigterm"]["counts"] == {}
    assert os.listdir(os.path.join(d, "sigterm", "checkpoints")) == ["ckpt_000010.pth"]


# ---------------------------------------------------------------------------
# the CLI under torchrun's variables
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def two_rank_env(monkeypatch):
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "2"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("mode", ["valimg_0", "getfeats_0", "validate_mesh_0",
                                  "interpolate_0_1", "showcam"])
def test_serving_modes_refuse_world_size_above_one(two_rank_env, mode):
    from vdnerf_tpu_torch.cli import main

    conf = os.path.join(ROOT, "confs", "womsk_white_tpu.conf")
    with pytest.raises(SystemExit, match="serves on one device"):
        main(["--conf", conf, "--case", "none", "--mode", mode], device="cpu")
    assert not parallel.active()


def test_gpu_flag_under_torchrun_is_refused(two_rank_env):
    from vdnerf_tpu_torch.cli import main

    conf = os.path.join(ROOT, "confs", "womsk_white_tpu.conf")
    with pytest.raises(SystemExit, match="leave --gpu at 0"):
        main(["--conf", conf, "--case", "none", "--mode", "train", "--gpu", "1"])
    assert not parallel.active()


def test_no_torchrun_means_no_group(monkeypatch):
    for k in parallel.mesh.RANK_ENV:
        monkeypatch.delenv(k, raising=False)
    with parallel.world_from_env(torch.device("cpu")) as world:
        assert world == parallel.World() and not parallel.active()
    x = torch.tensor(2.0, requires_grad=True)
    assert world.sum(x) is x
