"""How far the port's bf16 operand mode drifts from JAX's default f32 step,
and that all of that drift is the reference kernels' own.

The port runs the colour head, the depth head and the background NeRF
through K2-K5 in an operand mode (``models/precision.py``): bf16 operands
under the bf16 policy or with ``VDNERF_FUSED=1``, JAX's opt-in fused path;
f32 operands under JAX's default (``tests/test_torch_f32_mode.py``). This
file builds the port's model in the bf16 mode explicitly (the plain versions
round exactly as the kernels do) and runs it on the CPU against both JAX
paths, on the synthetic scene and the faithful ``skip_bg_inside`` renderer of
``tests/test_torch_train.py``:

- against JAX's fused path (bf16 against bf16): one step's loss within 1e-5
  relative and every gradient within 2e-4 relative L2; a 20-step loss
  trajectory within 2e-5 relative (measured: 0, 4.3e-5, 4.1e-6);
- against JAX's default f32 path (the precision gap): one step's loss within
  1e-4 relative and every gradient within 0.15 relative L2; the trajectory
  within 1e-4 relative (measured: 2.4e-5, 4.6e-2 on the NeRF's first layer
  with a median of 1.4e-3 over the tensors, 3.3e-5);
- the gap is the reference's own: for each tensor, the port's gap to JAX's
  default path is at most 1.5x JAX's fused path's gap to its own default
  path, plus 1e-4 (relative L2 against the default path's gradient), on the
  mask-free step and on a wdepth step (``tests/test_torch_wdepth.py``'s scene
  and nets, the depth head and the NeRF's dpt head included, past the
  distillation ramp). The 1.5x and 1e-4 leave room for the port's own
  distance from the fused path (the line above: 4.3e-5 at worst); a port
  error of its own would show as a tensor past them.

The other tolerances hold the measured gaps (printed with ``-s``) with a
margin of 3-5x. The worst gradient gap to the f32 path is three orders of
magnitude above the bf16-against-bf16 one: bf16 operand rounding (2^-8
relative per operand) in the Pallas kernels' ``_mm`` compounds through the
NeRF's trunk into its first layer's weight gradient.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from test_torch_train import NETS, H, W, _batches, _cfgs, _jax_tree_as_port, _port_grads, scene  # noqa: F401
from test_torch_wdepth import STEP_NETS as WDEPTH_NETS
from test_torch_wdepth import make_scene as make_wdepth_scene
from torch_parity import jax_params, one_torch_thread, port_model, port_nets  # noqa: F401
from vdnerf_tpu.models import precision
from vdnerf_tpu.train import SceneStatic, init_state, make_train_step
from vdnerf_tpu.train.step import make_loss_fn
from vdnerf_tpu_torch.train.step import Trainer

BF16 = torch.bfloat16  # the port's operand mode throughout this file
JAX_PATHS = {"jax_fused_bf16": True, "jax_default_f32": False}
STEP_LOSS_TOL = {"jax_fused_bf16": 1e-5, "jax_default_f32": 1e-4}
GRAD_L2_TOL = {"jax_fused_bf16": 2e-4, "jax_default_f32": 0.15}
TRAJ_TOL = {"jax_fused_bf16": 2e-5, "jax_default_f32": 1e-4}
# the port's gap to JAX's default path against JAX fused's own, per tensor
OWN_GAP_FACTOR, OWN_GAP_ABS = 1.5, 1e-4


@pytest.fixture
def jax_path(request):
    """The JAX package's fused-MLP switch for one test, restored after it."""
    precision.set_fused_mlp(JAX_PATHS[request.param])
    yield request.param
    precision.set_fused_mlp(False)


@pytest.fixture(scope="module")
def wdepth_scene(tmp_path_factory):
    return make_wdepth_scene(str(tmp_path_factory.mktemp("precision_wdepth")))


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _jax_step(nets, jcfg, jcams, params, batch, step, fused: bool):
    """(loss, gradients by port name) of JAX's step on one of its paths."""
    fn = jax.jit(jax.value_and_grad(make_loss_fn(nets, jcfg, SceneStatic(H=H, W=W)),
                                    has_aux=True))
    precision.set_fused_mlp(fused)
    try:
        (loss, _), (g, _) = fn((params, jcams), batch, step, jax.random.PRNGKey(0))
    finally:
        precision.set_fused_mlp(False)
    return float(loss), _jax_tree_as_port(g)


@pytest.mark.parametrize("jax_path", list(JAX_PATHS), indirect=True)
def test_bf16_step_against_jax(scene, jax_path):
    jcfg, tcfg = _cfgs(scene)
    params = jax_params(NETS)
    (jb,), (tb,) = _batches(scene, 1)
    loss, want = _jax_step(NETS, jcfg, scene["jcams"], params, jb, 30, JAX_PATHS[jax_path])
    model = port_model(NETS, params, BF16)
    assert model.color_network_fine.mm_dtype == model.nerf.mm_dtype == BF16
    got = Trainer(tcfg, model, scene["tcams"], None).gradients(port_nets(NETS), tb, 30)

    loss_gap = abs(float(got["loss"]) - loss) / abs(loss)
    grads = _port_grads(model)
    gaps = {n: _rel_l2(gr, want[n].reshape(gr.shape)) for n, gr in grads.items()}
    worst = max(gaps, key=gaps.get)
    print(f"\n{jax_path}: loss gap {loss_gap:.3e}; worst gradient relative L2 gap "
          f"{gaps[worst]:.3e} ({worst}); median {np.median(list(gaps.values())):.3e}")
    assert loss_gap <= STEP_LOSS_TOL[jax_path]
    assert gaps[worst] <= GRAD_L2_TOL[jax_path], (worst, gaps[worst])


@pytest.mark.parametrize("jax_path", list(JAX_PATHS), indirect=True)
def test_bf16_trajectory_against_jax(scene, jax_path):
    jcfg, tcfg = _cfgs(scene, warm_up_end=5)
    params = jax_params(NETS)
    jbs, tbs = _batches(scene, 20, seed=4)
    state = init_state(params, jcfg, scene["jcams"], jax.random.PRNGKey(0))
    step_fn = jax.jit(make_train_step(NETS, jcfg, SceneStatic(H=H, W=W)))
    want = []
    for b in jbs:
        state, m = step_fn(state, b)
        want.append(float(m["loss"]))
    trainer = Trainer(tcfg, port_model(NETS, params, BF16), scene["tcams"], None)
    got = [float(trainer.step(port_nets(NETS), b, i)["loss"]) for i, b in enumerate(tbs)]
    gaps = np.abs(np.subtract(got, want)) / np.abs(want)
    print(f"\n{jax_path}: 20-step loss trajectory, largest relative gap {gaps.max():.3e} "
          f"at step {int(gaps.argmax())}, last step {gaps[-1]:.3e}")
    assert gaps.max() <= TRAJ_TOL[jax_path]


@pytest.mark.parametrize("regime", ["womsk", "wdepth"])
def test_port_adds_no_gap_of_its_own(request, regime):
    """Per tensor: |port - JAX default| <= 1.5 |JAX fused - JAX default| +
    1e-4, relative L2 against JAX default's gradient."""
    if regime == "womsk":
        sc, nets = request.getfixturevalue("scene"), NETS
        jcfg, tcfg = _cfgs(sc)
    else:
        sc, nets = request.getfixturevalue("wdepth_scene"), WDEPTH_NETS
        jcfg, tcfg = sc["jcfg"], sc["tcfg"]
    (jb,), (tb,) = _batches(sc, 1)
    params = jax_params(nets)
    _, default = _jax_step(nets, jcfg, sc["jcams"], params, jb, 30, fused=False)
    _, fused = _jax_step(nets, jcfg, sc["jcams"], params, jb, 30, fused=True)
    model = port_model(nets, params, BF16)
    Trainer(tcfg, model, sc["tcams"], None).gradients(port_nets(nets), tb, 30)
    grads = _port_grads(model)
    assert set(grads) == set(default)
    if regime == "wdepth":
        assert any(n.startswith("depth_network_fine.") for n in grads)
        assert "nerf.dpt_linear.weight" in grads

    rows = []
    for n, gr in grads.items():
        d = default[n].reshape(gr.shape)
        rows.append((n, _rel_l2(gr, d), _rel_l2(fused[n].reshape(gr.shape), d),
                     _rel_l2(gr, fused[n].reshape(gr.shape))))
    print(f"\n{regime}: per tensor, relative L2 to JAX default f32: port / JAX fused "
          "(port to JAX fused)")
    for n, port_gap, jax_gap, own in rows:
        print(f"  {n}: {port_gap:.3e} / {jax_gap:.3e} ({own:.3e})")
    worst = max(rows, key=lambda r: r[1] - OWN_GAP_FACTOR * r[2])
    print(f"{regime}: worst margin at {worst[0]}: port {worst[1]:.3e} against "
          f"{OWN_GAP_FACTOR} x {worst[2]:.3e} + {OWN_GAP_ABS:.0e}; largest JAX fused gap "
          f"{max(r[2] for r in rows):.3e}, largest port-to-fused {max(r[3] for r in rows):.3e}")
    for n, port_gap, jax_gap, _ in rows:
        assert port_gap <= OWN_GAP_FACTOR * jax_gap + OWN_GAP_ABS, (n, port_gap, jax_gap)
