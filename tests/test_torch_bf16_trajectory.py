"""``train.bf16``: a 20-step loss trajectory of the port's bf16 step against
the JAX package's, on the synthetic scene and the faithful ``skip_bg_inside``
renderer of ``test_torch_train.py`` (``warm_up_end`` 5).

JAX runs its fused path (the colour head's and the background NeRF's
operands rounded to bf16, as K2-K5 round them), as shipped under
``enable_bf16(True)`` and under ``enable_bf16(False)``, each compiled
without XLA's excess precision (``test_torch_bf16.py``). Each step's loss of
the port is within 1.5x of JAX's own bf16-to-f32 gap at that step plus 1e-4,
relative to JAX's bf16 loss: measured largest 3.2e-4 (step 12) against JAX's
own largest 9.7e-4. The loss falls over the 20 steps. ``enable_bf16(False)``
is restored after every JAX run.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np

from test_torch_bf16 import OWN_GAP_ABS, OWN_GAP_FACTOR, _bf16_model, _jax_policy, _jit
from test_torch_train import NETS, H, W, _batches, _cfgs, scene  # noqa: F401
from torch_parity import jax_params, one_torch_thread, port_nets  # noqa: F401
from vdnerf_tpu.train import SceneStatic, init_state, make_train_step
from vdnerf_tpu_torch.train.step import Trainer


def test_bf16_trajectory_stays_within_jax_bf16_gap(scene):
    jcfg, tcfg = _cfgs(scene, warm_up_end=5)
    tcfg = dataclasses.replace(tcfg, bf16=True)
    params = jax_params(NETS)
    jbs, tbs = _batches(scene, 20, seed=4)

    def jax_run(bf16):
        def run():
            # traced anew under each policy: JAX reads it at trace time
            step_fn = _jit(make_train_step(NETS, jcfg, SceneStatic(H=H, W=W)))
            state = init_state(params, jcfg, scene["jcams"], jax.random.PRNGKey(0))
            out = []
            for b in jbs:
                state, m = step_fn(state, b)
                out.append(float(m["loss"]))
            return out
        return np.array(_jax_policy(bf16, True, run))

    want16, want32 = jax_run(True), jax_run(False)
    trainer = Trainer(tcfg, _bf16_model(params), scene["tcams"], None)
    got = np.array([float(trainer.step(port_nets(NETS), b, i)["loss"])
                    for i, b in enumerate(tbs)])
    mine = np.abs(got - want16) / np.abs(want16)
    own = np.abs(want32 - want16) / np.abs(want16)
    print(f"\nbf16 20-step loss trajectory, relative to JAX bf16: port largest {mine.max():.3e} "
          f"(step {int(mine.argmax())}); JAX f32 largest {own.max():.3e}")
    assert (mine <= OWN_GAP_FACTOR * own + OWN_GAP_ABS).all(), (mine, own)
    assert got[-1] < got[0]
