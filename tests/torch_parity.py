"""Shared set-up for the port's parity tests (tests/test_torch_*.py).

Builds one set of small JAX networks and parameters from a seed and the
matching port model (weights carried by ``from_jax_params``), so each test
runs the JAX function and its port counterpart on the same inputs.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from vdnerf_tpu.models import fields as jf
from vdnerf_tpu.ops import renderer as jr
from vdnerf_tpu.train.builder import init_params
from vdnerf_tpu_torch.io.checkpoints import from_jax_params
from vdnerf_tpu_torch.models import fields as tf
from vdnerf_tpu_torch.ops import renderer as tr

SDF = jf.SDFConfig(d_hidden=64, n_layers=4, d_out=65, skip_in=(2,), multires=6)
COLOR = jf.RenderConfig(d_feature=64, d_hidden=64, n_layers=2, multires_view=4)
NERF = jf.NeRFConfig(D=4, W=64, skips=(2,), multires=6, multires_view=2)


def jax_nets(**renderer) -> jr.NeuSNetworks:
    rcfg = jr.RendererConfig(n_samples=16, n_importance=16, n_outside=8,
                             up_sample_steps=4, **renderer)
    return jr.NeuSNetworks(sdf=SDF, color=COLOR, nerf=NERF, renderer=rcfg)


def port_nets(nets: jr.NeuSNetworks) -> tr.NeuSNetworks:
    conv = lambda cls, cfg: cls(**dataclasses.asdict(cfg))  # noqa: E731
    return tr.NeuSNetworks(
        sdf=conv(tf.SDFConfig, nets.sdf), color=conv(tf.RenderConfig, nets.color),
        nerf=conv(tf.NeRFConfig, nets.nerf), renderer=conv(tr.RendererConfig, nets.renderer),
    )


def jax_params(nets: jr.NeuSNetworks, seed: int = 0, variance: float = 0.3) -> dict:
    return init_params(jax.random.PRNGKey(seed), nets, variance)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_model(nets: jr.NeuSNetworks, params) -> tr.NeuSModel:
    model = tr.NeuSModel(port_nets(nets), 0.3, torch.Generator().manual_seed(0))
    model.load_state_dict(from_jax_params(to_numpy(params)))
    return model


def rays(n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Rays from a 3-unit shell toward the unit sphere, some grazing."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 3.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    target = rng.uniform(-0.9, 0.9, size=(n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in this module: the suite runs several
    test processes side by side, and torch's default of one thread per core
    in each oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def f32_matmuls(monkeypatch):
    """Both sides' fused-MLP matmul operands in f32 instead of bf16."""
    import jax.numpy as jnp

    from vdnerf_tpu.ops.pallas import fused_mlp as jax_fused
    from vdnerf_tpu_torch.ops.kernels import fused_mlp as port_fused

    monkeypatch.setattr(jax_fused, "_BF16", jnp.float32)
    monkeypatch.setattr(port_fused, "_MM_DTYPE", torch.float32)
    yield
