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
    """16 + 16 ladder samples and 8 outside; ``renderer`` overrides any key."""
    rcfg = jr.RendererConfig(**{"n_samples": 16, "n_importance": 16, "n_outside": 8,
                                "up_sample_steps": 4, **renderer})
    return jr.NeuSNetworks(sdf=SDF, color=COLOR, nerf=NERF, renderer=rcfg)


def port_nets(nets: jr.NeuSNetworks) -> tr.NeuSNetworks:
    conv = lambda cls, cfg: cls(**dataclasses.asdict(cfg))  # noqa: E731
    return tr.NeuSNetworks(
        sdf=conv(tf.SDFConfig, nets.sdf), color=conv(tf.RenderConfig, nets.color),
        nerf=conv(tf.NeRFConfig, nets.nerf), renderer=conv(tr.RendererConfig, nets.renderer),
        depth=None if nets.depth is None else conv(tf.RenderConfig, nets.depth),
    )


def jax_params(nets: jr.NeuSNetworks, seed: int = 0, variance: float = 0.3) -> dict:
    return init_params(jax.random.PRNGKey(seed), nets, variance)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_model(nets: jr.NeuSNetworks, params, mlp_dtype) -> tr.NeuSModel:
    """The port's model holding JAX ``params``; ``mlp_dtype``: K2-K5's operand
    mode (``torch.bfloat16``, JAX's fused path, or ``torch.float32``)."""
    model = tr.NeuSModel(port_nets(nets), 0.3, torch.Generator().manual_seed(0),
                         mlp_dtype=mlp_dtype)
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
    """Both sides' fused-MLP matmul operands in f32 instead of bf16: JAX's
    Pallas kernels patched, and the port's operand mode, ``torch.float32``,
    returned for the test to pass to the port."""
    import jax.numpy as jnp

    from vdnerf_tpu.ops.pallas import fused_mlp as jax_fused

    monkeypatch.setattr(jax_fused, "_BF16", jnp.float32)
    return torch.float32


# --- the wavelet monodepth side-car -----------------------------------------

# a DenseNet small enough for the CPU (flax compiles the full ones slowly);
# tests register it under TINY_DENSENET in both packages' DENSENET_CONFIGS
TINY_DENSENET = 7
TINY_DENSENET_CFG = dict(growth=8, init_features=16, blocks=(2, 2, 2, 2))


@pytest.fixture(scope="module")
def tiny_densenet():
    """TINY_DENSENET in both packages' DENSENET_CONFIGS, for this module only."""
    from vdnerf_tpu.wavelet import encoders as jax_enc
    from vdnerf_tpu_torch.wavelet import encoders as port_enc

    with pytest.MonkeyPatch.context() as mp:
        for table in (jax_enc.DENSENET_CONFIGS, port_enc.DENSENET_CONFIGS):
            mp.setitem(table, TINY_DENSENET, TINY_DENSENET_CFG)
        yield TINY_DENSENET


def seeded_variables(shapes, seed: int = 0) -> dict:
    """numpy-seeded values for a flax variables tree of ``jax.eval_shape``
    leaves: conv kernels N(0, 1/fan_in), running variances U(0.5, 1.5),
    BatchNorm scales 1 + N(0, 0.1^2), biases and running means N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            return (rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_wavelet_variables(module, *inputs, seed: int = 0, **kwargs) -> dict:
    """Seeded variables of the flax ``module`` for ``inputs`` (shapes only:
    flax's own init compiles slowly on the CPU)."""
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a, **kwargs),
                            *inputs)
    return seeded_variables(shapes, seed)


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def nchw(x) -> np.ndarray:
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def nhwc(x) -> np.ndarray:
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.transpose(x, (0, 2, 3, 1))


@pytest.fixture
def jax_create_model_from_shapes(monkeypatch):
    """``vdnerf_tpu.wavelet.model.create_model`` with seeded variables made
    from shapes (for the JAX CLIs, which restore them from ``-ckpt``)."""
    from vdnerf_tpu.wavelet import model as jax_model

    def create_model(key, opts, input_hw=(224, 224)):
        model = jax_model.MonodepthModel(opts)
        x = jax.numpy.zeros((1, *input_hw, 3), jax.numpy.float32)
        return model, jax_wavelet_variables(model, x, seed=1, train=False)

    monkeypatch.setattr(jax_model, "create_model", create_model)
