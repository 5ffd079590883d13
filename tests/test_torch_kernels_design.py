"""The numerics and host-side planning of the redesigned kernels, on the CPU.

K1 runs its products as 3xTF32 on the tensor cores: each f32 operand x is
split into big = tf32(x), rounded to nearest with ties away from zero as
``cvt.rna.tf32.f32`` does, and small = x - big truncated to tf32 (both keep a
10-bit mantissa), and
small*big + big*small + big*big accumulate in f32. Here that split is
emulated in torch and the full-width K1 chain run through it, against the
plain f32 version (``K1_TOL`` = 1e-4, the card's tolerance) and against the
JAX package's Pallas kernel in interpret mode at small width (1e-5, the CPU
parity tolerance of ``test_torch_kernels.py``).

The wrappers' planning is pure host code and is held here: K1's rows per CTA
and weight packing, the dW contraction's row splits, and K3's transposed
weight packing. The kernels themselves are held against their plain versions
on the card in ``test_torch_cuda.py``.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdnerf_tpu.models.fields import SDFConfig, sdf_init
from vdnerf_tpu.ops.pallas.sdf_fwd import sdf_value_pallas
from vdnerf_tpu_torch.models.embedder import embed
from vdnerf_tpu_torch.models.layers import softplus_beta
from vdnerf_tpu_torch.ops.kernels import fused_mlp, sdf_fwd

K1_TOL = 1e-4
SDF_FULL = [(39, 256), (256, 256), (256, 256), (256, 217)] + [(256, 256)] * 4 + [(256, 1)]


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round half away from zero."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _trunc_tf32(x: torch.Tensor) -> torch.Tensor:
    """The low 13 mantissa bits cleared: tf32 by truncation."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's split: big rounded to nearest, small = x - big
    truncated."""
    big = _tf32(x)
    return big, _trunc_tf32(x - big)


def _mm_3xtf32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    (ab, as_), (wb, ws) = _split(a), _split(w)
    return as_ @ wb + ab @ ws + ab @ wb


def _sdf_value_3xtf32(pts, ws, bs, skip_in, multires, scale):
    """sdf_value_plain with every product as the kernel's three tf32 ones."""
    inputs = embed(pts * scale, multires)
    x = inputs
    for l, (w, b) in enumerate(zip(ws, bs)):
        if l in skip_in:
            x = torch.cat([x, inputs], dim=-1) / math.sqrt(2.0)
        x = _mm_3xtf32(x, w) + b
        if l < len(ws) - 1:
            x = softplus_beta(x, 100.0)
    return x[:, :1] / scale


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e4])
def test_tf32_split_reconstructs_f32(scale):
    x = torch.from_numpy(np.random.default_rng(0).normal(size=100_000).astype(np.float32)) * scale
    big, small = _split(x)
    # both halves are tf32 numbers: the 13 low mantissa bits are clear
    for h in (big, small):
        assert not bool((h.view(torch.int32) & 0x1FFF).any())
    assert bool(((big + small - x).abs() <= 2.0**-22 * x.abs()).all())
    # tf32 alone keeps ~2^-11: the split is what buys f32 accuracy
    assert float(((big - x).abs() / x.abs()).max()) > 2.0**-13


def test_tf32_rounds_half_away_from_zero():
    one = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 2.0**-12], dtype=torch.float32)
    assert _tf32(one).tolist() == [1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0]


def _full_width_sdf(seed):
    rng = np.random.default_rng(seed)
    ws = [torch.from_numpy((rng.normal(size=(k, n)) * np.sqrt(2.0 / n)).astype(np.float32))
          for k, n in SDF_FULL]
    bs = [torch.from_numpy((rng.normal(size=n) * 0.05).astype(np.float32)) for _, n in SDF_FULL]
    pts = torch.from_numpy(rng.uniform(-1, 1, size=(512, 3)).astype(np.float32))
    return pts, ws, bs


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1.0), (2, 3.0)])
def test_sdf_3xtf32_chain_full_width_within_k1_tol(seed, scale):
    pts, ws, bs = _full_width_sdf(seed)
    got = _sdf_value_3xtf32(pts, ws, bs, (4,), 6, scale)
    want = sdf_fwd.sdf_value_plain(pts, ws, bs, (4,), 6, scale)
    err = float((got - want).abs().max())
    assert err <= K1_TOL, err
    # plain tf32 products would not do: the split is needed for K1_TOL
    x = embed(pts * scale, 6)
    one = _tf32(x) @ _tf32(ws[0]) - x @ ws[0]
    assert float(one.abs().max()) > 1e-4


SDF_CFGS = [
    SDFConfig(d_hidden=64, n_layers=4, d_out=65, skip_in=(2,)),
    SDFConfig(d_hidden=32, n_layers=2, d_out=33, skip_in=()),
    SDFConfig(d_hidden=64, n_layers=4, d_out=65, skip_in=(2,), scale=2.0),
]


@pytest.mark.parametrize("cfg", SDF_CFGS)
def test_sdf_3xtf32_chain_matches_pallas(cfg):
    import jax

    from vdnerf_tpu.models.layers import effective_weight

    params = sdf_init(jax.random.PRNGKey(0), cfg)
    ws = [torch.tensor(np.asarray(effective_weight(p))) for p in params["layers"]]
    bs = [torch.tensor(np.asarray(p["b"])) for p in params["layers"]]
    ws[-1], bs[-1] = ws[-1][:, :1], bs[-1][:1]
    pts = np.random.default_rng(1).uniform(-1, 1, size=(301, 3)).astype(np.float32)
    want = np.asarray(sdf_value_pallas(cfg, params, jnp.asarray(pts), tile=128, interpret=True))
    got = _sdf_value_3xtf32(torch.from_numpy(pts), ws, bs, cfg.skip_in, cfg.multires,
                            cfg.scale).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("n,sms,rows", [
    (8192, 132, 32), (32768, 132, 64), (262144, 132, 64), (65536, 132, 64),
    (16896, 132, 64), (16832, 132, 32), (1, 132, 32), (8192, 64, 64)])
def test_k1_rows_per_cta(n, sms, rows):
    assert sdf_fwd.rows_per_cta(n, sms) == rows


@pytest.mark.parametrize("dims", [SDF_FULL, [(27, 32), (32, 32), (32, 1)], [(39, 64), (64, 25)]])
def test_k1_pack_weights(dims):
    rng = np.random.default_rng(5)
    ws = [torch.from_numpy(rng.normal(size=d).astype(np.float32)) for d in dims]
    bs = [torch.from_numpy(rng.normal(size=d[1]).astype(np.float32)) for d in dims]
    W, B, meta = sdf_fwd.pack_weights(ws, bs)
    woff = boff = 0
    for l, (w, b) in enumerate(zip(ws, bs)):
        K, N, Kp, Np, wo, bo = meta[6 * l: 6 * l + 6]
        assert (K, N) == tuple(w.shape) and Kp % 32 == 0 and Np % 32 == 0
        assert Kp - K < 32 and Np - N < 32 and (wo, bo) == (woff, boff) and wo % 4 == 0
        block = W[wo:wo + Kp * Np].view(Kp, Np)
        assert torch.equal(block[:K, :N], w) and not block[K:].any() and not block[:, N:].any()
        assert torch.equal(B[bo:bo + N], b) and not B[bo + N:bo + Np].any()
        woff, boff = woff + Kp * Np, boff + Np
    assert W.numel() == woff and B.numel() == boff


K3_LAYERS = [(289, 256, 304, 256), (256, 256, 256, 256), (256, 256, 256, 256),
             (256, 256, 256, 256), (256, 3, 256, 16)]
K5_LAYERS = ([(84, 256, 96, 256)] + [(256, 256, 256, 256)] * 4 + [(340, 256, 352, 256)]
             + [(256, 256, 256, 256)] * 2 + [(256, 257, 256, 272), (283, 128, 288, 128),
                                             (128, 3, 128, 16)])


def _layers(dims):
    out, woff, boff = [], 0, 0
    for K, N, Kp, Np in dims:
        out.append((K, N, Kp, Np, woff, boff))
        woff, boff = woff + Kp * Np, boff + Np
    return out


@pytest.mark.parametrize("dims", [K3_LAYERS, K5_LAYERS, [(70, 48, 80, 48), (48, 3, 48, 16)]])
@pytest.mark.parametrize("n", [1, 63, 64, 141, 8192, 16896, 49152, 65536, 65537])
def test_dw_plan_covers_every_padded_row_once(dims, n):
    sms = 132
    layers = _layers(dims)
    splits, rps = fused_mlp.dw_plan(n, layers, sms)
    n_pad = -(-n // 64) * 64
    assert rps % 64 == 0 and splits >= 1
    covered = np.zeros(n_pad, np.int64)
    for i in range(splits):
        begin, end = i * rps, min((i + 1) * rps, n_pad)
        assert begin < end  # no empty split
        covered[begin:end] += 1
    assert (covered == 1).all()
    out_tiles = sum(-(-Kp // 128) * -(-Np // 128) for _, _, Kp, Np, _, _ in layers)
    assert splits * out_tiles <= max(2 * sms, out_tiles)


def test_dw_plan_fills_the_card_at_the_training_shapes():
    # K3 at one step's 65,536 rows: 20 output tiles x 13 splits; K5 at 16,896
    # rows: 42 tiles x 6 splits -- about two CTAs per SM, one wave
    assert fused_mlp.dw_plan(65536, _layers(K3_LAYERS), 132) == (13, 5056)
    assert fused_mlp.dw_plan(16896, _layers(K5_LAYERS), 132) == (6, 2816)


@pytest.mark.parametrize("dims", [K3_LAYERS[:2], [(70, 48, 80, 48), (48, 3, 48, 16)]])
def test_k3_packed_weights_serve_both_products(dims):
    """K3 reads one packed copy of each layer: [Kp, Np] row-major bf16, zero
    padded, at offsets whose 16-byte chunks are aligned; the forward reads it
    MN-major (rows of Np), dx K-major (W^T's rows are W's rows)."""
    rng = np.random.default_rng(6)
    layers = [(torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)),
               torch.from_numpy(rng.normal(size=N).astype(np.float32))) for K, N, _, _ in dims]
    W, B, layer_meta = fused_mlp._pack(layers, torch.device("cpu"))
    meta = [len(layers)] + [0] * 10 + layer_meta
    assert W.dtype == torch.bfloat16 and B.dtype == torch.float32
    for (w, b), (K, N, Kp, Np, woff, boff), (_, _, Kp_want, Np_want) in zip(
            layers, fused_mlp._layers_of(meta), dims):
        assert (Kp, Np) == (Kp_want, Np_want) and woff * 2 % 16 == 0
        block = W[woff:woff + Kp * Np].view(Kp, Np)
        assert torch.equal(block[:K, :N], w.to(torch.bfloat16))
        assert not block[K:].any() and not block[:, N:].any()
        assert torch.equal(B[boff:boff + N], b) and not B[boff + N:boff + Np].any()
