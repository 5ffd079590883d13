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
weight packing. K4 and K5 pack the background NeRF's layers in their own order
([feature | alpha], the skip input as [h | emb_pts]) and run their products
in passes of at most 256 columns: a torch emulation of that order and
schedule on the packed weights equals the plain versions, the packed
gradients map back to the JAX order exactly, and the ring image that feeds
their weight ring, the product schedule and the shared-memory plan are held
here too. The kernels themselves are held against their plain versions on
the card in ``test_torch_cuda.py``.
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
# the wdepth recipe's depth head: the same net with 96 outputs
K3_DEPTH_LAYERS = K3_LAYERS[:4] + [(256, 96, 256, 96)]
K5_LAYERS = ([(84, 256, 96, 256)] + [(256, 256, 256, 256)] * 4 + [(340, 256, 352, 256)]
             + [(256, 256, 256, 256)] * 2 + [(256, 257, 256, 272), (283, 128, 288, 128),
                                             (128, 3, 128, 16)])


def _layers(dims):
    out, woff, boff = [], 0, 0
    for K, N, Kp, Np in dims:
        out.append((K, N, Kp, Np, woff, boff))
        woff, boff = woff + Kp * Np, boff + Np
    return out


@pytest.mark.parametrize("dims", [K3_LAYERS, K5_LAYERS, [(70, 48, 80, 48), (48, 3, 48, 16)],
                                  K3_DEPTH_LAYERS])
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
    # the depth head's 256 x 96 output layer is two 128x128 tiles, as the
    # colour head's 256 x 16: the same 20 tiles x 13 splits at 65,536 rows,
    # and at the resampled core's 49,152
    assert fused_mlp.dw_plan(65536, _layers(K3_DEPTH_LAYERS), 132) == (13, 5056)
    assert fused_mlp.dw_plan(49152, _layers(K3_DEPTH_LAYERS), 132) == (13, 3840)


@pytest.mark.parametrize("d_out", [3, 96])
def test_bwd_scratch_at_full_width(monkeypatch, d_out):
    """K3's scratch as _BwdScratch sizes it from the packed colour head
    (d_out 3) and depth head (d_out 96): acts [n_pad, sum Kp], dels and the
    db partials [., sum Np] with the output layer at its padded width (16 or
    96 columns, not a 64-column chunk), dW [sum Kp Np]; the gradients come
    back at each layer's [K, N]."""
    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: Props)
    rng = np.random.default_rng(8)
    dims = [(289, 256)] + [(256, 256)] * 3 + [(256, d_out)]
    ws = [torch.from_numpy(rng.normal(size=d).astype(np.float32)) for d in dims]
    bs = [torch.zeros(d[1]) for d in dims]
    meta = fused_mlp._render_meta(("idr", 4, True), torch.zeros(1, 256), ws, bs,
                                  torch.device("cpu"))[2]
    sc = fused_mlp._BwdScratch(1000, meta, torch.device("cpu"))
    np_out = 16 if d_out == 3 else 96
    assert sc.acts.shape == (1024, 304 + 4 * 256) and sc.dels.shape == (1024, 4 * 256 + np_out)
    assert sc.dbpart.shape == (16, 4 * 256 + np_out)
    assert sc.dW.numel() == 304 * 256 + 3 * 256 * 256 + 256 * np_out
    assert (sc.splits, sc.rows_per_split) == fused_mlp.dw_plan(1000, sc.layers, 132)
    assert [tuple(dw.shape) for dw, _ in sc.grads()] == dims
    assert [tuple(db.shape) for _, db in sc.grads()] == [(n,) for _, n in dims]


@pytest.mark.parametrize("dims", [K3_LAYERS[:2], [(70, 48, 80, 48), (48, 3, 48, 16)],
                                  K3_DEPTH_LAYERS[3:]])
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


# ---------------------------------------------------------------------------
# K4/K5: the packed NeRF layer order, emulated
# ---------------------------------------------------------------------------


def _nerf_setup(rng, n, has_dpt, W=32, D=4, skips=(2,), multires=4, multires_view=2):
    e_pts, e_view = 4 * (1 + 2 * multires), 3 * (1 + 2 * multires_view)

    def lin(k, m):
        return (torch.from_numpy((rng.normal(size=(k, m)) / np.sqrt(k)).astype(np.float32)),
                torch.from_numpy((rng.normal(size=m) * 0.05).astype(np.float32)))

    trunk = [lin(e_pts, W)] + [lin(W + e_pts if i - 1 in skips else W, W) for i in range(1, D)]
    heads = [lin(W, 1), lin(W, W), lin(W + e_view, W // 2), lin(W // 2, 3)]
    if has_dpt:
        heads.append(lin(W // 2, 7))
    p = rng.normal(size=(n, 3))
    pts = np.concatenate([p / np.linalg.norm(p, axis=-1, keepdims=True),
                          rng.uniform(0, 1, size=(n, 1))], -1)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    gs = [f(rng.normal(size=(n, k))) for k in ([1, 3, 7] if has_dpt else [1, 3])]
    plan = (multires, multires_view, skips, D, has_dpt)
    weights = ([w for w, _ in trunk], [b for _, b in trunk], [w for w, _ in heads],
               [b for _, b in heads])
    return plan, f(pts), f(rng.normal(size=(n, 3))), weights, gs


def _emulate_nerf(packed, pts, views, g_alpha, g_rgb, g_dpt, max_out):
    """The K4/K5 tile schedule in torch on weights packed by _nerf_meta: the
    [h | emb_pts] skip input, [feature | alpha] with alpha as a per-row dot,
    dx in passes of ``max_out`` output columns, relu masks from the forward.
    -> (alpha, rgb, dpt, d_pts, d_views, per packed layer (dW, db))."""
    Wp, Bp, meta = packed
    layers = fused_mlp._layers_of(meta)
    mats = [(Wp[wo:wo + Kp * Np].view(Kp, Np), Bp[bo:bo + Np]) for _, _, Kp, Np, wo, bo in layers]
    multires, mv, d_a, skip_mask, T, d_rgb, d_dpt = (meta[k] for k in (3, 4, 5, 7, 8, 9, 10))
    skip = lambda i: (skip_mask >> i) & 1  # noqa: E731
    emb_pts, emb_view = embed(pts, multires), embed(views, mv)
    e_a, e_b = emb_pts.shape[1], emb_view.shape[1]
    wt, wf = layers[0][1], layers[T][1] - 1
    n, lda = pts.shape[0], max(max(L[2], L[3]) for L in layers)

    a = torch.zeros(n, lda)
    a[:, :e_a] = emb_pts
    acts, masks = [], {}
    for l in range(T + 2):
        (w, b), Kp, Np = mats[l], layers[l][2], layers[l][3]
        acts.append(a[:, :Kp].clone())
        z = a[:, :Kp] @ w
        a = torch.zeros(n, lda)
        if l == T:
            alpha = z[:, wf:wf + 1] + b[wf]
            a[:, :wf] = z[:, :wf] + b[:wf]
            a[:, wf:wf + e_b] = emb_view
        else:
            h = torch.relu(z + b)
            masks[l if l < T else T] = (h > 0).float()
            a[:, :Np] = h
            if l < T and skip(l):
                a[:, wt:wt + e_a] = emb_pts
    (w, b), Kp = mats[T + 2], layers[T + 2][2]
    acts.append(a[:, :Kp].clone())
    out = a[:, :Kp] @ w + b
    rgb, dpt = out[:, :d_rgb], out[:, d_rgb:d_rgb + d_dpt] if d_dpt else None

    def dx(l, delta):
        w, Kp = mats[l][0], layers[l][2]
        return torch.cat([delta @ w[n0:n0 + max_out].t() for n0 in range(0, Kp, max_out)], 1)

    dels = [None] * (T + 3)
    delta = torch.zeros(n, layers[T + 2][3])
    delta[:, :d_rgb] = g_rgb
    if d_dpt:
        delta[:, d_rgb:d_rgb + d_dpt] = g_dpt
    dels[T + 2] = delta
    delta = dx(T + 2, delta)[:, :layers[T + 1][3]] * masks[T]
    dels[T + 1] = delta
    d = dx(T + 1, delta)
    d_views = fused_mlp._d_embed(d[:, wf:wf + e_b], views, mv)
    delta = torch.zeros(n, layers[T][3])
    delta[:, :wf], delta[:, wf:wf + 1] = d[:, :wf], g_alpha
    dels[T] = delta
    d = dx(T, delta)
    d_emb = torch.zeros(n, e_a)
    for i in range(T - 1, -1, -1):
        delta = d[:, :layers[i][3]] * masks[i]
        dels[i] = delta
        d = dx(i, delta)
        if i == 0:
            d_emb = d_emb + d[:, :e_a]
        elif skip(i - 1):
            d_emb = d_emb + d[:, wt:wt + e_a]
    d_pts = fused_mlp._d_embed(d_emb, pts, multires)
    grads = [((x.t() @ dl)[:K, :N], dl.sum(0)[:N])
             for x, dl, (K, N, _, _, _, _) in zip(acts, dels, layers)]
    return alpha, rgb, dpt, d_pts, d_views, grads


def _close(got, want):
    torch.testing.assert_close(got, want, atol=2e-5 * max(1.0, float(want.abs().max())),
                               rtol=1e-4)


@pytest.mark.parametrize("has_dpt", [False, True])
@pytest.mark.parametrize("max_out", [256, 16])
def test_nerf_packed_order_emulation_equals_plain(has_dpt, max_out):
    """K4/K5's layer order and pass schedule, in f32, give the plain version's
    outputs and (through nerf_grads_from_packed) its gradients."""
    plan, pts, views, weights, gs = _nerf_setup(np.random.default_rng(31), 77, has_dpt)
    packed = fused_mlp._nerf_meta(plan, 4, *weights, torch.device("cpu"), dtype=torch.float32)
    g_dpt = gs[2] if has_dpt else None
    alpha, rgb, dpt, d_pts, d_views, grads = _emulate_nerf(packed, pts, views, gs[0], gs[1],
                                                           g_dpt, max_out)
    want = fused_mlp.nerf_plain(plan, pts, views, *weights, mm=torch.float32)
    for g, w in zip((alpha, rgb, dpt), want):
        assert (g is None) == (w is None)
        if w is not None:
            _close(g, w)
    want = fused_mlp.nerf_bwd_plain(plan, pts, views, *weights, *gs, mm=torch.float32)
    got = (d_pts, d_views, *fused_mlp.nerf_grads_from_packed(packed[2], grads))
    for g, w in zip(got, want):
        for a, b in zip(g if isinstance(g, list) else [g], w if isinstance(w, list) else [w]):
            assert a.shape == b.shape
            _close(a, b)


@pytest.mark.parametrize("has_dpt", [False, True])
@pytest.mark.parametrize("skips", [(2,), (0, 2)])
def test_nerf_packed_gradients_map_back_exactly(has_dpt, skips):
    """Gradients laid out as _nerf_meta lays out the weights come back in the
    JAX order bit for bit: packing the plain version's own gradients and
    mapping them back is the identity."""
    plan, pts, views, weights, gs = _nerf_setup(np.random.default_rng(32), 33, has_dpt,
                                                skips=skips)
    want = fused_mlp.nerf_bwd_plain(plan, pts, views, *weights, *gs, mm=torch.bfloat16)
    W, B, meta = fused_mlp._nerf_meta(plan, 4, *want[2:], torch.device("cpu"),
                                      dtype=torch.float32)
    packed = [(W[wo:wo + Kp * Np].view(Kp, Np)[:K, :N], B[bo:bo + N])
              for K, N, Kp, Np, wo, bo in fused_mlp._layers_of(meta)]
    got = fused_mlp.nerf_grads_from_packed(meta, packed)
    for g, w in zip(got, want[2:]):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert torch.equal(a, b)


def _full_nerf_meta(has_dpt):
    rng = np.random.default_rng(33)
    dims = [(84, 256)] + [(256, 256)] * 4 + [(340, 256)] + [(256, 256)] * 2
    heads = [(256, 1), (256, 256), (283, 128), (128, 3)] + ([(128, 96)] if has_dpt else [])
    mk = lambda ds: ([torch.from_numpy(rng.normal(size=d).astype(np.float32)) for d in ds],  # noqa: E731
                     [torch.zeros(d[1]) for d in ds])
    (tw, tb), (hw, hb) = mk(dims), mk(heads)
    return fused_mlp._nerf_meta((10, 4, (4,), 8, has_dpt), 4, tw, tb, hw, hb,
                                torch.device("cpu"))


@pytest.mark.parametrize("has_dpt", [False, True])
def test_nerf_launch_plan_at_full_width(has_dpt):
    """K4 at 128 rows per CTA, K5's tile kernel at 64, both within the 232,448
    bytes of shared memory a CTA may have (one CTA per SM); the row counts of
    a training step and of a serving chunk. The launchers take these bytes as
    given, so the two sizes are held to what the kernels carve."""
    _, _, meta = _full_nerf_meta(has_dpt)
    assert fused_mlp.nerf_launch_plan(meta, False) == (128, 222_256)
    assert fused_mlp.nerf_launch_plan(meta, True) == (64, 210_736)
    for bwd, n, ctas in ((False, 16_896, 132), (False, 135_168, 1_056), (True, 16_896, 264)):
        rows, smem = fused_mlp.nerf_launch_plan(meta, bwd)
        assert -(-n // rows) == ctas and smem <= 232_448
    # [feature | alpha] (257 wide) and the dpt head (99 wide) are packed as
    # 272 and 112 columns; the skip layer takes [h | emb_pts], 340 rows
    K, N, Kp, Np = fused_mlp._layers_of(meta)[8][:4]
    assert (K, N, Kp, Np) == (256, 257, 256, 272)
    assert fused_mlp._layers_of(meta)[5][:3] == (340, 256, 352)
    assert fused_mlp._layers_of(meta)[10][3] == (112 if has_dpt else 16)


def test_dw_plan_at_k5_tile_height():
    """K5's tile kernel keeps 64-row tiles, the contraction's row unit: its
    db partials are one row per tile, and every padded row is in one split."""
    layers = _layers(K5_LAYERS)
    n = 16_896 + 37
    splits, rps = fused_mlp.dw_plan(n, layers, 132)
    n_pad = -(-n // 64) * 64
    assert fused_mlp.nerf_launch_plan(_full_nerf_meta(False)[2], True)[0] == 64
    assert rps % 64 == 0 and (splits - 1) * rps < n_pad <= splits * rps


@pytest.mark.parametrize("has_dpt", [False, True])
def test_nerf_ring_image_holds_every_stage(has_dpt):
    """K4/K5 fill each ring stage with one bulk copy from the ring image: at
    every pass's offset, slab by slab, the image holds the layer's weights in
    the core-matrix layout the wgmma descriptors read (forward MN-major, dx
    K-major), zero past the layer; the schedules name each pass once."""
    W, _, meta = _full_nerf_meta(has_dpt)
    img, s4, s5 = fused_mlp._nerf_ring(W, meta)
    layers = fused_mlp._layers_of(meta)
    for sched, bwd, n_prod in ((s4, False, 11), (s5, True, 23)):
        passes = [tuple(sched[1 + 5 * i: 6 + 5 * i]) for i in range(sched[0])]
        assert [q[:4] for q in passes] == fused_mlp.nerf_schedule(meta, bwd)
        assert len(passes) == n_prod
        for l, dx, n0, w, off in passes:
            _, _, Kp, Np, woff, _ = layers[l]
            Wl = W[woff:woff + Kp * Np].view(Kp, Np)
            rows, kin = -(-w // 64) * 64, Np if dx else Kp
            slabs = -(-kin // 32)
            n, k = torch.arange(rows)[:, None], torch.arange(slabs * 32)[None, :]
            kk = k % 32
            inner = n % 8 * 8 + kk % 8 if dx else kk % 8 * 8 + n % 8
            pos = off + k // 32 * rows * 32 + n // 8 * 256 + kk // 8 * 64 + inner
            want = torch.zeros(rows, slabs * 32, dtype=W.dtype)
            if dx:
                want[:w, :Np] = Wl[n0:n0 + w]
            else:
                want[:w, :Kp] = Wl[:, n0:n0 + w].t()
            # what the launchers check of a pass they take as given
            assert 0 < w <= 256 and n0 + w <= (Kp if dx else Np)
            assert off % 8 == 0 and torch.equal(img[pos], want)
