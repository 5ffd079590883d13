"""K2's host-side design on the CPU: the colour head's forward as the
redesigned kernel runs it.

K2 (``csrc/fused_mlp.cu``, ``render_fwd_kernel``) runs one product pass per
layer on 128-row tiles, each pass reading its weights slab by slab (32
reduction rows of up to 256 output columns) from a ring image the wrapper
gathers once per pack (``fused_mlp._render_pack``); layer 0's last slab is
half a slab where Kp is an odd multiple of 16, and the 3-wide output fills one
64-column chunk. Here the ring image is decoded at every pass's offset, the
kernel's pass schedule is emulated in f32 from that image against the plain
version (all three modes, ``d_out`` 3 and 96) and against the JAX package's
Pallas kernel in interpret mode, the shared-memory plan is pinned, and the
autograd Function is shown to hand K2's pack to K3. The kernel itself is
held against the plain version on the card in ``test_torch_cuda.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import f32_matmuls  # noqa: F401
from vdnerf_tpu.ops.pallas import fused_mlp as jfused
from vdnerf_tpu_torch.models.embedder import embed
from vdnerf_tpu_torch.ops.kernels import fused_mlp

CPU = torch.device("cpu")
# (multires_view, width of the concat without the feature) per mode
MODES = {"idr": (4, 3 + 27 + 3), "no_view_dir": (0, 3 + 3), "no_normal": (4, 3 + 27)}
SMEM_MAX = 232_448


def _case(mode, d_out, n=77, width=256, d_feat=256, squeeze_out=True, seed=41):
    multires_view, d_small = MODES[mode]
    rng = np.random.default_rng(seed)
    dims = [(d_small + d_feat, width)] + [(width, width)] * 3 + [(width, d_out)]
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    ws = [f(rng.normal(size=d) / np.sqrt(d[0])) for d in dims]
    bs = [f(rng.normal(size=d[1]) * 0.05) for d in dims]
    x = [f(rng.normal(size=(n, 3))) for _ in range(3)] + [f(rng.normal(size=(n, d_feat)) * 0.5)]
    return (mode, multires_view, squeeze_out), x, ws, bs


def _slab_matrix(img, off, rows):
    """A ring stage's [rows, 32] weights (output column, reduction row), as
    the forward's MN-major core matrices hold them."""
    n, k = torch.arange(rows)[:, None], torch.arange(32)[None, :]
    return img[off + n // 8 * 256 + k // 8 * 64 + k % 8 * 8 + n % 8]


def _f32_pack(plan, x, ws, bs):
    """_render_pack's layout with the weights kept in f32."""
    W, B, meta = fused_mlp._render_meta(plan, x[3], ws, bs, CPU, torch.float32)
    return W, B, meta, fused_mlp._ring(W, meta, (fused_mlp.render_schedule(meta),))


def _emulate_k2(packed, plan, pts, nrm, dirs, feat):
    """K2's tile in torch, from the ring image: the concat into the input
    tile X [rows, Kp0], then each scheduled pass slab by slab (a half slab
    reads 16 reduction rows) into its 64-column chunks, pass 0 reading X and
    the later passes the hidden tile H, each hidden epilogue written in place
    over H's first Np columns; the output's bias and squash."""
    _, B, meta, (img, sched) = packed
    mode, multires_view, squeeze_out = plan
    layers = fused_mlp._layers_of(meta)
    x = fused_mlp._render_concat(pts, embed(dirs, multires_view), nrm, feat, mode)
    X = torch.zeros(x.shape[0], layers[0][2])
    X[:, :x.shape[1]] = x
    H = torch.zeros(x.shape[0], max((L[2] for L in layers[1:]), default=0))
    for q in range(sched[0]):
        a = X if q == 0 else H
        l, dx, n0, w, off = sched[1 + 5 * q: 6 + 5 * q]
        K, N, Kp, Np, _, boff = layers[l]
        rows = -(-w // 64) * 64
        acc = torch.zeros(x.shape[0], rows)
        for i in range(-(-Kp // 32)):
            kin = min(32, Kp - 32 * i)
            slab = _slab_matrix(img.float(), off + i * rows * 32, rows)
            acc += a[:, 32 * i: 32 * i + kin] @ slab[:, :kin].t()
        z = acc[:, :Np] + B[boff:boff + Np]
        if q + 1 < sched[0]:
            H[:, :Np] = torch.relu(z)
        else:
            return torch.sigmoid(z[:, :N]) if squeeze_out else torch.relu(z[:, :N])


@pytest.mark.parametrize("d_out", [3, 96])
def test_render_ring_image_holds_every_stage(d_out):
    """At every pass's offset, slab by slab, the image holds the layer's
    weights as the forward's wgmma descriptors read them, zero past the
    layer; the schedule is one pass per layer over its padded width."""
    plan, x, ws, bs = _case("idr", d_out)
    W, _, meta, (img, sched) = fused_mlp._render_pack(plan, x[3], ws, bs, CPU)
    layers = fused_mlp._layers_of(meta)
    passes = [tuple(sched[1 + 5 * i: 6 + 5 * i]) for i in range(sched[0])]
    assert [q[:4] for q in passes] == fused_mlp.render_schedule(meta)
    assert [q[:4] for q in passes] == [(l, 0, 0, L[3]) for l, L in enumerate(layers)]
    assert [L[2:4] for L in layers] == [(304, 256)] + [(256, 256)] * 3 + [(256, -(-d_out // 16) * 16)]
    end = 0
    for l, dx, n0, w, off in passes:
        _, _, Kp, Np, woff, _ = layers[l]
        Wl = W[woff:woff + Kp * Np].view(Kp, Np)
        rows, slabs = -(-w // 64) * 64, -(-Kp // 32)
        assert off == end and off % 8 == 0 and 0 < w <= 256
        for i in range(slabs):
            want = torch.zeros(rows, 32, dtype=W.dtype)
            k = min(32, Kp - 32 * i)
            want[:w, :k] = Wl[32 * i: 32 * i + k].t()
            assert torch.equal(_slab_matrix(img, off + i * rows * 32, rows), want)
        end = off + slabs * rows * 32
    # one image for the head: 576 KB of bf16 at d_out 3
    assert img.numel() == end and (d_out != 3 or img.numel() * 2 == 589_824)


@pytest.mark.parametrize("d_out", [3, 96])
@pytest.mark.parametrize("mode,squeeze_out", [("idr", True), ("no_view_dir", True),
                                              ("no_normal", False)])
def test_render_schedule_emulation_equals_plain(mode, squeeze_out, d_out):
    """K2's passes over the ring image, in f32, give the plain version's
    output at full width: layer 0 at Kp 304 (idr, a half last slab), 272
    (no_view_dir, half) and 288 (no_normal, whole)."""
    plan, x, ws, bs = _case(mode, d_out, squeeze_out=squeeze_out)
    got = _emulate_k2(_f32_pack(plan, x, ws, bs), plan, *x)
    want = fused_mlp.render_net_plain(plan, *x, ws, bs, mm=torch.float32)
    assert got.shape == want.shape == (x[0].shape[0], d_out)
    torch.testing.assert_close(got, want, atol=2e-5 * max(1.0, float(want.abs().max())),
                               rtol=1e-4)


@pytest.mark.parametrize("mode", list(MODES))
def test_render_emulation_matches_pallas_f32(f32_matmuls, mode):
    """The same emulation at a small width against the JAX package's Pallas
    forward in interpret mode, both with f32 operands."""
    plan, x, ws, bs = _case(mode, 3, n=61, width=48, d_feat=32, seed=42)
    got = _emulate_k2(_f32_pack(plan, x, ws, bs), plan, *x)
    jplan = (mode, jfused._freqs(plan[1]), plan[2], len(ws))
    want = np.asarray(jfused.render_net_fused(
        jplan, 32, *(jnp.asarray(t.numpy()) for t in x), [jnp.asarray(w.numpy()) for w in ws],
        [jnp.asarray(b.numpy()) for b in bs]))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("d_out", [3, 96])
def test_render_launch_plan_at_full_width(d_out):
    """One persistent CTA per SM (132 on the H100) in 225,344 bytes of shared
    memory: the 5-stage ring, layer 0's input tile [128, 304] and the hidden
    tile [128, 256] in bf16, seven mbarriers (padded to 16 bytes). Fewer CTAs than SMs only below
    132 tiles; every CTA gets a tile. The launcher takes the grid and the
    bytes as given, so they are held to the kernel's carve here."""
    plan, x, ws, bs = _case("idr", d_out, n=5)
    meta = fused_mlp._render_meta(plan, x[3], ws, bs, CPU)[2]
    _, smem = fused_mlp.render_launch_plan(meta, 1, 132)[::2]
    assert smem == 2 * (5 * 32 * 256 + 128 * (304 + 256)) + 64 == 225_344
    assert smem <= SMEM_MAX and smem % 16 == 0 and 2 * smem > SMEM_MAX
    # rows: a serving chunk, a step on each core width, few and ragged
    for n, ctas, most in ((393_216, 132, 24), (65_536, 132, 4), (49_152, 132, 3),
                          (393_216 + 37, 132, 24), (129, 2, 1), (128, 1, 1), (1, 1, 1)):
        rows, got, _ = fused_mlp.render_launch_plan(meta, n, 132)
        tiles = -(-n // rows)
        assert rows == 128 and got == ctas and -(-tiles // got) == most


def test_render_launch_plan_without_hidden_layers():
    """A one-layer head has no hidden tile: the carve is the ring and the
    input tile."""
    plan, x, _, _ = _case("no_view_dir", 3, n=5, d_feat=32)
    meta = fused_mlp._render_meta(plan, x[3], [torch.zeros(3 + 3 + 32, 3)], [torch.zeros(3)],
                                  CPU)[2]
    assert fused_mlp.render_launch_plan(meta, 300, 132) == (128, 3, 2 * (5 * 8192 + 128 * 48) + 64)


def _stub_launches(monkeypatch, packs, seen):
    """The card's path of the autograd Function with its launches stubbed (no
    card here): K2's by the plain forward, K3's tile kernel and contraction
    by recorders. ``packs`` gets each packed W in order, ``seen`` the (W,
    layer list) of each launch of K3's tile kernel."""
    pack = fused_mlp._pack

    def counting_pack(*args, **kw):
        out = pack(*args, **kw)
        packs.append(out[0])
        return out

    class Scratch:
        def __init__(self, n, meta, device):
            self.layers = fused_mlp._layers_of(meta)

        def contract(self):
            pass

        def grads(self):
            return [(torch.zeros(K, N), torch.zeros(N)) for K, N, *_ in self.layers]

    def tile(ins, outs, W, B, meta, scratch):
        seen.append((W, fused_mlp._layers_of(meta)))
        for t in outs:
            t.zero_()

    def fwd_run(pts, normals, dirs, feat, packed):
        K, N = fused_mlp._layers_of(packed[2])[-1][:2]
        return torch.full((pts.shape[0], N), 0.5)

    monkeypatch.setattr(fused_mlp, "_on", lambda t, name: "cuda")
    monkeypatch.setattr(fused_mlp, "_pack", counting_pack)
    monkeypatch.setattr(fused_mlp, "_render_fwd_run", fwd_run)
    monkeypatch.setattr(fused_mlp, "_BwdScratch", Scratch)
    monkeypatch.setattr(fused_mlp, "_render_bwd_tile", tile)


def test_k3_takes_k2s_pack(monkeypatch):
    """Through the autograd Function on the card's path, the colour head is
    packed once per step: K3's tile kernel is launched on the W that K2's
    pack made (the launches stubbed, no card here)."""
    plan, x, ws, bs = _case("idr", 3, n=9, width=32, d_feat=16)
    packs, seen = [], []
    _stub_launches(monkeypatch, packs, seen)
    leaves = [t.clone().requires_grad_(True) for t in ws + bs]
    out = fused_mlp.render_net(plan, *x, leaves[:len(ws)], leaves[len(ws):], torch.bfloat16)
    torch.autograd.grad(out.sum(), leaves)
    assert len(packs) == 1 and len(seen) == 1 and seen[0][0] is packs[0]


def test_each_head_hands_k3_its_own_pack(monkeypatch):
    """A wdepth step runs K2 twice (the depth head, then the colour head) and
    K3 twice: each head is packed once, and each K3 launch reads the pack of
    its own head's K2, whatever order autograd runs the two backwards in."""
    plan, x, ws, bs = _case("idr", 96, n=9, width=32, d_feat=16)
    _, _, cws, cbs = _case("idr", 3, n=9, width=32, d_feat=16, seed=42)
    packs, seen = [], []
    _stub_launches(monkeypatch, packs, seen)
    depth_leaves = [t.clone().requires_grad_(True) for t in ws + bs]
    color_leaves = [t.clone().requires_grad_(True) for t in cws + cbs]
    feats = fused_mlp.render_net(plan, *x, depth_leaves[:5], depth_leaves[5:], torch.bfloat16)
    rgb = fused_mlp.render_net(plan, *x, color_leaves[:5], color_leaves[5:], torch.bfloat16)
    torch.autograd.grad(feats.sum() + rgb.sum(), depth_leaves + color_leaves)
    assert len(packs) == 2 and len(seen) == 2
    assert {id(w) for w, _ in seen} == {id(w) for w in packs}
    for w, layers in seen:  # the depth head's pack came first, with 96 outputs
        assert (w is packs[0]) == (layers[-1][1] == 96)


def test_depth_before_color_is_refused_before_launch(monkeypatch):
    """At full width, ``depth_before_color`` widens the colour head's input to
    289 + 96 = 385 (400 padded): at K2's 5 ring stages its plan would need
    249,920 bytes of shared memory, past the 232,448 a block has, so the plan
    takes 3 stages (217,136 bytes), the most that fit. A first layer too wide
    for even 3 stages (449 inputs, 464 padded) is refused with a ValueError
    before any launch, and the wrapper never falls back to the plain
    version."""
    plan, x, ws, bs = _case("idr", 3, n=5, d_feat=256 + 96)
    meta = fused_mlp._render_meta(plan, x[3], ws, bs, CPU)[2]
    with pytest.raises(ValueError, match=r"385 inputs \(padded to 400\) needs 249920 bytes.*232448"):
        fused_mlp.render_launch_plan(meta, 5, 132, stages=5)
    assert fused_mlp.render_ring_stages(meta) == 3
    assert fused_mlp.render_launch_plan(meta, 5, 132) == (128, 1, 217_136)
    assert 2 * (3 * 32 * 256 + 128 * (400 + 256)) + 48 == 217_136
    calls = []
    monkeypatch.setattr(fused_mlp, "_on", lambda t, name: "cuda")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: type("P", (), {"multi_processor_count": 132}))
    monkeypatch.setattr(fused_mlp.build, "library", lambda name: calls.append(name))
    monkeypatch.setattr(fused_mlp, "render_net_plain", lambda *a: calls.append("plain"))
    plan, x, ws, bs = _case("idr", 3, n=5, d_feat=449 - 33)
    with pytest.raises(ValueError, match=r"449 inputs \(padded to 464\).*3 ring stages"):
        fused_mlp.render_net(plan, *x, ws, bs, torch.bfloat16)
    assert calls == []
    # the widest first layer K2 takes at 5 stages: 320 padded inputs
    plan, x, ws, bs = _case("idr", 3, n=5, d_feat=320 - 33)
    meta = fused_mlp._render_meta(plan, x[3], ws, bs, CPU)[2]
    assert fused_mlp.render_ring_stages(meta) == 5
    assert fused_mlp.render_launch_plan(meta, 5, 132)[2] == 229_440
