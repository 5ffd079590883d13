"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit.
2. Builds the port's CUDA kernels (K1 sdf_fwd; K2 render_fwd, K3 render_bwd,
   K4 nerf_fwd, K5 nerf_bwd) from the sources in this checkout, one nvcc per
   source, in parallel.
3. Kernel phase: holds each kernel against its plain PyTorch version on the
   card at the full ``confs/womsk_white_tpu.conf`` widths, at the row counts
   one 4096-ray chunk (K1, K2, K4) or one 512-ray training step (K1's ladder,
   K3, K5) gives it plus a ragged tail, and times kernel and plain version
   with CUDA events. ``ms`` is the wrapper's call, as the main path makes it
   (packing the weights and allocating each call); K1, K3 and K5 also give
   ``kernel_ms``, their launches alone on weights packed once. K1 also holds
   the plain version's division by 100 on the card against the kernel's
   multiply by 0.01f. Then the dW contraction that K3 and K5 share, alone on
   the scratch their launches left: held against f32 matmuls of the same bf16
   operands, two launches bit-identical, timed beside its plain version and a
   bf16 ``torch.matmul`` per layer (the library yardstick, never called by
   the port).
4. Slice phase: writes a scene (8 views of 400x300 of a shaded sphere), the
   conf with only its paths rewritten and a seeded full-width geometric-init
   ``ckpt_000000.pth``, then runs ``valimg_0`` and ``getfeats_0`` through the
   port's CLI on ``cuda`` with the launch counts set to 0 just before and read
   just after. Fails if a forward kernel was not launched.
5. Output check: the summaries are finite, every depth ``.npy`` was written at
   full resolution, and a 512-ray render through the kernels agrees with the
   same render through the plain versions on the CPU.
6. Training phase: ``--mode train`` through the CLI at full width, 40 steps
   across ``resample_from`` (only the paths and five ``train`` keys
   rewritten), launch counts set to 0 before and read after (fails unless all
   five kernels ran); checks finite logged losses, the checkpoints, that every
   network moved, and that ``valimg_40`` from the last checkpoint gives the
   run's closing summary. Then times steps per core width.
7. Gradient check: one full-width step on 128 rays through the kernels on the
   card against the plain versions on the CPU.
8. Prints one ``{"kernels": [...]}`` line (the five kernels and the
   contraction), then the last line
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero and prints no result. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published dense peaks at the 700 W limit (NVIDIA data sheet)
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_BF16_S = 989e12
PEAK_TF32_S = 495e12

# rows per 4096-ray chunk at womsk_white_tpu: ladder 64 + 3 x 16 per ray
# (the last round's SDF call is skipped at resample_uniform_frac = 1.0), the
# 96-sample resampled core, 32 outside samples + 1 with skip_bg_inside; K1
# also at the ladder's rows of one 512-ray training step
CHUNK = 4096
BATCH = 512
K1_ROWS = (CHUNK * 64, CHUNK * 16, BATCH * 64, BATCH * 16)
K2_ROWS = CHUNK * 96
K4_ROWS = CHUNK * 33
RAGGED = 37
# rows per training step (batch 512): the backward of the colour head over
# the faithful 128-sample core (96 after resample_from), and of the
# background NeRF over 32 outside samples + 1
K3_ROWS = BATCH * 128
K5_ROWS = BATCH * 33

# K1 is f32 throughout: the kernel and torch differ in summation order and in
# the last ulp of exp/log1p/sin/cos. K2/K4 round every matmul operand to bf16
# on both sides, so a last-ulp difference upstream can flip one rounding and
# cascade: two bf16 ulps at the output's scale.
K1_TOL = 1e-4


def bf16_tol(ref) -> float:
    return 2.0**-7 * max(1.0, float(ref.abs().max()))


# K3/K5: each output (input cotangents, dW, db) within 2^-6 relative L2
# error of its plain version. Both round every layer's delta to bf16, but in
# another summation order; once a row takes one rounding (or a relu kink) the
# other way its later values drift by ~1e-4 and round differently again, so
# the two differ by about a bf16 ulp (2^-8) times the square root of the
# depth (5 layers for K3, 11 for K5); the point embedding's VJP multiplies
# K5's d(pts) by up to 2^9. The log prints the plain version's own distance
# from its f32-operand twin beside it, the size of that rounding noise.
BWD_L2_TOL = 2.0**-6


REPLACES = {
    "sdf_fwd": "vdnerf_tpu/ops/pallas/sdf_fwd.py:114",
    "render_fwd": "vdnerf_tpu/ops/pallas/fused_mlp.py:272",
    "nerf_fwd": "vdnerf_tpu/ops/pallas/fused_mlp.py:518",
    "render_bwd": "vdnerf_tpu/ops/pallas/fused_mlp.py:314",
    "nerf_bwd": "vdnerf_tpu/ops/pallas/fused_mlp.py:575",
    # the dW half of K3 and K5 (_mm_dw inside _render_kernel_bwd/_nerf_kernel_bwd)
    "dw_contract": "vdnerf_tpu/ops/pallas/fused_mlp.py:112",
}
SOURCE = {
    "sdf_fwd": "vdnerf_tpu_torch/ops/kernels/csrc/sdf_fwd.cu",
    "render_fwd": "vdnerf_tpu_torch/ops/kernels/csrc/fused_mlp.cu",
    "nerf_fwd": "vdnerf_tpu_torch/ops/kernels/csrc/fused_mlp.cu",
    "render_bwd": "vdnerf_tpu_torch/ops/kernels/csrc/fused_mlp.cu",
    "nerf_bwd": "vdnerf_tpu_torch/ops/kernels/csrc/fused_mlp.cu",
    "dw_contract": "vdnerf_tpu_torch/ops/kernels/csrc/fused_mlp.cu",
}

SCENE_VIEWS, SCENE_H, SCENE_W = 8, 300, 400


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(rows: int, flops_row: int, io_bytes_row: int, weight_bytes: int, peak_ops: float):
    """(bound_ms, bound_by): each input read once, each output written once."""
    t_bytes = (rows * io_bytes_row + weight_bytes) / PEAK_BYTES_S
    t_ops = rows * flops_row / peak_ops
    return max(t_bytes, t_ops) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _weights(gen, dims, device, std_from_out=False):
    """Random effective [in, out] weights and small biases."""
    import torch

    ws, bs = [], []
    for k, n in dims:
        std = math.sqrt(2.0 / n) if std_from_out else 1.0 / math.sqrt(k)
        ws.append((torch.randn(k, n, generator=gen) * std).to(device))
        bs.append((torch.randn(n, generator=gen) * 0.05).to(device))
    return ws, bs


def _compare(name, got, want, tol_fn) -> float:
    """Each output against its plain version within tol_fn(plain) -> the
    largest abs error."""
    import torch

    torch.cuda.synchronize()
    pairs = [(g, w) for g, w in zip(got, want) if w is not None]
    err = max(float((g - w).abs().max()) for g, w in pairs)
    tol = max(tol_fn(w) for _, w in pairs)
    finite = all(bool(torch.isfinite(g).all()) for g, _ in pairs)
    scale = max(float(w.abs().max()) for _, w in pairs)
    print(f"[kernel] {name}: rows={pairs[0][1].shape[0]} max_abs_err={err:.3e} "
          f"tol={tol:.3e} max|plain|={scale:.3e} finite={finite}")
    if not finite or not err <= tol:
        raise SystemExit(f"{name}: the kernel disagrees with its plain version")
    return err


def _rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _compare_bwd(name, got, again, want, want32) -> float:
    """A backward kernel's outputs against the plain version within
    BWD_L2_TOL relative L2 error each, and two launches bit for bit equal ->
    the largest abs error. ``want32``: the plain version with f32 operands."""
    import torch

    torch.cuda.synchronize()
    errs, worst = [], (0.0, "")
    for i, (g, a, w, w32) in enumerate(zip(got, again, want, want32)):
        if not bool(torch.isfinite(g).all()) or not torch.equal(g, a):
            raise SystemExit(f"{name} #{i}: not finite, or two launches differ")
        errs.append(float((g - w).abs().max()))
        rel, noise = _rel_l2(g, w), _rel_l2(w, w32)
        worst = max(worst, (rel, f"#{i} {tuple(w.shape)} (plain vs f32 operands {noise:.3e})"))
        if not rel <= BWD_L2_TOL:
            raise SystemExit(f"{name} #{i}: relative L2 error {rel:.3e} > {BWD_L2_TOL:.3e}")
    print(f"[kernel] {name}: rows={want[0].shape[0]} tensors={len(errs)} "
          f"max_abs_err={max(errs):.3e} worst rel L2 error {worst[0]:.3e} at {worst[1]} "
          f"(tol {BWD_L2_TOL:.3e}); two launches bit-identical")
    return max(errs)


def _bwd_runs(kernel, plain, args):
    """(kernel, kernel again, plain, plain with f32 operands) on args."""
    import torch

    from vdnerf_tpu_torch.ops.kernels import fused_mlp

    got, again, want = kernel(*args), kernel(*args), plain(*args)
    dtype = fused_mlp._MM_DTYPE
    fused_mlp._MM_DTYPE = torch.float32
    try:
        want32 = plain(*args)
    finally:
        fused_mlp._MM_DTYPE = dtype
    return got, again, want, want32


def kernel_phase(device) -> dict:
    """Each kernel against its plain version at full width -> {name: record}."""
    import torch

    from vdnerf_tpu_torch.ops.kernels import fused_mlp, sdf_fwd

    gen = torch.Generator().manual_seed(0)
    rec = {}

    # K1: SDF 8x256, skip at 4, multires 6 -> 39-ch embedding; sdf column only
    sdf_dims = [(39, 256), (256, 256), (256, 256), (256, 217)] + [(256, 256)] * 4 + [(256, 1)]
    ws, bs = _weights(gen, sdf_dims, device, std_from_out=True)
    sdf_args = (ws, bs, (4,), 6, 1.0)
    flops_row = 2 * sum(k * n for k, n in sdf_dims)
    wbytes = sum(w.numel() + b.numel() for w, b in zip(ws, bs)) * 4
    errs, shapes = [], []
    for rows in K1_ROWS:
        pts = (torch.rand(rows + RAGGED, 3, generator=gen) * 2 - 1).to(device)
        errs.append(_compare("sdf_fwd", [sdf_fwd.sdf_value(pts, *sdf_args)],
                             [sdf_fwd.sdf_value_plain(pts, *sdf_args)], lambda _: K1_TOL))
        pts = pts[:rows].contiguous()
        # the launch alone, on weights packed once
        W, B, meta = sdf_fwd._sdf_kernel_args(pts, *sdf_args[:4])
        out = torch.empty(rows, 1, device=device)
        # the kernel runs 3xTF32: three tensor-core products per f32 product
        b_ms, b_by = bound(rows, 3 * flops_row, (3 + 1) * 4, wbytes, PEAK_TF32_S)
        f32_ms, _ = bound(rows, flops_row, (3 + 1) * 4, wbytes, PEAK_F32_S)
        shapes.append({
            "rows": rows,
            "ms": time_ms(lambda: sdf_fwd.sdf_value(pts, *sdf_args)),
            "kernel_ms": time_ms(lambda: sdf_fwd._sdf_launch(pts, out, W, B, meta, 1.0)),
            "plain_ms": time_ms(lambda: sdf_fwd.sdf_value_plain(pts, *sdf_args)),
            "bound_ms": b_ms, "bound_by": b_by, "bound_f32_simt_ms": f32_ms,
        })
    # The kernel's softplus ends with a multiply by 0.01f where the plain
    # version divides by the Python float 100.0: on a CUDA tensor torch runs
    # that division as a multiply by the f32 reciprocal. Held bit for bit
    # here, beside how often a true IEEE division would differ.
    v = (torch.randn(1 << 20, generator=gen) * torch.exp(torch.rand(1 << 20, generator=gen) * -95
                                                          + 5)).to(device)
    as_plain = v / 100.0
    same = torch.equal(as_plain, v * torch.tensor(0.01, device=device))
    n_div = int((as_plain != torch.div(v, torch.full_like(v, 100.0))).sum())
    print(f"[kernel] sdf_fwd softplus scaling: torch's x / 100.0 on the card equals x * 0.01f "
          f"bit for bit: {same}; a true division differs at {n_div} of {v.numel()}")
    rec["sdf_fwd"] = {"max_abs_err": max(errs), "flops_row": flops_row, "shapes": shapes,
                      "plain_div_is_mul_by_0.01f": same}

    # K2: IDR colour head, 4x256, multires_view 4 -> 3 + 27 + 3 + 256 = 289 inputs
    r_dims = [(289, 256), (256, 256), (256, 256), (256, 256), (256, 3)]
    ws, bs = _weights(gen, r_dims, device)
    plan = ("idr", 4, True)

    def r_inputs(rows):
        t = [torch.randn(rows, 3, generator=gen) for _ in range(3)]
        t[2] = t[2] / t[2].norm(dim=-1, keepdim=True)
        feat = torch.randn(rows, 256, generator=gen) * 0.5
        return [x.to(device) for x in (*t, feat)]

    inp = r_inputs(K2_ROWS + RAGGED)
    err = _compare("render_fwd", [fused_mlp.render_net(plan, *inp, ws, bs)],
                   [fused_mlp.render_net_plain(plan, *inp, ws, bs)], bf16_tol)
    inp = [x[:K2_ROWS].contiguous() for x in inp]
    flops_row = 2 * sum(k * n for k, n in r_dims)
    wbytes = sum(w.numel() * 2 + b.numel() * 4 for w, b in zip(ws, bs))
    b_ms, b_by = bound(K2_ROWS, flops_row, (3 + 3 + 3 + 256 + 3) * 4, wbytes, PEAK_BF16_S)
    rec["render_fwd"] = {"max_abs_err": err, "flops_row": flops_row, "shapes": [{
        "rows": K2_ROWS,
        "ms": time_ms(lambda: fused_mlp.render_net(plan, *inp, ws, bs)),
        "plain_ms": time_ms(lambda: fused_mlp.render_net_plain(plan, *inp, ws, bs)),
        "bound_ms": b_ms, "bound_by": b_by,
    }]}

    # K4: background NeRF 8x256, skip after 4, d_in 4 multires 10 (84 ch),
    # views multires 4 (27 ch); heads alpha, feature, views0, rgb[, dpt 96]
    t_dims = [(84, 256)] + [(256, 256)] * 4 + [(340, 256)] + [(256, 256)] * 2
    tw, tb = _weights(gen, t_dims, device)
    h_dims = [(256, 1), (256, 256), (283, 128), (128, 3), (128, 96)]
    hw, hb = _weights(gen, h_dims, device)

    def n_inputs(rows):
        p = torch.randn(rows, 3, generator=gen)
        p = p / p.norm(dim=-1, keepdim=True)
        inv_r = torch.rand(rows, 1, generator=gen)
        v = torch.randn(rows, 3, generator=gen)
        v = v / v.norm(dim=-1, keepdim=True)
        return torch.cat([p, inv_r], -1).to(device), v.to(device)

    errs = []
    for has_dpt in (False, True):
        nplan = (10, 4, (4,), 8, has_dpt)
        heads = (hw, hb) if has_dpt else (hw[:4], hb[:4])
        pts4, views = n_inputs(K4_ROWS + RAGGED)
        errs.append(_compare(
            f"nerf_fwd(has_dpt={has_dpt})",
            list(fused_mlp.nerf(nplan, pts4, views, tw, tb, *heads)),
            list(fused_mlp.nerf_plain(nplan, pts4, views, tw, tb, *heads)), bf16_tol))
    nplan = (10, 4, (4,), 8, False)
    pts4, views = (x[:K4_ROWS].contiguous() for x in n_inputs(K4_ROWS))
    flops_row = 2 * (sum(k * n for k, n in t_dims) + sum(k * n for k, n in h_dims[:4]))
    wbytes = sum(w.numel() * 2 + b.numel() * 4 for w, b in zip(tw + hw[:4], tb + hb[:4]))
    b_ms, b_by = bound(K4_ROWS, flops_row, (4 + 3 + 1 + 3) * 4, wbytes, PEAK_BF16_S)
    rec["nerf_fwd"] = {"max_abs_err": max(errs), "flops_row": flops_row, "shapes": [{
        "rows": K4_ROWS,
        "ms": time_ms(lambda: fused_mlp.nerf(nplan, pts4, views, tw, tb, hw[:4], hb[:4])),
        "plain_ms": time_ms(lambda: fused_mlp.nerf_plain(nplan, pts4, views, tw, tb, hw[:4], hb[:4])),
        "bound_ms": b_ms, "bound_by": b_by,
    }]}

    # K3: the colour head's backward at one training step's core rows. A
    # backward recomputes the forward, then runs dx and dW products: three
    # times the forward's operations. Bytes: the inputs and g read once, the
    # input cotangents written once, bf16 weights read, f32 dW/db written.
    def flat(grads):
        return [t for x in grads for t in (x if isinstance(x, list) else [x])]

    inp = r_inputs(K3_ROWS + RAGGED)
    g = torch.randn(K3_ROWS + RAGGED, 3, generator=gen).to(device)
    err = _compare_bwd("render_bwd", *(flat(x) for x in _bwd_runs(
        fused_mlp._render_bwd_launch, fused_mlp.render_net_bwd_plain,
        (plan, *inp, ws, bs, g))))
    inp, g = [x[:K3_ROWS].contiguous() for x in inp], g[:K3_ROWS].contiguous()
    flops_row = 3 * 2 * sum(k * n for k, n in r_dims)
    wbytes = sum(w.numel() * 2 + b.numel() * 4 + (w.numel() + b.numel()) * 4 for w, b in zip(ws, bs))
    b_ms, b_by = bound(K3_ROWS, flops_row, (3 + 3 + 3 + 256 + 3 + 3 + 3 + 3 + 256) * 4, wbytes,
                       PEAK_BF16_S)
    # the launches alone (tile kernel, then the contraction), on weights packed
    # and scratch allocated once
    W, B, meta = fused_mlp._render_meta(plan, inp[3], ws, bs, device)
    sc3 = fused_mlp._BwdScratch(K3_ROWS, meta, device)
    outs = [torch.empty_like(x) for x in inp]

    def k3_launches():
        fused_mlp._render_bwd_tile((*inp, g), outs, W, B, meta, sc3)
        sc3.contract()

    rec["render_bwd"] = {"max_abs_err": err, "flops_row": flops_row, "shapes": [{
        "rows": K3_ROWS,
        "ms": time_ms(lambda: fused_mlp._render_bwd_launch(plan, *inp, ws, bs, g)),
        "kernel_ms": time_ms(k3_launches),
        "plain_ms": time_ms(lambda: fused_mlp.render_net_bwd_plain(plan, *inp, ws, bs, g)),
        "bound_ms": b_ms, "bound_by": b_by,
    }]}

    # K5: the background NeRF's backward at one training step's outside rows
    nplan = (10, 4, (4,), 8, False)
    pts4, views = n_inputs(K5_ROWS + RAGGED)
    gs = [torch.randn(K5_ROWS + RAGGED, k, generator=gen).to(device) for k in (1, 3)]
    nargs = (nplan, pts4, views, tw, tb, hw[:4], hb[:4])
    err = _compare_bwd("nerf_bwd", *(flat(x) for x in _bwd_runs(
        fused_mlp._nerf_bwd_launch, fused_mlp.nerf_bwd_plain, (*nargs, *gs))))
    pts4, views = (x[:K5_ROWS].contiguous() for x in (pts4, views))
    gs = [x[:K5_ROWS].contiguous() for x in gs]
    nargs = (nplan, pts4, views, tw, tb, hw[:4], hb[:4])
    flops_row = 3 * 2 * (sum(k * n for k, n in t_dims) + sum(k * n for k, n in h_dims[:4]))
    wbytes = sum(w.numel() * 6 + b.numel() * 8 for w, b in zip(tw + hw[:4], tb + hb[:4]))
    b_ms, b_by = bound(K5_ROWS, flops_row, (4 + 3 + 1 + 3 + 4 + 3) * 4, wbytes, PEAK_BF16_S)
    W, B, meta = fused_mlp._nerf_meta(nplan, 4, tw, tb, hw[:4], hb[:4], device)
    sc5 = fused_mlp._BwdScratch(K5_ROWS, meta, device)
    outs = [torch.empty_like(pts4), torch.empty_like(views)]

    def k5_launches():
        # without the dpt head the kernel never reads the g_dpt slot
        fused_mlp._nerf_bwd_tile((pts4, views, *gs, gs[1]), outs, W, B, meta, sc5)
        sc5.contract()

    rec["nerf_bwd"] = {"max_abs_err": err, "flops_row": flops_row, "shapes": [{
        "rows": K5_ROWS,
        "ms": time_ms(lambda: fused_mlp._nerf_bwd_launch(*nargs, *gs)),
        "kernel_ms": time_ms(k5_launches),
        "plain_ms": time_ms(lambda: fused_mlp.nerf_bwd_plain(*nargs, *gs)),
        "bound_ms": b_ms, "bound_by": b_by,
    }]}

    # the dW contraction alone (dw_kernel + the two fixed-order reductions), on
    # the scratch the timed K3 and K5 launches left
    errs, shapes = [], []
    for rows, sc in ((K3_ROWS, sc3), (K5_ROWS, sc5)):
        errs.append(_check_contraction(sc, rows))
        shapes.append(_time_contraction(sc, rows))
    rec["dw_contract"] = {"max_abs_err": max(errs), "flops_row": shapes[0]["flops_row"],
                          "shapes": shapes}
    return rec


def _contraction_operands(sc):
    """Per layer (acts_l [rows, Kp], dels_l [rows, Np]) views of a backward's
    scratch, and where the layer's dW sits in the packed result."""
    out, aoff, doff = [], 0, 0
    for _, _, Kp, Np, woff, _ in sc.layers:
        out.append((sc.acts[:, aoff:aoff + Kp], sc.dels[:, doff:doff + Np], woff))
        aoff, doff = aoff + Kp, doff + Np
    return out


def _contraction_plain(sc):
    """The contraction's plain version: f32 products of the same bf16
    operands, one matmul per layer."""
    return [a.float().t() @ d.float() for a, d, _ in _contraction_operands(sc)]


def _check_contraction(sc, rows) -> float:
    """dW of every layer within 2^-12 relative L2 of the plain version (f32
    sums of the same bf16 products in another order), and two launches of
    the contraction bit-identical -> the largest abs error."""
    import torch

    sc.contract()
    first = sc.dW.clone()
    sc.contract()
    torch.cuda.synchronize()
    if not torch.equal(first, sc.dW):
        raise SystemExit("dw_contract: two launches differ")
    errs, worst = [], 0.0
    for (a, d, woff), want in zip(_contraction_operands(sc), _contraction_plain(sc)):
        got = sc.dW[woff:woff + want.numel()].view_as(want)
        errs.append(float((got - want).abs().max()))
        worst = max(worst, _rel_l2(got, want))
    print(f"[kernel] dw_contract: rows={rows} layers={len(errs)} max_abs_err={max(errs):.3e} "
          f"worst rel L2 error {worst:.3e} (tol {2.0**-12:.3e}); two launches bit-identical")
    if not worst <= 2.0**-12:
        raise SystemExit("dw_contract: the contraction disagrees with its plain version")
    return max(errs)


def _time_contraction(sc, rows) -> dict:
    """CUDA-event times of the contraction alone, its plain version and the
    library yardstick (one bf16 torch.matmul per layer), and its bound: the
    acts/dels read once and dW written once over the memory rate, against
    the bf16 products over the bf16 peak."""
    import torch

    ops = _contraction_operands(sc)
    macs = sum(a.shape[1] * d.shape[1] for a, d, _ in ops)
    io = rows * (sc.acts.shape[1] + sc.dels.shape[1]) * 2 + sc.dW.numel() * 4
    b_ms, b_by = bound(rows, 2 * macs, 0, io, PEAK_BF16_S)
    return {
        "rows": rows, "flops_row": 2 * macs,
        "ms": time_ms(sc.contract),
        "plain_ms": time_ms(lambda: _contraction_plain(sc)),
        "library_ms": time_ms(lambda: [torch.matmul(a.t(), d) for a, d, _ in ops]),
        "bound_ms": b_ms, "bound_by": b_by,
    }


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------


def _look_at(eye):
    import numpy as np

    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(fwd, right), fwd, eye
    return c2w


def write_scene(data_dir: str) -> None:
    """8 RGBA views of a Lambertian sphere of radius 0.5 from a ring at
    distance 3, with ``image/cameras_sphere.npz`` (world_mat_<stem> = K w2c,
    scale_mat_<stem> = I)."""
    import cv2 as cv
    import numpy as np

    img_dir = os.path.join(data_dir, "image")
    os.makedirs(img_dir)
    K = np.eye(4)
    K[0, 0] = K[1, 1] = 350.0
    K[0, 2], K[1, 2] = SCENE_W / 2, SCENE_H / 2
    light = np.array([0.4, -0.3, 0.85]) / np.linalg.norm([0.4, -0.3, 0.85])
    xs, ys = np.meshgrid(np.arange(SCENE_W), np.arange(SCENE_H))
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float64)
    cams = {}
    for i in range(SCENE_VIEWS):
        theta = 2 * np.pi * i / SCENE_VIEWS
        c2w = _look_at(3.0 * np.array([np.cos(theta), np.sin(theta), 0.4 + 0.1 * (i % 3)]))
        d = pix @ np.linalg.inv(K[:3, :3]).T
        d = (d / np.linalg.norm(d, axis=-1, keepdims=True)) @ c2w[:3, :3].T
        o = c2w[:3, 3]
        b = d @ o
        disc = b**2 - (o @ o - 0.25)
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        n = (o + d * t[..., None]) / 0.5
        shade = 0.15 + 0.85 * np.clip(n @ light, 0.0, 1.0)
        rgb = np.stack([0.9 * shade, 0.6 * shade, 0.3 + 0.5 * shade], -1)
        rgba = np.zeros((SCENE_H, SCENE_W, 4), np.uint8)
        rgba[..., :3] = np.where(hit[..., None], rgb * 255, 255).astype(np.uint8)
        rgba[..., 3] = hit * 255
        stem = f"{i:03d}"
        cv.imwrite(os.path.join(img_dir, f"{stem}.png"), rgba)
        cams[f"world_mat_{stem}"] = (K @ np.linalg.inv(c2w)).astype(np.float32)
        cams[f"scale_mat_{stem}"] = np.eye(4, dtype=np.float32)
    np.savez(os.path.join(img_dir, "cameras_sphere.npz"), **cams)


def write_conf(tmp: str, exp: str = "exp", train: dict | None = None) -> str:
    """confs/womsk_white_tpu.conf with only its two paths (and the given
    ``train`` keys) rewritten."""
    with open(os.path.join(ROOT, "confs", "womsk_white_tpu.conf")) as f:
        text = f.read()
    subs = [("./exp/CASE_NAME", f"{tmp}/{exp}/CASE_NAME"),
            ("./depth_data/CASE_NAME", f"{tmp}/depth_data/CASE_NAME")]
    for key, value in (train or {}).items():
        line = next((ln for ln in text.splitlines() if ln.strip().startswith(f"{key} =")), None)
        if line is None:
            raise SystemExit(f"womsk_white_tpu.conf: no train key {key!r}")
        subs.append((line, f"    {key} = {value}"))
    for old, new in subs:
        if text.count(old) != 1:
            raise SystemExit(f"womsk_white_tpu.conf: expected one {old!r}")
        text = text.replace(old, new)
    path = os.path.join(tmp, f"womsk_white_tpu_{exp}.conf")
    with open(path, "w") as f:
        f.write(text)
    return path


def slice_phase(tmp: str) -> dict:
    """valimg_0 and getfeats_0 through the port's CLI on the card."""
    import numpy as np
    import torch

    from vdnerf_tpu_torch import cli
    from vdnerf_tpu_torch.io.checkpoints import save_training_checkpoint
    from vdnerf_tpu_torch.ops.kernels import build
    from vdnerf_tpu_torch.train.builder import build_model, build_networks
    from vdnerf_tpu_torch.utils.hocon import load_conf

    case = "sphere"
    data_dir = os.path.join(tmp, "depth_data", case)
    write_scene(data_dir)
    conf_path = write_conf(tmp)
    conf = load_conf(conf_path, case)
    model = build_model(conf, build_networks(conf), seed=0)
    exp_dir = conf.get_string("general.base_exp_dir")
    save_training_checkpoint(os.path.join(exp_dir, "checkpoints", "ckpt_000000.pth"), model, 0)

    base = ["--conf", conf_path, "--case", case]
    res = {"launches": {}, "summary": {}, "rays_per_s": {}}
    build.reset_launches()
    for mode, level in (("valimg_0", 2), ("getfeats_0", 1)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = cli.main(base + ["--mode", mode])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rays = SCENE_VIEWS * (SCENE_H // level) * (SCENE_W // level)
        res["summary"][mode] = summary
        res["rays_per_s"][mode] = rays / wall
        print(f"[slice] {mode}: {summary} rays={rays} wall_s={wall:.3f} rays/s={rays / wall:.1f}")
        if not all(math.isfinite(v) for v in summary.values()):
            raise SystemExit(f"{mode}: non-finite summary {summary}")
    res["launches"] = dict(build.LAUNCHES)
    print(f"[slice] launches on the serving path: {res['launches']}")
    missing = [k for k in ("sdf_fwd", "render_fwd", "nerf_fwd") if res["launches"][k] == 0]
    if missing:
        raise SystemExit(f"the serving path launched no {missing}")

    depth_dir = os.path.join(data_dir, "image", "depth_from_sdf")
    names = sorted(os.listdir(depth_dir))
    if names != [f"sdf_{i:03d}.npy" for i in range(SCENE_VIEWS)]:
        raise SystemExit(f"getfeats wrote {names}")
    for name in names:
        depth = np.load(os.path.join(depth_dir, name))
        if depth.shape != (SCENE_H, SCENE_W, 1) or not np.isfinite(depth).all():
            raise SystemExit(f"{name}: shape {depth.shape}, finite={np.isfinite(depth).all()}")
    print(f"[slice] depth .npy written: {len(names)} x {(SCENE_H, SCENE_W, 1)}, finite")
    res["conf"] = conf
    return res


def reference_check(conf, device) -> dict:
    """512 rays of the full-width model: kernels on the card against the
    plain versions on the CPU. color atol 5e-3 (bf16 operand rounding, as the
    port's render tests); argmax-weight depth within 1e-3 on >= 99% of rays."""
    import numpy as np
    import torch

    from vdnerf_tpu_torch.data.dataset import near_far_from_sphere
    from vdnerf_tpu_torch.ops.renderer import render
    from vdnerf_tpu_torch.train.builder import build_model, build_networks

    nets = build_networks(conf)
    rng = np.random.default_rng(1)
    o = rng.normal(size=(512, 3))
    o = 3.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-0.6, 0.6, size=(512, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    outs = {}
    for key, dev in (("card", device), ("plain", torch.device("cpu"))):
        model = build_model(conf, nets, seed=0).to(dev)
        ro, rd = (torch.tensor(a, dtype=torch.float32, device=dev) for a in (o, d))
        with torch.no_grad():
            out = render(nets, model, ro, rd, *near_far_from_sphere(ro, rd), perturb_overwrite=0,
                         background_rgb=torch.ones(1, 3, device=dev), cos_anneal_ratio=1.0)
        inside = out["inside_sphere"]
        w = out["weights"][:, : inside.shape[1]] * inside
        depth = torch.gather(out["z_vals"], -1, w.argmax(-1, keepdim=True))
        outs[key] = (out["color_fine"].cpu(), depth.cpu())
    color_err = float((outs["card"][0] - outs["plain"][0]).abs().max())
    depth_agree = float(((outs["card"][1] - outs["plain"][1]).abs() <= 1e-3).float().mean())
    print(f"[check] 512-ray render, kernels vs plain on the CPU: color max_abs_err="
          f"{color_err:.3e} (tol 5e-3), depth agreement {depth_agree:.4f} (>= 0.99)")
    if not color_err <= 5e-3 or depth_agree < 0.99:
        raise SystemExit("the render through the kernels disagrees with the plain render")
    return {"color_max_abs_err": color_err, "depth_agreement": depth_agree}


# the training phase: 40 steps across the resample_from switch, both
# checkpoints and validations inside the run, no mesh validation
TRAIN_KEYS = {"end_iter": 40, "resample_from": 20, "save_freq": 20, "val_freq": 20,
              "val_mesh_freq": 1000000}
TIMED_STEPS = 5


def train_phase(tmp: str) -> dict:
    """--mode train through the port's CLI on the card, then valimg_40 from
    its last checkpoint."""
    import numpy as np
    import torch

    from vdnerf_tpu_torch import cli
    from vdnerf_tpu_torch.ops.kernels import build
    from vdnerf_tpu_torch.train.builder import build_model, build_networks
    from vdnerf_tpu_torch.utils.hocon import load_conf

    case = "sphere"
    conf_path = write_conf(tmp, "exp_train", TRAIN_KEYS)
    conf = load_conf(conf_path, case)
    exp_dir = conf.get_string("general.base_exp_dir")
    base = ["--conf", conf_path, "--case", case]

    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary = cli.main(base + ["--mode", "train"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    print(f"[train] {TRAIN_KEYS['end_iter']} steps + validations: {summary} wall_s={wall:.3f}")
    print(f"[train] launches on the training path: {launches}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise SystemExit(f"the training path launched no {missing}")

    with open(os.path.join(exp_dir, "logs", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = {r["step"]: r["loss"] for r in recs}
    print(f"[train] logged loss by step: {losses}")
    if sorted(losses) != [1, 10, 20, 30, 40] or not all(map(math.isfinite, losses.values())):
        raise SystemExit(f"logged losses: {losses}")
    ckpts = sorted(os.listdir(os.path.join(exp_dir, "checkpoints")))
    if ckpts != ["ckpt_000020.pth", "ckpt_000040.pth"]:
        raise SystemExit(f"checkpoints written: {ckpts}")
    trained = torch.load(os.path.join(exp_dir, "checkpoints", "ckpt_000040.pth"),
                         map_location="cpu", weights_only=True)
    fresh = build_model(conf, build_networks(conf), seed=0)
    moved = {name: max(float((trained[name][k] - v).abs().max())
                       for k, v in getattr(fresh, name).state_dict().items())
             for name in ("nerf", "sdf_network_fine", "variance_network_fine",
                          "color_network_fine")}
    print(f"[train] largest parameter change per network after 40 steps: {moved}")
    if not all(v > 0 for v in moved.values()):
        raise SystemExit("training left a network unchanged")
    if not all(os.listdir(os.path.join(exp_dir, sub)) for sub in ("validations_fine", "normals")):
        raise SystemExit("no validation images were written")

    served = cli.main(base + ["--mode", "valimg_40"])
    diff = max(abs(served[k] - summary[k]) for k in summary)
    print(f"[train] valimg_40 from ckpt_000040.pth: {served}; max difference to the run's "
          f"closing val_all_imgs {diff:.3e} (tol 1e-6: same weights, deterministic kernels)")
    if set(served) != set(summary) or not diff <= 1e-6:
        raise SystemExit("valimg_40 disagrees with the training run's closing validation")
    return {"launches": launches, "summary": summary, "wall_s": wall, "losses": losses,
            "conf": conf, "conf_path": conf_path}


def time_train_steps(conf_path: str) -> dict:
    """Steady-state ms/step and rays/s per core width: TIMED_STEPS steps
    between torch.cuda.synchronize() calls after 2 warm-up steps."""
    import dataclasses

    import numpy as np
    import torch

    from vdnerf_tpu_torch.runner import Runner

    runner = Runner(conf_path, case="sphere", mode="train")
    faithful = dataclasses.replace(
        runner.nets, renderer=dataclasses.replace(runner.nets.renderer, n_render_samples=0))
    rng = np.random.default_rng(0)
    out = {}
    for name, nets in (("core_128", faithful), ("core_96", runner.nets)):
        step = 0

        def run(n):
            nonlocal step
            for _ in range(n):
                batch = runner.store.sample_pixels(step % runner.scene_data.n_images,
                                                   runner.tcfg.batch_size, rng)
                runner.trainer.step(nets, batch, step)
                step += 1

        run(2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(TIMED_STEPS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
        out[name] = {"ms_per_step": ms, "rays_per_s": runner.tcfg.batch_size * 1e3 / ms}
        print(f"[train] {name}: {ms:.2f} ms/step, {out[name]['rays_per_s']:.1f} rays/s "
              f"(batch {runner.tcfg.batch_size}, {TIMED_STEPS} steps after 2 warm-up)")
    return out


def gradient_check(conf, device) -> dict:
    """One step's loss and gradients at full width on 128 rays (perturb 0):
    the kernels on the card against the plain versions on the CPU. Loss within
    1e-3 relative; each parameter's gradient within 2^-6 relative L2 error.
    Both sides round the fused MLPs' operands to bf16, but in another
    summation order, and a relu kink or a bf16 rounding boundary taken the
    other way moves single rows by a few percent (see the kernel phase); the
    f32 SDF block sums in another order on the card than on the CPU."""
    import dataclasses

    import numpy as np
    import torch

    from vdnerf_tpu_torch.data.dataset import SceneData
    from vdnerf_tpu_torch.data.rays import RayStore
    from vdnerf_tpu_torch.train.builder import build_model, build_networks
    from vdnerf_tpu_torch.train.config import TrainConfig
    from vdnerf_tpu_torch.train.step import Trainer

    nets = build_networks(conf)
    nets = dataclasses.replace(nets, renderer=dataclasses.replace(nets.renderer, perturb=0.0))
    tcfg = TrainConfig.from_conf(conf)
    scene = SceneData(conf["dataset"])
    batch = RayStore(scene.images_lis, scene.masks_lis).sample_pixels(
        2, 128, np.random.default_rng(5))
    res = {}
    for key, dev in (("card", device), ("plain", torch.device("cpu"))):
        model = build_model(conf, nets, seed=0).to(dev)
        cams = {"pose_all": torch.as_tensor(scene.pose_all, device=dev),
                "intrin_inv_all": torch.as_tensor(scene.intrinsics_all_inv, device=dev)}
        metrics = Trainer(tcfg, model, cams, None).gradients(nets, batch, 1000)
        res[key] = (float(metrics["loss"]),
                    {n: p.grad.detach().cpu() for n, p in model.named_parameters()})
    loss_err = abs(res["card"][0] - res["plain"][0]) / abs(res["plain"][0])
    rel = {n: float((g - res["plain"][1][n]).norm() / res["plain"][1][n].norm().clamp_min(1e-30))
           for n, g in res["card"][1].items()}
    worst = max(rel, key=rel.get)
    print(f"[grad] 128-ray full-width step, card vs plain on the CPU: loss {res['card'][0]:.6f} "
          f"vs {res['plain'][0]:.6f} (rel err {loss_err:.3e}, tol 1e-3); worst gradient rel L2 "
          f"error {rel[worst]:.3e} ({worst}, tol {2.0**-6:.3e}) over {len(rel)} tensors")
    if not loss_err <= 1e-3 or not rel[worst] <= 2.0**-6:
        raise SystemExit("the training step through the kernels disagrees with the plain step")
    return {"loss_rel_err": loss_err, "worst_grad_rel_l2": rel[worst], "worst": worst}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from vdnerf_tpu_torch.ops.kernels import build
    from vdnerf_tpu_torch.utils.device import configure_numerics

    device = torch.device("cuda:0")
    configure_numerics()
    print(card_line())

    t0 = time.time()
    build.build_all()
    print(f"[build] kernels built in {time.time() - t0:.1f} s")

    kern = kernel_phase(device)
    with tempfile.TemporaryDirectory() as tmp:
        res = slice_phase(tmp)
        reference_check(res["conf"], device)
        train = train_phase(tmp)
        steps = time_train_steps(train["conf_path"])
        gradient_check(train["conf"], device)

    kernels = []
    for name, r in kern.items():
        main_shape = r["shapes"][0]
        by_path = {"serve": res["launches"][name], "train": train["launches"][name]}
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": sum(by_path.values()),
            "max_abs_err": r["max_abs_err"], "ms": main_shape["ms"],
            "plain_ms": main_shape["plain_ms"], "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"], "library_ms": main_shape.get("library_ms"),
            "kernel_ms": main_shape.get("kernel_ms"), "launches_by_path": by_path,
            "rows": main_shape["rows"], "flops_row": r["flops_row"], "shapes": r["shapes"],
        })
    print(json.dumps({"rays_per_s": res["rays_per_s"], "summary": res["summary"],
                      "train": {"steps": steps, "summary": train["summary"],
                                "wall_s": train["wall_s"]}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
