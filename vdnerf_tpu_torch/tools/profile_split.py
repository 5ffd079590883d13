"""Where the time of one call of K2-K5's split f32 mode goes, launch by launch.

    python -m vdnerf_tpu_torch.tools.profile_split [--iters 5] [--out FILE]

Builds each network at full width from a seed (the colour head 289 -> 256x4
-> 3 or 96, the background NeRF's 8x256 trunk with its skip and heads, the
dpt head included) and calls each split-mode wrapper as a training step
does: K2 and K3 at a step's faithful core (65,536 rows; K3 with 3 and with
96 outputs), K4 and K5 (with dpt) at a step's 16,896 outside rows. For each
call it reports:

- the steady-state ms of one call through its wrapper (CUDA events over
  ``--iters`` calls, after a warm-up);
- every launch of the call in the order the wrapper makes it, named by what
  it does (the call's weight images, ``split_mm MxNxK`` with ``tb`` for a
  dx product, its epilogue and tile width, the embeds and their VJPs, each
  launch of the dW contraction), with its device ms under
  ``torch.profiler``, averaged over ``--iters`` profiled calls;
- the launches' sum by kind (weight images, forward recomputes, dx
  products, embeds, the contraction), and the call's time outside its
  launches (the wrapper's packing and the host).

Prints one JSON line, with the card's name and power limit; ``--out`` also
writes it to a file. Needs a CUDA device; with none it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from collections import defaultdict

import torch

from vdnerf_tpu_torch.ops.kernels import fused_mlp
from vdnerf_tpu_torch.tools.flagship_run import card_line
from vdnerf_tpu_torch.tools.profile_render import _event_ms
from vdnerf_tpu_torch.utils.device import configure_numerics

EPI = ("none", "relu", "sigmoid", "mask", "dsigmoid", "drelu")
CORE_ROWS, K5_ROWS = 512 * 128, 512 * 33
R_DIMS = [(289, 256), (256, 256), (256, 256), (256, 256)]
T_DIMS = [(84, 256)] + [(256, 256)] * 4 + [(340, 256)] + [(256, 256)] * 2
H_DIMS = [(256, 1), (256, 256), (283, 128), (128, 3), (128, 96)]
NERF_PLAN = (10, 4, (4,), 8, True)
RENDER_PLAN = ("idr", 4, True)
# the kernels of the split mode (csrc/fused_mlp.cu), as the profiler names them
SPLIT_KERNELS = ("split_", "reduce_dw_kernel")


def _weights(gen, dims, dev):
    ws = [(torch.randn(k, n, generator=gen) / math.sqrt(k)).to(dev) for k, n in dims]
    bs = [(torch.randn(n, generator=gen) * 0.05).to(dev) for _, n in dims]
    return ws, bs


class _Labels:
    """Names each launch of ``_SplitOps`` as it is made, in order."""

    def __init__(self):
        self.names: list[str] = []
        self._mm = fused_mlp._SplitOps.mm
        self._launched = fused_mlp._SplitOps._launched
        self._pending = []

    def __enter__(self):
        labels = self

        def mm(ops, A, img, C, *, epi=fused_mlp.EPI_NONE, **k):
            M, K = A.shape
            labels._pending.append(f" {M}x{img.N}x{K}{' tb' if img.trans else ''} {EPI[epi]}"
                                   f" bn{img.bn}")
            return labels._mm(ops, A, img, C, epi=epi, **k)

        def launched(ops, err, what, counter=None):
            extra = labels._pending.pop() if what == "split_mm" and labels._pending else ""
            labels.names.append(what + extra)
            return labels._launched(ops, err, what, counter)

        fused_mlp._SplitOps.mm = mm
        fused_mlp._SplitOps._launched = launched
        return self

    def __exit__(self, *exc):
        fused_mlp._SplitOps.mm = self._mm
        fused_mlp._SplitOps._launched = self._launched


def _kind(name: str) -> str:
    if name.startswith("split_mm"):
        return "dx products" if " tb" in name else "forward products"
    if name.startswith("split_embed"):
        return "embeds and their VJPs"
    if name.startswith("split_image"):
        return "weight images"
    return "dW contraction"


def profile_call(fn, iters: int) -> dict:
    """One split call: its ms, and its launches in order with their device ms."""
    from torch.profiler import ProfilerActivity, profile

    ms = _event_ms(fn, iters)
    with _Labels() as labels:
        fn()
        torch.cuda.synchronize()
    names = labels.names
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = sorted(
        (ev.time_range.start, ev.time_range.elapsed_us() / 1e3, ev.name)
        for ev in prof.events()
        if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation
        and any(k in ev.name for k in SPLIT_KERNELS))
    if len(kernels) != iters * len(names):
        raise SystemExit(f"profile_split: {len(kernels)} split kernels for {iters} calls of "
                         f"{len(names)} launches")
    per = [0.0] * len(names)
    for i, (_, ms_i, _) in enumerate(kernels):
        per[i % len(names)] += ms_i / iters
    by_kind = defaultdict(float)
    for name, t in zip(names, per):
        by_kind[_kind(name)] += t
    return {"ms": ms, "launches": len(names), "launch_ms_sum": sum(per),
            "outside_launches_ms": ms - sum(per), "by_kind_ms": dict(by_kind),
            "kernels": sorted({k for _, _, k in kernels}),
            "per_launch": [{"what": n, "ms": t} for n, t in zip(names, per)]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--out", type=str, default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_split: needs a CUDA device", file=sys.stderr)
        return 1
    configure_numerics()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(1)
    ws, bs = _weights(gen, R_DIMS + [(256, 3)], dev)
    w96, b96 = _weights(gen, [(256, 96)], dev)
    tw, tb = _weights(gen, T_DIMS, dev)
    hw, hb = _weights(gen, H_DIMS, dev)

    def r_inputs(rows):
        t = [torch.randn(rows, 3, generator=gen) for _ in range(3)]
        t[2] = t[2] / t[2].norm(dim=-1, keepdim=True)
        return [x.to(dev) for x in (*t, torch.randn(rows, 256, generator=gen) * 0.5)]

    inp = r_inputs(CORE_ROWS)
    g3 = torch.randn(CORE_ROWS, 3, generator=gen).to(dev)
    g96 = torch.randn(CORE_ROWS, 96, generator=gen).to(dev)
    pts = torch.randn(K5_ROWS, 3, generator=gen)
    pts4 = torch.cat([pts / pts.norm(dim=-1, keepdim=True),
                      torch.rand(K5_ROWS, 1, generator=gen)], -1).to(dev)
    views = torch.randn(K5_ROWS, 3, generator=gen)
    views = (views / views.norm(dim=-1, keepdim=True)).to(dev)
    gs = [torch.randn(K5_ROWS, k, generator=gen).to(dev) for k in (1, 3, 96)]
    calls = {
        "K2 rows=65536 d_out=3": lambda: fused_mlp._render_launch_f32(
            RENDER_PLAN, *inp, ws, bs),
        "K3 rows=65536 d_out=3": lambda: fused_mlp._render_bwd_launch_f32(
            RENDER_PLAN, *inp, ws, bs, g3),
        "K3 rows=65536 d_out=96": lambda: fused_mlp._render_bwd_launch_f32(
            RENDER_PLAN, *inp, ws[:4] + w96, bs[:4] + b96, g96),
        "K4 rows=16896": lambda: fused_mlp._nerf_launch_f32(
            NERF_PLAN[:4] + (False,), pts4, views, tw, tb, hw[:4], hb[:4]),
        "K5 rows=16896 dpt": lambda: fused_mlp._nerf_bwd_launch_f32(
            NERF_PLAN, pts4, views, tw, tb, hw, hb, *gs),
    }
    report = {"card": card_line(), "iters": args.iters,
              "calls": {name: profile_call(fn, args.iters) for name, fn in calls.items()}}
    for name, r in report["calls"].items():
        kinds = ", ".join(f"{k} {v:.3f}" for k, v in r["by_kind_ms"].items())
        print(f"[profile_split] {name}: {r['ms']:.3f} ms a call, {r['launches']} launches "
              f"({r['launch_ms_sum']:.3f} ms): {kinds}", flush=True)
    line = json.dumps(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
