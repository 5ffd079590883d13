"""Where the time of one serving chunk goes, on the card.

    python -m vdnerf_tpu_torch.tools.profile_render [--conf confs/womsk_white_tpu.conf]
        [--rays 4096] [--iters 5] [--trace trace.json]

Builds the conf's networks at full width from a seed (geometric-init SDF,
random colour head and background NeRF), renders one chunk of rays aimed at
the unit sphere the way ``valimg``/``getfeats`` do (``perturb_overwrite=0``,
white background), and reports:

- the steady-state time of one chunk (CUDA events over ``--iters`` chunks);
- the device time by kernel under ``torch.profiler``, grouped into the port's
  three CUDA kernels, cuBLAS/cutlass matrix products (the plain f32 autograd
  SDF value+gradient+feature block), and the rest (elementwise, reductions,
  sort, copies);
- the device's busy and idle share of the profiled window.

Prints one JSON line, with the card's name and power limit. Needs a CUDA device; with none it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from vdnerf_tpu_torch.data.dataset import near_far_from_sphere
from vdnerf_tpu_torch.ops.renderer import render
from vdnerf_tpu_torch.train.builder import build_model, build_networks
from vdnerf_tpu_torch.utils.device import configure_numerics
from vdnerf_tpu_torch.utils.hocon import load_conf

OURS = ("sdf_fwd_kernel", "render_fwd_kernel", "nerf_fwd_kernel")


def _group(name: str) -> str:
    for k in OURS:
        if k in name:
            return k
    low = name.lower()
    if any(s in low for s in ("gemm", "cutlass", "sm90_xmma", "cublas", "ampere_sgemm", "sgemm")):
        return "matmul"
    return "other"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--conf", default="confs/womsk_white_tpu.conf")
    parser.add_argument("--rays", type=int, default=4096)
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--trace", default="")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_render: CUDA is not available", file=sys.stderr)
        return 1
    configure_numerics()
    dev = torch.device("cuda:0")
    conf = load_conf(args.conf, "profile")
    nets = build_networks(conf)
    model = build_model(conf, nets, seed=0).to(dev).eval()

    rng = np.random.default_rng(0)
    o = rng.normal(size=(args.rays, 3))
    o = 3.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-0.6, 0.6, size=(args.rays, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ro, rd = (torch.tensor(a, dtype=torch.float32, device=dev) for a in (o, d))
    bg = torch.ones(1, 3, device=dev)

    def chunk():
        with torch.no_grad():
            return render(nets, model, ro, rd, *near_far_from_sphere(ro, rd),
                          perturb_overwrite=0, background_rgb=bg, cos_anneal_ratio=1.0)

    chunk()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.iters):
        chunk()
    stop.record()
    torch.cuda.synchronize()
    chunk_ms = start.elapsed_time(stop) / args.iters

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chunk()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    if args.trace:
        prof.export_chrome_trace(args.trace)

    groups: dict[str, float] = {}
    kernels: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        kernels[ev.name] = kernels.get(ev.name, 0.0) + us / 1e3
        groups[_group(ev.name)] = groups.get(_group(ev.name), 0.0) + us / 1e3
    busy_ms = sum(groups.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()[0],
        "rays": args.rays,
        "chunk_ms": chunk_ms,
        "rays_per_s": args.rays / chunk_ms * 1e3,
        "profiled_window_ms": window_ms,
        "device_busy_ms": busy_ms if kernels else None,
        "device_idle_share": 1.0 - busy_ms / window_ms if kernels else None,
        "device_ms_by_group": groups,
        "top_kernels_ms": top,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
