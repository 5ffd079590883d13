"""Where the time of one serving chunk, or of one training step, goes on the
card.

    python -m vdnerf_tpu_torch.tools.profile_render [--conf confs/womsk_white_tpu.conf]
        [--rays 4096] [--iters 5] [--trace trace.json] [--train [--bf16]]

Builds the conf's networks at full width from a seed (geometric-init SDF,
random colour head and background NeRF). Without ``--train`` it renders one
chunk of rays aimed at the unit sphere the way ``valimg``/``getfeats`` do
(``perturb_overwrite=0``, white background). With ``--train`` it runs the
training step of ``train/step.py`` (render with the conf's perturbation,
loss, backward, Adam) on a batch of ``train.batch_size`` pixels of a camera
3 units from the sphere, once on the faithful core (128 samples in the
shipped confs) and once on the conf's resampled core (96 in
``womsk_white_tpu`` and ``womsk_white_wdepth_tpu``, 64 in ``wmask_tpu``), in
windows of ``--iters`` steps through ``train/dispatch.py``: each step a
replay of the captured step (``replay``, the path training takes), and each
step launched op by op (``eager``). On a wdepth conf the batch carries random
teacher features and the steps come after ``depth_start_iter``, so the depth
head trains; on a learnable conf the camera's pose and focal are learned and
the steps come after ``start_refine_pose_iter``, so they update; a conf
without a resampled core has its faithful core only. With ``--bf16`` (or a
conf that sets ``train.bf16``) the SDF block runs under the bf16 policy;
K2-K5 run f32 operands under the f32 policy unless ``VDNERF_FUSED=1``
(``models/precision.py``). For each it reports:

- the steady-state time of one chunk or step (CUDA events over ``--iters``
  chunks, or over two windows of ``--iters`` steps);
- the device time under ``torch.profiler`` by the program's layer spans and
  backward pieces, read from their device marks (``utils/trace.py``: the
  ladder, the background NeRF, the SDF block, the heads, the composite, the
  loss and Adam, each backward piece under its point's name), and the top
  kernels;
- the device's busy time (the union of its operations' intervals) and idle
  share of the profiled window, the number of device events (kernels and
  copies, marks left out) in it, the span from the first event's start to
  the last one's end and the gaps inside that span when no event ran (idle
  time outside the span is the host's alone);
- with ``--train``, each kernel's launches per step, and per head
  (``color_network_fine``, and ``depth_network_fine`` on a wdepth conf) its
  rows, outputs and the CUDA-event times of its K2 and K3 alone at that
  step's inputs: the profiler names both heads' launches
  ``render_fwd_kernel`` / ``render_bwd_kernel``, and this tells them apart.

Prints one JSON line, with the card's name and power limit. Needs a CUDA
device; with none it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import dataclasses

import numpy as np
import torch

from vdnerf_tpu_torch.data.cameras import LearnedCameras
from vdnerf_tpu_torch.data.dataset import near_far_from_sphere
from vdnerf_tpu_torch.ops.kernels import build, fused_mlp
from vdnerf_tpu_torch.ops.renderer import render
from vdnerf_tpu_torch.models.precision import env_fused, matmul_dtype, mlp_operand_dtype
from vdnerf_tpu_torch.train.builder import build_model, build_networks
from vdnerf_tpu_torch.train.config import TrainConfig
from vdnerf_tpu_torch.train.dispatch import WARMUP_STEPS, StepDispatch
from vdnerf_tpu_torch.train.step import Trainer
from vdnerf_tpu_torch.utils import trace as program_trace
from vdnerf_tpu_torch.utils.device import configure_numerics
from vdnerf_tpu_torch.utils.hocon import load_conf


def _event_ms(fn, iters: int = 10) -> float:
    """Steady-state ms of fn by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def profile_window(fn, trace: str = "", group=None) -> dict:
    """One call of fn under ``torch.profiler``: its host-clock window (the
    profiler's own host overhead included), the device's busy time (the
    union of its operations' intervals) and idle share of the window, the
    device ms by the program's span or backward piece (:func:`by_span`, from
    the marks; "(none)" outside every span) and the top kernels; with
    ``group`` (a kernel name -> group name function), also the device ms by
    group."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    if trace:
        prof.export_chrome_trace(trace)

    # a user annotation (Optimizer.step#...) spans kernels counted anyway
    events = [(ev.name, ev.time_range.start / 1e3, ev.time_range.end / 1e3)
              for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation]
    work = [e for e in events if program_trace.parse_mark(e[0]) is None]
    kernels: dict[str, float] = {}
    for name, start, end in work:
        kernels[name] = kernels.get(name, 0.0) + end - start
    busy_ms = sum(program_trace.by_span(work).values())
    span_ms = max(e for _, _, e in work) - min(s for _, s, _ in work) if work else None
    out = {
        "profiled_window_ms": window_ms,
        "device_events": len(work),
        "device_span_ms": span_ms,
        "device_gaps_ms": span_ms - busy_ms if work else None,
        "device_busy_ms": busy_ms if work else None,
        "device_idle_share": 1.0 - busy_ms / window_ms if work else None,
        "device_ms_by_span": {k or "(none)": v
                              for k, v in program_trace.by_span(events).items()},
        "top_kernels_ms": sorted(kernels.items(), key=lambda kv: -kv[1])[:15],
    }
    if group is not None:
        out["device_ms_by_group"] = {}
        for name, start, end in work:
            key = group(name)
            out["device_ms_by_group"][key] = out["device_ms_by_group"].get(key, 0.0) + end - start
    return out


def _profile(fn, iters: int, trace: str) -> dict:
    """Steady-state ms of fn by CUDA events, then one profiled call."""
    return {"ms": _event_ms(fn, iters), **profile_window(fn, trace)}


def _heads(model, run_step) -> dict:
    """Each IDR head's K2 and K3 alone, at the inputs one training step gives
    it (captured by a forward hook), timed by CUDA events: the wrapper's K2
    (packing included) and K3 on that pack with a random cotangent."""
    seen, hooks = {}, []
    for name in ("color_network_fine", "depth_network_fine"):
        if hasattr(model, name):
            def keep(module, args, out, name=name):
                seen[name] = (module, [a.detach().float().contiguous() for a in args])
            hooks.append(getattr(model, name).register_forward_hook(keep))
    try:
        run_step()
    finally:
        for h in hooks:
            h.remove()
    out = {}
    for name, (module, args) in seen.items():
        ws, bs = (list(t) for t in module.weights())
        ws, bs = [w.detach() for w in ws], [b.detach() for b in bs]
        plan = (module.cfg.mode, module.cfg.multires_view, module.cfg.squeeze_out)
        _, packed = fused_mlp._render_launch(plan, *args, ws, bs)
        g = torch.randn(args[0].shape[0], ws[-1].shape[1], device=args[0].device)
        out[name] = {
            "rows": args[0].shape[0], "d_out": ws[-1].shape[1],
            "render_fwd_ms": _event_ms(lambda: fused_mlp._render_launch(plan, *args, ws, bs)),
            "render_bwd_ms": _event_ms(
                lambda: fused_mlp._render_bwd_launch(plan, *args, ws, bs, g, packed=packed)),
        }
    return out


def _train_steps(conf, nets, dev, iters: int, trace: str, bf16: bool = False) -> dict:
    """Training steps per core width on a synthetic camera's pixels, in
    windows of ``iters`` steps through ``StepDispatch``: replayed (the
    training path) and eager (each step launched op by op), in turns. The
    SDF block is bf16 where the conf sets ``train.bf16`` or ``bf16`` asks."""
    tcfg = TrainConfig.from_conf(conf)
    policy = matmul_dtype(bf16 or tcfg.bf16)
    W, H, focal = 400, 300, 300.0
    intrin = torch.tensor([[focal, 0, W / 2, 0], [0, focal, H / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    pose = torch.eye(4)
    pose[2, 3] = -3.0  # on the -z axis, looking along +z at the sphere
    if tcfg.learnable:
        # the learnable confs learn this camera's pose and focal
        order = conf.get_int("model.focal.order", default=2)
        cams = LearnedCameras(pose[None].numpy(), focal, H, W, order).to(dev)
    else:
        cams = {"pose_all": pose[None].to(dev),
                "intrin_inv_all": torch.linalg.inv(intrin)[None].to(dev)}
    rng = np.random.default_rng(0)
    batch = {
        "img_idx": np.int32(0),
        "pixels_x": rng.integers(0, W, size=tcfg.batch_size).astype(np.int32),
        "pixels_y": rng.integers(0, H, size=tcfg.batch_size).astype(np.int32),
        "color": rng.uniform(0, 1, size=(tcfg.batch_size, 3)).astype(np.float32),
        "mask": np.ones((tcfg.batch_size, 1), np.float32),
        "feats": rng.uniform(0, 1, size=(tcfg.batch_size, nets.depth.d_out if nets.depth else 1))
                 .astype(np.float32),
    }
    # past depth_start_iter and the refine gate: every term and update runs
    first = max(tcfg.depth_start_iter + 1 if tcfg.extract_depth else 0,
                tcfg.start_refine_pose_iter + 1 if tcfg.learnable else 0)
    rcfg = nets.renderer
    faithful = dataclasses.replace(nets, renderer=dataclasses.replace(rcfg, n_render_samples=0))
    cores = [(f"core_{rcfg.n_samples + rcfg.n_importance}", faithful)]
    if rcfg.n_render_samples:
        cores.append((f"core_{rcfg.n_render_samples}", nets))
    out = {}
    for name, core in cores:
        model = build_model(conf, nets, seed=0, matmul_dtype=policy,
                            mlp_dtype=mlp_operand_dtype(policy, env_fused())).to(dev)
        trainer = Trainer(tcfg, model, cams, torch.Generator(device=dev).manual_seed(0))
        # one trainer, two per-step calls: a replay, and the eager step
        dispatch = {"replay": StepDispatch(trainer), "eager": StepDispatch(trainer)}
        dispatch["eager"].step = dispatch["eager"].eager_step
        step = iter(range(first, 10**9))

        def window(mode, n=iters):
            steps = [next(step) for _ in range(n)]
            dispatch[mode].run(steps, [core] * n, [batch] * n)

        window("replay", WARMUP_STEPS + 1)  # the warm-up steps, then the capture
        rec = {}
        for mode in ("replay", "eager"):
            r = _profile(lambda: window(mode), 2,
                         trace.replace(".json", f"_{name}_{mode}.json") if trace else "")
            r["ms"] /= iters
            r["rays_per_s"] = tcfg.batch_size / r["ms"] * 1e3
            build.reset_launches()
            window(mode, 1)
            r["launches_per_step"] = dict(build.LAUNCHES)
            rec[mode] = r
        rec["heads"] = _heads(model, lambda: trainer.step(core, batch, next(step)))
        out[name] = rec
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--conf", default="confs/womsk_white_tpu.conf")
    parser.add_argument("--rays", type=int, default=4096)
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--trace", default="")
    parser.add_argument("--train", action="store_true",
                        help="profile a training step instead of a serving chunk")
    parser.add_argument("--bf16", action="store_true",
                        help="with --train: the SDF block in bf16, as train.bf16 = true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_render: CUDA is not available", file=sys.stderr)
        return 1
    configure_numerics()
    dev = torch.device("cuda:0")
    conf = load_conf(args.conf, "profile")
    nets = build_networks(conf, TrainConfig.from_conf(conf).extract_depth)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    head = {"device": torch.cuda.get_device_name(0), "card": card}
    if args.train:
        print(json.dumps({**head, "train": _train_steps(conf, nets, dev, args.iters, args.trace,
                                                        args.bf16)}))
        return 0

    model = build_model(conf, nets, seed=0,
                        mlp_dtype=mlp_operand_dtype(None, env_fused())).to(dev).eval()
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

    rec = _profile(chunk, args.iters, args.trace)
    rec["chunk_ms"] = rec.pop("ms")
    print(json.dumps({**head, "rays": args.rays, "rays_per_s": args.rays / rec["chunk_ms"] * 1e3,
                      **rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
