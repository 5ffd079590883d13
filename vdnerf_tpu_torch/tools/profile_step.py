"""Where the time of one training step goes, component by component, on the card.

    python -m vdnerf_tpu_torch.tools.profile_step [--conf confs/womsk_white_tpu.conf]
        [--batch 512] [--iters 40] [--fp32] [--fused] [--fast-bg] [--render-samples N]
        [--resample-frac F] [--no-bwd] [--batch-sweep] [--out FILE] [--gpu 0]

Counterpart of ``tools/profile_step.py``, with its flags and its report's
keys (``--conf`` and ``--gpu`` added). Builds the conf's networks at its
widths from seed 0 (geometric-init SDF), under the bf16 policy unless
``--fp32``; K2-K5 take the operand mode of ``models/precision.py``: f32 (the
split kernels) under ``--fp32``, bf16 under ``--fused`` or the bf16 policy.
``--fast-bg`` / ``--render-samples`` / ``--resample-frac`` replace the conf's
``skip_bg_inside``, ``n_render_samples`` and ``resample_uniform_frac`` when
either of the first two is given, as the JAX tool replaces its defaults.

Each component is its own loop of ``--iters`` calls on seeded inputs at a
512-ray step's shapes, captured as one CUDA graph and replayed (CUDA events,
the better of two replays), so that no host launch cost enters.
The components are the JAX tool's: the SDF value (K1), the SDF value +
gradient + feature forward, the colour head (K2), the background NeRF (K4),
one up-sample round, the inverse-CDF draw, the composite's transmittance,
the whole forward render, and the whole step (``train/step.py``, each step a
replay of the captured step through ``train/dispatch.py``); unless
``--no-bwd``, the forward-and-backward of the SDF block with its double
backward, of the SDF value alone, of the colour head (K2+K3), of the NeRF
(K4+K5), the loss's forward alone and the step without the eikonal term.
The port adds, at the step's own core width: the ladder (K1 and the
up-sample rounds), the render core's forward-and-backward (SDF block, colour
head and the composites), the background NeRF at the step's rows, and one
4,096-ray serving chunk (``valimg``'s render). From them ``step_parts_ms``
splits the step into the ladder, the background NeRF, the SDF block's
forward and backward (``ops/sdf_block.py``'s Function under the f32 policy,
autograd's double backward under bf16), the colour head, the composites (the render
core less those) and the rest (rays, loss, Adam), with their sum beside the
step's time.

Reports, per component, its ms, its share of the step and its TF/s against
the JAX tool's analytic FLOP count (:func:`flop_table`: :func:`mlp_flops`
per layer stack, a backward 3x the forward's, the SDF value + gradient + feature
4 lanes of the SDF trunk), with the card's name and power limit. Writes
``--out`` (JSON) and prints one JSON line. Runs on ``cuda:<--gpu>``; a caller
of :func:`main` may pass ``device="cpu"``, where every wrapper runs its plain
version and the loops are timed by the host clock.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from vdnerf_tpu_torch.data.dataset import near_far_from_sphere
from vdnerf_tpu_torch.models.precision import env_fused, matmul_dtype, mlp_operand_dtype
from vdnerf_tpu_torch.ops.renderer import _ladder, render, render_core
from vdnerf_tpu_torch.ops.sampling import sample_pdf, transmittance, up_sample
from vdnerf_tpu_torch.tools.flagship_run import card_line
from vdnerf_tpu_torch.train.builder import build_model, build_networks
from vdnerf_tpu_torch.train.config import TrainConfig
from vdnerf_tpu_torch.train.dispatch import WARMUP_STEPS, StepDispatch
from vdnerf_tpu_torch.train.step import Trainer, loss_fn, upload_batch
from vdnerf_tpu_torch.utils.device import configure_numerics, resolve_device
from vdnerf_tpu_torch.utils.hocon import load_conf

SWEEP_ROWS = (65536, 262144, 1048576)
SERVING_RAYS = 4096


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--conf", default="confs/womsk_white_tpu.conf")
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--iters", type=int, default=40)
    p.add_argument("--fp32", action="store_true", help="the SDF block in f32 (else bf16)")
    p.add_argument("--fused", action="store_true",
                   help="K2-K5's bf16 operand mode under --fp32 (as VDNERF_FUSED=1)")
    p.add_argument("--fast-bg", action="store_true", help="skip_bg_inside")
    p.add_argument("--render-samples", type=int, default=0,
                   help="the importance-resampled core's width (0: faithful)")
    p.add_argument("--resample-frac", type=float, default=0.25,
                   help="the resampled core's uniform floor")
    p.add_argument("--no-bwd", action="store_true",
                   help="skip the forward-and-backward components")
    p.add_argument("--batch-sweep", action="store_true",
                   help="the colour head and the NeRF alone at growing row counts")
    p.add_argument("--out", default="docs/PROFILE_torch_step.json")
    p.add_argument("--gpu", type=int, default=0, help="CUDA device index")
    return p


def mlp_flops(dims) -> float:
    return float(sum(2 * a * b for a, b in zip(dims[:-1], dims[1:])))


def nerf_flops(cfg) -> float:
    """The JAX tool's NeRF count: the trunk, feature and alpha heads, the
    view layer and the rgb head, a row."""
    W = cfg.W
    return (mlp_flops((cfg.input_ch,) + (W,) * cfg.D) + 2 * W * (W + 1)
            + 2 * (W + cfg.input_ch_view) * (W // 2) + 2 * (W // 2) * 3)


def shapes(nets, batch: int, render_samples: int) -> dict:
    """The sample counts the components run at (``render_samples``: the
    resampled core's width, 0 for none)."""
    r = nets.renderer
    n_core = r.n_samples + r.n_importance
    step_core = render_samples if 0 < render_samples < n_core else n_core
    n_bg = r.n_samples + r.n_importance + r.n_outside
    step_bg = (r.n_outside + 1 if r.skip_bg_inside else n_bg) if r.n_outside else 0
    return {"B": batch, "n_s": r.n_samples, "n_imp": r.n_importance, "n_out": r.n_outside,
            "per_round": r.n_importance // r.up_sample_steps, "n_core": n_core,
            "n_bg": n_bg, "step_core": step_core, "step_bg": step_bg,
            "rs": render_samples if render_samples and render_samples != n_core else 0}


def flop_table(nets, batch: int, render_samples: int) -> dict:
    """{component: analytic FLOPs}: the JAX tool's formulas, a forward's
    layer products per row times the rows, 3x for a forward and backward,
    4 lanes of the SDF trunk for its value + gradient + feature."""
    s = shapes(nets, batch, render_samples)
    B, n_s, n_core, n_bg = s["B"], s["n_s"], s["n_core"], s["n_bg"]
    sdf_f, color_f, nerf_f = mlp_flops(nets.sdf.dims), mlp_flops(nets.color.dims), nerf_flops(
        nets.nerf)
    rows = B * n_core
    flops = {
        f"sdf_fwd_{n_s}spp": B * n_s * sdf_f,
        f"sdf_valgradfeat_{n_core}spp": rows * sdf_f * 4,
        f"color_net_{n_core}spp": rows * color_f,
        f"bg_nerf_{n_bg}spp": B * n_bg * nerf_f,
        "full_train_step": (B * (n_s + 3 * s["per_round"]) * sdf_f + rows * sdf_f * 4
                            + rows * color_f + B * n_bg * nerf_f) * 3.0,
        f"sdf_vgf_fwdbwd2nd_{n_core}spp": rows * sdf_f * 4 * 3.0,
        f"sdf_value_fwdbwd1st_{n_core}spp": rows * sdf_f * 3.0,
        f"color_fwdbwd_{n_core}spp": rows * color_f * 3.0,
        f"bg_nerf_fwdbwd_{n_bg}spp": B * n_bg * nerf_f * 3.0,
    }
    if s["rs"]:
        rs_rows = B * s["rs"]
        flops[f"sdf_valgradfeat_{s['rs']}spp"] = rs_rows * sdf_f * 4
        flops[f"color_net_{s['rs']}spp"] = rs_rows * color_f
        flops[f"sdf_vgf_fwdbwd2nd_{s['rs']}spp"] = rs_rows * sdf_f * 4 * 3.0
        flops[f"color_fwdbwd_{s['rs']}spp"] = rs_rows * color_f * 3.0
    return flops


def make_inputs(nets, s: dict, dev, seed: int = 0) -> dict:
    """Seeded inputs at the components' shapes: points in the unit ball,
    unit directions, features, sorted z, sdf values, weights, alphas, and
    rays from a sphere of radius 3 aimed at the unit sphere."""
    g = torch.Generator().manual_seed(seed)
    B = s["B"]

    def pts(n):
        return torch.randn(n, 3, generator=g) * 0.5

    def unit(x):
        return x / torch.linalg.norm(x, dim=-1, keepdim=True)

    rng = np.random.default_rng(seed)

    def rays(n):
        o = rng.normal(size=(n, 3))
        o = 3.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
        d = rng.uniform(-0.6, 0.6, size=(n, 3)) - o
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return torch.tensor(o, dtype=torch.float32), torch.tensor(d, dtype=torch.float32)

    n_s, per_round = s["n_s"], s["per_round"]
    d_feat = nets.color.d_feature
    out = {"pts_s": pts(B * n_s)}
    for n in {s["n_core"], s["step_core"]} | ({s["rs"]} if s["rs"] else set()):
        p = pts(B * n)
        out[f"pts_{n}"], out[f"dirs_{n}"] = p, unit(p)
        out[f"feat_{n}"] = torch.randn(B * n, d_feat, generator=g)
    for n in {s["n_bg"], s["step_bg"]} - {0}:
        p = pts(B * n)
        out[f"pts4_{n}"] = torch.cat([p, torch.ones(B * n, 1)], -1)
        out[f"views_{n}"] = torch.tensor([0.0, 0.0, 1.0]).expand(B * n, 3).contiguous()
    out["rays_o"], out["rays_d"] = rays(B)
    out["chunk_o"], out["chunk_d"] = rays(SERVING_RAYS)
    out["z0"] = torch.sort(torch.rand(B, n_s, generator=g) * 2.0 + 2.0, -1).values
    out["sdf0"] = torch.randn(B, n_s, generator=g) * 0.1
    n_bins = n_s + 3 * per_round
    out["z_last"] = torch.sort(torch.rand(B, n_bins, generator=g) * 2.0 + 2.0, -1).values
    out["w_last"] = torch.rand(B, n_bins - 1, generator=g) + 0.01
    out["alpha0"] = torch.rand(B, s["n_bg"], generator=g) * 0.2
    out = {k: v.to(dev) for k, v in out.items()}
    out["near"], out["far"] = near_far_from_sphere(out["rays_o"], out["rays_d"])
    out["chunk_near"], out["chunk_far"] = near_far_from_sphere(out["chunk_o"], out["chunk_d"])
    return out


def _eikonal_scalar(s, g, f):
    return (s.sum() + ((torch.linalg.norm(g, dim=-1) - 1.0) ** 2).sum() + f.float().sum()) * 1e-6


def forward_components(nets, model, s: dict, x: dict) -> dict:
    """{name: fn() -> its output(s)}, the forward components (no parameter
    gradients)."""
    sdf = model.sdf_network_fine
    color = model.color_network_fine
    ones = torch.ones(1, 3, device=x["rays_o"].device)
    n_s, per_round, n_core, n_bg = s["n_s"], s["per_round"], s["n_core"], s["n_bg"]

    def no_grad(fn):
        def run():
            with torch.no_grad():
                return fn()
        return run

    comps = {f"sdf_fwd_{n_s}spp": lambda: sdf.sdf_value(x["pts_s"])}
    widths = [n_core] + ([s["rs"]] if s["rs"] else [])
    for n in widths:
        comps[f"sdf_valgradfeat_{n}spp"] = no_grad(lambda n=n: sdf.sdf_value_grad_feat(x[f"pts_{n}"]))
        comps[f"color_net_{n}spp"] = no_grad(lambda n=n: color(
            x[f"pts_{n}"], x[f"dirs_{n}"], x[f"dirs_{n}"], x[f"feat_{n}"]))
    comps[f"bg_nerf_{n_bg}spp"] = no_grad(lambda: model.nerf(x[f"pts4_{n_bg}"], x[f"views_{n_bg}"]))
    comps[f"up_sample_round({n_s}spp)"] = no_grad(lambda: up_sample(
        x["rays_o"], x["rays_d"], x["z0"], x["sdf0"], per_round, 64.0))
    comps[f"sample_pdf({n_s + 3 * per_round}bins)"] = no_grad(lambda: sample_pdf(
        x["z_last"], x["w_last"], per_round, det=True))
    comps[f"transmittance_{n_bg}"] = lambda: x["alpha0"] * transmittance(x["alpha0"])
    comps["full_render_fwd"] = no_grad(lambda: render(
        nets, model, x["rays_o"], x["rays_d"], x["near"], x["far"], perturb_overwrite=0,
        background_rgb=ones, cos_anneal_ratio=1.0)["color_fine"])
    comps["ladder"] = no_grad(lambda: _ladder(
        model, nets.renderer, x["rays_o"], x["rays_d"],
        x["near"] + (x["far"] - x["near"]) * torch.linspace(0.0, 1.0, n_s, device=x["near"].device),
        s["step_core"] != n_core, 0.0, None))
    comps[f"serving_chunk_{SERVING_RAYS}"] = no_grad(lambda: render(
        nets, model, x["chunk_o"], x["chunk_d"], x["chunk_near"], x["chunk_far"],
        perturb_overwrite=0, background_rgb=ones, cos_anneal_ratio=1.0)["color_fine"])
    return comps


def backward_components(nets, model, s: dict, x: dict) -> dict:
    """{name: fn() -> the parameter gradients}: forward and backward of each
    block, the gradients taken with ``torch.autograd.grad`` of a scalar that
    touches every output (the eikonal term's norm of the SDF gradient, as
    the loss does)."""
    sdf, color, nerf = model.sdf_network_fine, model.color_network_fine, model.nerf
    sdf_p, color_p, nerf_p = (list(m.parameters()) for m in (sdf, color, nerf))
    # what the render core differentiates: all but the background NeRF
    core_p = [p for n, p in model.named_parameters() if not n.startswith("nerf.")]

    def grads(scalar, params):
        return torch.autograd.grad(scalar, params, allow_unused=True)

    def vgf(n):
        return grads(_eikonal_scalar(*sdf.sdf_value_grad_feat(x[f"pts_{n}"])), sdf_p)

    def value(n):
        v, f = sdf.forward_split(x[f"pts_{n}"])
        return grads((v.sum() + f.float().sum()) * 1e-6, sdf_p)

    def head(n):
        out = color(x[f"pts_{n}"], x[f"dirs_{n}"], x[f"dirs_{n}"], x[f"feat_{n}"])
        return grads(out.sum() * 1e-6, color_p)

    def bg(n):
        d, c, _ = nerf(x[f"pts4_{n}"], x[f"views_{n}"])
        return grads((d.sum() + c.sum()) * 1e-6, nerf_p)

    def core(n):
        # the render core over n sorted samples a ray inside the sphere,
        # without the background: the SDF block, the colour head, the alpha
        # and transmittance composites
        B = s["B"]
        t = torch.linspace(0.0, 1.0, n, device=x["near"].device)
        z = x["near"] + (x["far"] - x["near"]) * t
        out = render_core(nets, model, x["rays_o"], x["rays_d"], z, 2.0 / s["n_s"],
                          background_rgb=torch.ones(1, 3, device=z.device), cos_anneal_ratio=1.0)
        scalar = (out["color"].sum() + out["gradient_error_num"].sum()) * 1e-6 / B
        return grads(scalar, core_p)

    comps = {}
    widths = [s["n_core"]] + ([s["rs"]] if s["rs"] else [])
    for n in widths:
        comps[f"sdf_vgf_fwdbwd2nd_{n}spp"] = lambda n=n: vgf(n)
        if n == s["n_core"]:
            comps[f"sdf_value_fwdbwd1st_{n}spp"] = lambda n=n: value(n)
        comps[f"color_fwdbwd_{n}spp"] = lambda n=n: head(n)
    comps[f"bg_nerf_fwdbwd_{s['n_bg']}spp"] = lambda: bg(s["n_bg"])
    # the step's own shapes (its core is one of the widths above)
    n = s["step_core"]
    comps[f"render_core_fwdbwd_{n}spp"] = lambda: core(n)
    if s["step_bg"] and s["step_bg"] != s["n_bg"]:
        comps[f"bg_nerf_fwdbwd_{s['step_bg']}spp"] = lambda: bg(s["step_bg"])
    return comps


class Timer:
    """ms a call of a component: ``iters`` calls captured as one CUDA graph
    on the card, replayed twice, the better replay's time by CUDA events
    over ``iters`` (``mode`` "graph"; a capture error raises); on the CPU
    the same loop by the host clock."""

    def __init__(self, dev: torch.device, iters: int):
        self.dev = dev
        self.iters = iters
        self.ms: dict[str, float] = {}
        self.mode: dict[str, str] = {}

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _host(self, fn, iters: int) -> float:
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            best = min(best, time.perf_counter() - t0)
        return best * 1e3 / iters

    def _graph(self, fn, iters: int) -> float:
        side = torch.cuda.Stream(self.dev)
        side.wait_stream(torch.cuda.current_stream(self.dev))
        with torch.cuda.stream(side):  # PyTorch's warm-up before a capture
            fn()
            fn()
        torch.cuda.current_stream(self.dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        best = float("inf")
        for _ in range(2):
            start.record()
            graph.replay()
            stop.record()
            stop.synchronize()
            best = min(best, start.elapsed_time(stop))
        del graph
        return best / iters

    def __call__(self, name: str, fn, iters: int | None = None) -> float:
        iters = iters or self.iters
        fn()  # fills the wrappers' index caches before any capture
        self._sync()
        if self.dev.type == "cuda":
            ms, mode = self._graph(fn, iters), "graph"
        else:
            ms, mode = self._host(fn, iters), "host clock"
        self.ms[name], self.mode[name] = ms, mode
        print(f"  {name:<32s} {ms:9.3f} ms ({mode})", file=sys.stderr, flush=True)
        return ms


def step_batch(tcfg, nets, batch: int, seed: int = 0) -> tuple[dict, dict]:
    """(cameras, host pixel batch) of one 400x300 camera 3 units from the
    sphere, as ``profile_render --train``'s."""
    W, H, focal = 400, 300, 300.0
    intrin = torch.tensor([[focal, 0, W / 2, 0], [0, focal, H / 2, 0], [0, 0, 1, 0],
                           [0, 0, 0, 1]])
    pose = torch.eye(4)
    pose[2, 3] = -3.0
    cams = {"pose_all": pose[None], "intrin_inv_all": torch.linalg.inv(intrin)[None]}
    rng = np.random.default_rng(seed)
    d_feat = nets.depth.d_out if nets.depth else 1
    host = {
        "img_idx": np.int32(0),
        "pixels_x": rng.integers(0, W, size=batch).astype(np.int32),
        "pixels_y": rng.integers(0, H, size=batch).astype(np.int32),
        "color": rng.uniform(0, 1, size=(batch, 3)).astype(np.float32),
        "mask": np.ones((batch, 1), np.float32),
        "feats": rng.uniform(0, 1, size=(batch, d_feat)).astype(np.float32),
    }
    return cams, host


def time_steps(conf, nets, tcfg, policy, mlp, dev, batch: int, n: int) -> float:
    """ms a training step: windows of ``n`` steps through ``StepDispatch``
    (each step a replay of the captured step on the card), the better of
    two after the warm-up steps and the capture."""
    cams, host = step_batch(tcfg, nets, batch)
    cams = {k: v.to(dev) for k, v in cams.items()}
    model = build_model(conf, nets, seed=0, matmul_dtype=policy, mlp_dtype=mlp).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    dispatch = StepDispatch(Trainer(tcfg, model, cams, gen))
    counter = iter(range(10**9))

    def window(k):
        dispatch.run([next(counter) for _ in range(k)], [nets] * k, [host] * k)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    window(WARMUP_STEPS + 1)
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        window(n)
        best = min(best, time.perf_counter() - t0)
    return best * 1e3 / n


def dispatch_floor_ms(dev: torch.device) -> float:
    """ms of one replay of a graph holding one tiny kernel: the floor under
    every graph-timed loop (0 on the CPU)."""
    if dev.type != "cuda":
        return 0.0
    x = torch.ones(8, device=dev)
    timer = Timer(dev, 1)
    return timer("floor", lambda: x.mul_(1.0), 1)


def main(argv=None, device=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(device, args.gpu)
    configure_numerics()
    card = card_line() if dev.type == "cuda" else None
    conf = load_conf(args.conf, "profile")
    # the conf's networks and step on fixed cameras, without the distillation
    # term (the JAX tool's step)
    tcfg = dataclasses.replace(TrainConfig.from_conf(conf), batch_size=args.batch,
                               extract_depth=False, learnable=False, grad_accum=1)
    nets = build_networks(conf, False)
    if args.fast_bg or args.render_samples:
        nets = dataclasses.replace(nets, renderer=dataclasses.replace(
            nets.renderer, skip_bg_inside=args.fast_bg, n_render_samples=args.render_samples,
            resample_uniform_frac=args.resample_frac))
    rs = nets.renderer.n_render_samples
    policy = matmul_dtype(not args.fp32)
    mlp = mlp_operand_dtype(policy, args.fused or env_fused())
    model = build_model(conf, nets, seed=0, matmul_dtype=policy, mlp_dtype=mlp).to(dev)
    s = shapes(nets, args.batch, rs)
    x = make_inputs(nets, s, dev)
    print(f"device: {dev} ({card}), batch {args.batch}, SDF block "
          f"{'bf16' if policy else 'f32'}, K2-K5 operands {mlp}", file=sys.stderr)

    floor = dispatch_floor_ms(dev)
    timer = Timer(dev, args.iters)
    loop = max(args.iters // 2, 10)
    for name, fn in forward_components(nets, model, s, x).items():
        timer(name, fn, loop if name in ("full_render_fwd", "ladder") else None)
    step_ms = timer.ms["full_train_step"] = time_steps(conf, nets, tcfg, policy, mlp, dev,
                                                      args.batch, loop)
    timer.mode["full_train_step"] = "graph per step" if dev.type == "cuda" else "host clock"
    print(f"  {'full_train_step':<32s} {step_ms:9.3f} ms", file=sys.stderr)

    if not args.no_bwd:
        for name, fn in backward_components(nets, model, s, x).items():
            timer(name, fn)
        cams, host = step_batch(tcfg, nets, args.batch)
        cams = {k: v.to(dev) for k, v in cams.items()}
        trainer = Trainer(tcfg, model, cams, None)
        trainer.set_inputs(tcfg.warm_up_end)
        batch = upload_batch(host, dev)
        fwd_nets = dataclasses.replace(nets, renderer=dataclasses.replace(nets.renderer,
                                                                          perturb=0.0))

        def loss_fwd():
            with torch.no_grad():
                return loss_fn(fwd_nets, tcfg, model, cams, batch, trainer.inputs, False,
                               None)[0]

        timer("full_loss_fwd_only", loss_fwd, loop)
        timer.ms["full_step_igr0"] = time_steps(conf, nets, dataclasses.replace(
            tcfg, igr_weight=0.0), policy, mlp, dev, args.batch, loop)
        timer.mode["full_step_igr0"] = timer.mode["full_train_step"]

    flops = flop_table(nets, args.batch, rs)
    if args.batch_sweep:
        color, nerf = model.color_network_fine, model.nerf
        for rows in SWEEP_ROWS:
            g = torch.Generator().manual_seed(rows)
            p = (torch.randn(rows, 3, generator=g) * 0.5).to(dev)
            d = p / torch.linalg.norm(p, dim=-1, keepdim=True)
            f = torch.randn(rows, nets.color.d_feature, generator=g).to(dev)
            p4 = torch.cat([p, torch.ones(rows, 1, device=dev)], -1)
            it = max(8, 80 * 65536 // rows)
            with torch.no_grad():
                timer(f"color_rows{rows}", lambda: color(p, d, d, f), it)
                timer(f"nerf_rows{rows}", lambda: nerf(p4, d), it)
            flops[f"color_rows{rows}"] = rows * mlp_flops(nets.color.dims)
            flops[f"nerf_rows{rows}"] = rows * nerf_flops(nets.nerf)

    ms = timer.ms
    derived = {}
    pairs = {
        f"sdf_vgf_bwd_{s['n_core']}spp": (f"sdf_vgf_fwdbwd2nd_{s['n_core']}spp",
                                          f"sdf_valgradfeat_{s['n_core']}spp"),
        f"color_bwd_{s['n_core']}spp": (f"color_fwdbwd_{s['n_core']}spp",
                                        f"color_net_{s['n_core']}spp"),
        f"bg_nerf_bwd_{s['n_bg']}spp": (f"bg_nerf_fwdbwd_{s['n_bg']}spp",
                                        f"bg_nerf_{s['n_bg']}spp"),
        "full_bwd_plus_adam": ("full_train_step", "full_loss_fwd_only"),
        "eikonal_2nd_order_cost": ("full_train_step", "full_step_igr0"),
    }
    if s["rs"]:
        pairs[f"sdf_vgf_bwd_{s['rs']}spp"] = (f"sdf_vgf_fwdbwd2nd_{s['rs']}spp",
                                              f"sdf_valgradfeat_{s['rs']}spp")
        pairs[f"color_bwd_{s['rs']}spp"] = (f"color_fwdbwd_{s['rs']}spp",
                                            f"color_net_{s['rs']}spp")
    for name, (a, b) in pairs.items():
        if a in ms and b in ms:
            derived[name] = ms[a] - ms[b]

    # the step split into its parts at its own shapes: the render core's
    # forward-and-backward less the SDF block's and the colour head's is
    # the composites'
    parts = None
    n = s["step_core"]
    core = f"render_core_fwdbwd_{n}spp"
    if core in ms:
        bg = f"bg_nerf_fwdbwd_{s['step_bg']}spp"
        parts = {
            "ladder": ms["ladder"],
            "background_nerf_fwdbwd": ms.get(bg, 0.0),
            "sdf_block_fwd": ms[f"sdf_valgradfeat_{n}spp"],
            "sdf_block_double_bwd": (ms[f"sdf_vgf_fwdbwd2nd_{n}spp"]
                                     - ms[f"sdf_valgradfeat_{n}spp"]),
            "colour_head_fwdbwd": ms[f"color_fwdbwd_{n}spp"],
            "composites_fwdbwd": (ms[core] - ms[f"sdf_vgf_fwdbwd2nd_{n}spp"]
                                  - ms[f"color_fwdbwd_{n}spp"]),
        }
        parts["sum"] = sum(parts.values())
        parts["rest_rays_loss_adam"] = step_ms - parts["sum"]

    report = {"batch": args.batch, "bf16": not args.fp32, "fused": mlp == torch.bfloat16,
              "fast_bg": nets.renderer.skip_bg_inside, "render_samples": rs,
              "dispatch_floor_ms": floor, "components_ms": dict(ms),
              "derived_bwd_ms": derived, "tflops_est": {},
              "share_of_step": {k: v / step_ms for k, v in ms.items()},
              "step_parts_ms": parts,
              "components_sum_ms": None if parts is None else parts["sum"],
              "full_train_step_ms": step_ms, "timing": dict(timer.mode),
              "config": {**vars(args), "device": str(dev), "card": card,
                         "mlp_operands": str(mlp).replace("torch.", ""),
                         "sdf_block": "bf16" if policy else "f32"}}
    print(f"\n{'component':<32s} {'ms':>9s} {'% step':>7s} {'TF/s':>7s}", file=sys.stderr)
    for name, v in ms.items():
        tfs = flops[name] / (v * 1e-3) / 1e12 if name in flops and v > 0 else None
        report["tflops_est"][name] = tfs
        print(f"{name:<32s} {v:9.3f} {100 * v / step_ms:6.1f}%"
              + (f" {tfs:7.2f}" if tfs else ""), file=sys.stderr)
    report["rays_per_sec"] = args.batch / (step_ms * 1e-3)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({"rays_per_sec": report["rays_per_sec"], "step_ms": step_ms,
                      "components_sum_ms": report["components_sum_ms"], "card": card}))
    return report


if __name__ == "__main__":
    main()
