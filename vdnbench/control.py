"""The check's two readings for a cell, on many seeds in one process.

    python3 vdnbench/control.py --workload <name> --seeds 1,2,3 [--seconds 4]
        [--modes program,tf32,bf16,half_batch,unchanged] [--out FILE]

For each seed the cell is set up as a benchmark run sets it up (for a views
cell with a short window at its own load), and every number its check
compares is read for each mode against the f32 reference:

- ``program``: the program as the configuration states it (the lower
  reading);
- ``tf32``: the reference itself, computed in TF32 (operands of every
  product rounded to 10 mantissa bits), put in the program's place: the
  nearest precision below the configuration's f32 with TF32 off (the
  control);
- ``sdf_tf32``: the program with TF32 allowed in cuBLAS and cuDNN, so
  that its plain products (the SDF block) run in TF32 and its own kernels
  as they are: the step a later change might take (the card only);
- ``bf16``: the program's own lower path, ``VDNERF_FUSED=1``,
  ``VDNERF_BF16=1`` and ``train.bf16`` (bf16 operands in K2-K5 and the SDF
  block);
- ``half_batch`` (training): the program with half of each batch left out,
  the mean taken over the rest, planted under the timed path;
- ``unchanged`` (training): the program with Adam's update left out, so each
  step returns its state unchanged;
- ``altered`` (views): the program with the first chunk of each frame
  altered by 0.01 where the renderer produces it.

Prints one JSON line a seed and mode, and writes them to ``--out``. The
benchmark's own runs run none of this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def planted(mode: str):
    """The program with ``mode``'s fault or lower path switched on."""
    import numpy as np

    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    env = {}
    if mode == "bf16":
        env = {k: os.environ.get(k) for k in ("VDNERF_FUSED", "VDNERF_BF16")}
        os.environ.update(VDNERF_FUSED="1", VDNERF_BF16="1")
    elif mode == "sdf_tf32":
        import torch

        from vdnerf_tpu_torch import runner

        configure = runner.configure_numerics

        def tf32():
            configure()
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True

        for flags in (torch.backends.cuda.matmul, torch.backends.cudnn):
            patch(flags, "allow_tf32", flags.allow_tf32)  # restored on the way out
        patch(runner, "configure_numerics", tf32)
    elif mode == "half_batch":
        from vdnerf_tpu_torch.train import step

        loss_fn = step.loss_fn

        def half(nets, tcfg, model, cams, batch, *args, **kw):
            n = batch["pixels_x"].shape[0] // 2
            return loss_fn(nets, tcfg, model, cams,
                           {k: v if k == "img_idx" else v[:n] for k, v in batch.items()},
                           *args, **kw)

        patch(step, "loss_fn", half)
    elif mode == "unchanged":
        from vdnerf_tpu_torch.train.step import Trainer

        patch(Trainer, "_update", lambda self, refine: None)
    elif mode == "altered":
        from vdnerf_tpu_torch.train.validate import ImageRenderer

        render_rays = ImageRenderer.render_rays

        def altered(self, *args, **kw):
            out = render_rays(self, *args, **kw)
            out["color"] = np.array(out["color"])
            out["color"][:self.chunk] += 0.01
            return out

        patch(ImageRenderer, "render_rays", altered)
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def plain(readings: dict) -> dict:
    """A training cell's readings with each leaf's tensor as its norm."""
    from vdnbench.drivers.common import norms

    return {k: norms(v) if k in ("grad", "change") else v for k, v in readings.items()
            if k != "batch_gap"}


def read(cell: dict, seed: int, modes: list[str], seconds: float, device,
         dump: bool = False) -> dict:
    """{mode: numbers} for one seed; ``dump``: with every reading (the steps'
    metrics, each leaf's norms) for a training cell."""
    import torch

    from vdnbench import harness

    kind = cell["traffic"]["kind"]
    Driver = harness.driver(kind)
    out, ref32, base = {}, None, None
    program_modes = [m for m in modes if m != "tf32"]
    if "tf32" in modes and "program" not in program_modes:
        program_modes.insert(0, "program")
    for mode in program_modes:
        with tempfile.TemporaryDirectory(prefix="vdnbench_") as wd, planted(mode):
            drv = Driver(cell, seed, device, wd)
            if mode == "bf16":
                drv.precision = {"sdf_block": "bf16", "mlp_operands": "bf16",
                                 "conf": {"train.bf16": True}}
            t0 = time.perf_counter()
            drv.setup()
            if kind == "views" and base is None:
                drv.window(seconds)
            elif kind == "views":  # the frames the first mode's check picked
                while drv.k <= max(base.window_frames):
                    drv.frame()
                drv.window_frames = base.window_frames
            drv.free()
            if ref32 is None:
                base = drv
                ref32 = drv.reference("f32")
            got = drv.readings()
            nums = drv.compare(got, ref32)
            if "batch_gap" in ref32:  # the same seed draws the same batches in every mode
                nums["batch_gap"] = ref32["batch_gap"]
            out[mode] = {**nums, "setup_and_window_s": time.perf_counter() - t0}
            if dump and kind != "views":
                out[mode]["readings"] = plain(got)
        if dump and kind != "views" and ref32 is not None and "f32" not in out:
            out["f32"] = {"readings": plain(ref32)}
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if "tf32" in modes:
        t0 = time.perf_counter()
        ref = base.reference("tf32")
        nums = base.compare(ref, ref32)
        if "batch_gap" in ref32:
            nums["batch_gap"] = ref32["batch_gap"]
        out["tf32"] = {**nums, "reference_s": time.perf_counter() - t0}
        if dump and kind != "views":
            out["tf32"]["readings"] = plain(ref)
    if "program" not in modes:
        out.pop("program", None)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=4.0, help="a views cell's window")
    p.add_argument("--modes", default="program,tf32,bf16")
    p.add_argument("--out", default="")
    p.add_argument("--dump", action="store_true", help="every reading, not just the numbers")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from vdnbench.run import cache_env

    cache_env(ROOT)
    import torch

    from vdnbench import harness

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    cell = harness.cell(ROOT, args.workload)
    modes = args.modes.split(",")
    for seed in (int(s) for s in args.seeds.split(",")):
        nums = read(cell, seed, modes, args.seconds, device, args.dump)
        free, total = torch.cuda.mem_get_info(device)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "device": torch.cuda.get_device_name(0),
                           "device_free_bytes": free, **nums})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
