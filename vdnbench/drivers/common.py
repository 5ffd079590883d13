"""What every traffic kind's driver shares: the scene and the conf under the
run's working directory, the program's ``Runner`` on the cell's weights, and
the check that the program runs at the precision the configuration states.
"""

from __future__ import annotations

import gc
import math
import os
import time

import numpy as np
import torch

from vdnbench import scene, weights
from vdnbench.harness import Spans, write_conf


class Base:
    SPANS: tuple[str, ...] = ()

    def __init__(self, cell: dict, seed: int, device, workdir: str):
        self.cell = cell
        self.seed = int(seed)
        self.device = torch.device(device)
        self.workdir = workdir
        self.config = cell["config"]
        self.traffic = cell["traffic"]
        self.model_cfg = self.config["conf"]["model"]
        self.train_cfg = self.config["conf"]["train"]
        self.spans = Spans()
        # the precision the program has to run at: the configuration's,
        # unless a control asks for the program's lower one
        self.precision = dict(self.config["precision"])
        self.marks: list[tuple[str, float]] = []

    def mark(self, phase: str) -> None:
        """The end of a phase of set-up, on the host clock."""
        self.marks.append((phase, time.perf_counter()))

    def make_runner(self, mode: str):
        """The scene, the conf and the program's Runner, its networks loaded
        with the cell's weights."""
        from vdnerf_tpu_torch.runner import Runner

        data_dir = os.path.join(self.workdir, "scene")
        depth = None
        if "depth_extract_network" in self.model_cfg:
            depth = (self.config["conf"]["dataset"]["depth_dir"],
                     self.model_cfg["depth_extract_network"]["d_out"])
        self.mark("imports")
        self.made = scene.make(data_dir, self.config["scene"], self.seed, depth)
        self.mark("scene")
        overrides = {"general.base_exp_dir": os.path.join(self.workdir, "exp"),
                     "general.recording": [], "dataset.data_dir": data_dir}
        conf = write_conf(self.config, os.path.join(self.workdir, "bench.conf"), overrides,
                          self.precision.get("conf"))
        runner = Runner(conf, case="bench", seed=self.seed, device=self.device, mode=mode)
        self.mark("runner")
        self.weights = weights.make(self.model_cfg, self.seed, self.device)
        runner.model.load_state_dict(self.weights)
        self.mark("weights")
        sdf_dtype = runner.model.sdf_network_fine.matmul_dtype
        got = {"sdf_block": "bf16" if sdf_dtype is not None else "f32",
               "mlp_operands": "bf16" if runner.mlp_dtype == torch.bfloat16 else "f32"}
        want = {k: self.precision[k] for k in got}
        if got != want:
            raise RuntimeError(f"the program runs at {got}, the configuration states {want}")
        return runner

    def cams(self) -> dict:
        """The scene's cameras as the benchmark made them, for the reference."""
        c2w = torch.as_tensor(self.made["c2w"], dtype=torch.float32, device=self.device)
        K_inv = torch.as_tensor(np.linalg.inv(self.made["K"]), dtype=torch.float32,
                                device=self.device)
        return {"c2w": c2w, "K_inv": K_inv.expand(len(c2w), 4, 4)}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        for name in ("runner", "dispatch", "renderer"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def profile(self, fn):
        """Run ``fn`` under the profiler with the spans recorded -> (device
        events, spans)."""
        from torch.profiler import ProfilerActivity, profile

        from vdnbench.trace import from_profiler

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.spans.tracing = True
        try:
            with profile(activities=acts) as prof:
                fn()
                self.sync()
        finally:
            self.spans.tracing = False
        return from_profiler(prof, self.SPANS)


def quarter_rates(ends: list[tuple[float, int]], elapsed: float, per_unit: float) -> list[float]:
    """The rate in each quarter of a window, from ``ends`` (the host time
    since the window's start at which each unit or group of units ended, and
    the units done by then): between the first and the last end inside the
    quarter, so that no unit is split. Where a run's quarters agree closely
    and its rate differs from another run's, a longer window would not
    narrow the spread."""
    rates = []
    for q in range(4):
        inside = [(t, n) for t, n in ends if q * elapsed / 4 <= t <= (q + 1) * elapsed / 4]
        if len(inside) >= 2 and inside[-1][0] > inside[0][0]:
            (t0, n0), (t1, n1) = inside[0], inside[-1]
            rates.append((n1 - n0) * per_unit / (t1 - t0))
    return rates


def worse(a: float, b: float) -> float:
    """The larger of two gaps; NaN if either is."""
    return math.nan if math.isnan(a) or math.isnan(b) else max(a, b)


def leaf_gaps(program: dict, reference: dict, keep=None) -> dict[str, float]:
    """Each leaf's |program norm - reference norm| / max(reference norm, the
    median leaf's reference norm). ``keep``: the leaves compared (default
    all)."""
    ref = {k: float(v) for k, v in reference.items()}
    med = float(np.median(list(ref.values())))
    return {k: abs(float(program[k]) - ref[k]) / max(ref[k], med)
            for k in (keep if keep is not None else ref)}


def norms(leaves: dict) -> dict[str, float]:
    """Each leaf's norm, in float64."""
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def leaf_diffs(program: dict, reference: dict, keep=None) -> dict[str, float]:
    """Each leaf's ||program - reference|| / max(reference norm, the median
    leaf's reference norm), in float64. ``keep``: the leaves compared
    (default all)."""
    ref = norms(reference)
    med = float(np.median(list(ref.values())))
    return {k: float((program[k].double() - reference[k].double()).norm()) / max(ref[k], med)
            for k in (keep if keep is not None else ref)}


def own_diffs(program: dict, reference: dict, keep) -> dict[str, float]:
    """Each kept leaf's ||program - reference|| / its own reference norm, in
    float64."""
    return {k: float((program[k].double() - reference[k].double()).norm())
            / float(reference[k].double().norm()) for k in keep}


def worst_of(gaps: dict[str, float]) -> tuple[float, str]:
    """The largest of per-leaf gaps -> (gap, leaf); NaN if any is."""
    worst, leaf = 0.0, ""
    for k, gap in gaps.items():
        if math.isnan(gap):
            return gap, k
        if gap > worst:
            worst, leaf = gap, k
    return worst, leaf


def median_of(gaps: dict[str, float]) -> float:
    """The median of per-leaf gaps; NaN if any is."""
    values = list(gaps.values())
    return math.nan if any(math.isnan(g) for g in values) else float(np.median(values))
