"""Traffic kind ``train_window``: the training loop's body, replayed.

Steps are numbered from the mix's ``start_step``; each window of K steps
(the conf's ``steps_per_call`` as the runner clips it) is what
``Runner.train`` does for it: the image permutation and ``sample_pixels``
for each step (span ``runner.sample``), ``StepDispatch.run`` (span
``dispatch.run``: three eager steps of the program, its capture, then graph
replays) and ``Window.read`` (span ``window.read``). No validation, save or
mesh falls in it. A closed loop: the next window starts when the last one's
metrics are on the host.

Set-up runs the program's first steps in the windows ``check_windows``
(their sum a multiple of K), keeping their batches, losses, the first
step's gradient as Adam holds it and the parameters' change after
``change_after`` steps; then ``warm_windows`` windows of K. After the timed
window, the program freed, the reference follows the same steps from the
same weights, batches and random numbers (:meth:`Driver.numbers`).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from vdnbench import work
from vdnbench.drivers.common import (Base, leaf_diffs, leaf_gaps, median_of, norms, own_diffs,
                                     quarter_rates, worse, worst_of)
from vdnbench.reference import neus
from vdnbench.scene import pixel_table
from vdnbench.trace import Record


# the colour head's leaves: every product of the step feeds their gradient
COLOUR_HEAD = "color_network_fine."


class Driver(Base):
    SPANS = ("runner.sample", "dispatch.run", "window.read")

    def setup(self) -> None:
        from vdnerf_tpu_torch.runner import window_size
        from vdnerf_tpu_torch.train.dispatch import StepDispatch

        t = self.traffic
        self.runner = r = self.make_runner("train")
        self.step = t["start_step"]
        r.iter_step = self.step
        self.K = window_size(r.tcfg, r.tcfg.end_iter - self.step, self.step, 0)
        if sum(t["check_windows"]) % self.K:
            raise ValueError("the check's windows have to end on a window boundary")
        self.dispatch = StepDispatch(r.trainer)
        self.n_images = r.scene_data.n_images
        self.perm = r.rng.permutation(self.n_images)
        self.pos = 0
        self.batch_size = r.tcfg.batch_size
        self.checked = {"steps": [], "batches": [], "losses": [], "rows": []}
        done = 0
        for n in t["check_windows"]:
            steps = list(range(self.step, self.step + n))
            rows, batches = self.one_window(n)
            self.checked["steps"] += steps
            self.checked["batches"] += batches
            self.checked["losses"] += [row["loss"] for row in rows]
            self.checked["rows"] += rows
            done += n
            if done == 1:
                self.prog_grad = self.adam_gradients()
            if done == t["change_after"]:
                self.prog_change = self.changes()
        self.mark("checked_steps")
        for _ in range(t["warm_windows"]):
            self.one_window(self.K)
        self.sync()
        self.mark("warm")

    def one_window(self, n: int):
        """n steps as ``Runner.train`` runs a window -> (metric rows, host
        batches)."""
        from vdnerf_tpu_torch.runner import shard_batch

        r = self.runner
        with self.spans("runner.sample"):
            batches = []
            for _ in range(n):
                idx = int(self.perm[self.pos % self.n_images])
                batch = r.store.sample_pixels(idx, self.batch_size, r.rng)
                batches.append(shard_batch(batch, r.world, r.tcfg.grad_accum))
                self.pos += 1
                if self.pos % self.n_images == 0:
                    self.perm = r.rng.permutation(self.n_images)
        steps = range(self.step, self.step + n)
        with self.spans("dispatch.run"):
            window = self.dispatch.run(steps, [r.nets] * n, batches)
        with self.spans("window.read"):
            rows = window.read()
        self.step += n
        r.iter_step = self.step
        return rows, batches

    def adam_gradients(self) -> dict[str, torch.Tensor]:
        """Each leaf's first gradient, as Adam's first moment holds it after
        one step (0.1 g), on the host; zeros where Adam holds none."""
        state = self.runner.trainer.optimizer.state
        with torch.no_grad():
            return {k: (state[p]["exp_avg"] / 0.1 if "exp_avg" in state.get(p, {})
                        else torch.zeros_like(p)).cpu()
                    for k, p in self.runner.model.named_parameters()}

    def changes(self) -> dict[str, torch.Tensor]:
        """Each leaf's change from the cell's weights, on the host."""
        with torch.no_grad():
            return {k: (p - self.weights[k]).cpu() for k, p in self.runner.model.named_parameters()}

    def window(self, seconds: float) -> dict:
        from vdnerf_tpu_torch.ops.kernels import build

        self.spans.reset()
        build.reset_launches()
        steps = failed = 0
        ends = []
        t0 = time.perf_counter()
        while True:
            rows, _ = self.one_window(self.K)
            steps += self.K
            failed += sum(not math.isfinite(row["loss"]) for row in rows)
            ends.append((time.perf_counter() - t0, steps))
            if ends[-1][0] >= seconds:
                break
        self.sync()
        elapsed = time.perf_counter() - t0
        self.timed = {"units": steps, "seconds": elapsed, "host_s": dict(self.spans.host_s)}
        launches = {k: v / steps for k, v in build.LAUNCHES.items() if v}
        return {"values": {"train_rays_per_s": steps * self.batch_size / elapsed},
                "attempted": steps, "failed": failed,
                "info": {"steps": steps, "window_s": elapsed, "ms_per_step": elapsed / steps * 1e3,
                         "rays_per_s_by_quarter": quarter_rates(ends, elapsed, self.batch_size),
                         "launches_per_step": launches}}

    def sizes(self) -> dict:
        return {"kind": self.traffic["kind"], "batch_size": self.batch_size}

    def traced(self) -> Record:
        n = self.traffic["traced_steps"]
        events, spans = self.profile(lambda: [self.one_window(self.K) for _ in range(n // self.K)])
        return Record(n // self.K * self.K, events, spans, self.timed["units"],
                      self.timed["seconds"], self.timed["host_s"],
                      work.counts(self.model_cfg, self.sizes()))

    def reference(self, precision: str = "f32") -> dict:
        """The reference's readings of the checked steps, from the cell's
        weights, the scene's pixels at the seed's draws (:meth:`pixel_draws`)
        and a generator seeded as the program's: each step's loss, the first
        gradient and the parameters' change after ``change_after`` steps,
        per leaf, on the host. Also ``batch_gap``: the program's batches against
        those draws and pixels (1 where a draw differs)."""
        neus.plain_numerics()
        dev = self.device
        table = pixel_table(self.made)
        batches, batch_gap = [], 0.0
        n = self.traffic["change_after"]
        for b, (img, px, py) in zip(self.checked["batches"][:n], self.pixel_draws(n)):
            color = table["color"][img, py, px]
            feats = (table["feats"][img, py, px].astype(np.float32) if table["feats"] is not None
                     else np.zeros((len(px), 1), np.float32))
            same = (int(b["img_idx"]) == img and np.array_equal(b["pixels_x"], px)
                    and np.array_equal(b["pixels_y"], py))
            batch_gap = worse(batch_gap, 0.0 if same else 1.0)
            if same:
                batch_gap = worse(batch_gap, worse(float(np.abs(b["color"] - color).max()),
                                                   float(np.abs(b["feats"] - feats).max())))
            batches.append({"img": img, "px": torch.as_tensor(px, device=dev),
                            "py": torch.as_tensor(py, device=dev),
                            "color": torch.as_tensor(color, device=dev),
                            "feats": torch.as_tensor(feats, device=dev)})
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        ref = neus.train_steps(self.train_cfg, self.model_cfg, self.weights, batches,
                               self.cams(), self.checked["steps"][:n], gen, precision)
        return {"losses": ref["losses"], "rows": ref["metrics"],
                "grad": {k: g.cpu() for k, g in ref["first_grad"].items()},
                "change": {k: (v - self.weights[k]).cpu() for k, v in ref["params"].items()},
                "batch_gap": batch_gap}

    def pixel_draws(self, n: int):
        """The first n steps' (image, pixels x, pixels y), drawn again from
        the seed as the training loop's host stream draws them: a
        permutation of the images, then per step the x and the y of every
        ray, uniform over the image."""
        rng = np.random.default_rng(self.seed)
        count, (H, W) = len(self.made["images"]), self.made["images"].shape[1:3]
        perm = rng.permutation(count)
        for k in range(n):
            img = int(perm[k % count])
            px = rng.integers(0, W, size=self.batch_size).astype(np.int32)
            py = rng.integers(0, H, size=self.batch_size).astype(np.int32)
            if (k + 1) % count == 0:
                perm = rng.permutation(count)
            yield img, px, py

    def readings(self) -> dict:
        """The program's readings, as :meth:`reference` gives the reference's."""
        n = self.traffic["change_after"]
        return {"losses": self.checked["losses"][:n], "rows": self.checked["rows"][:n],
                "grad": self.prog_grad, "change": self.prog_change}

    @staticmethod
    def compare(got: dict, ref: dict) -> dict:
        """``loss_gap``: the worst step's relative gap; ``grad_gap``,
        ``change_gap``: the worst leaf's gap of norms against the larger of
        its own and the median leaf's reference norm; ``grad_diff``,
        ``change_diff``: the worst leaf's norm of the difference, against the
        same; ``_median`` the median leaf's; ``grad_diff_colour``: the
        median over the colour head's leaves of the norm of the difference
        against the leaf's own reference norm (the colour loss alone
        reaches them, not the distillation's L1, whose signs turn with the
        rounding). The change leaves out the leaves
        whose reference gradient is under a thousandth of the median leaf's
        (they move by round-off alone)."""
        gaps = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"], strict=True)]
        loss_gap = 0.0
        for g in gaps:
            loss_gap = worse(loss_gap, g)
        ref_grad = norms(ref["grad"])
        med = float(np.median(list(ref_grad.values())))
        moved = [k for k, v in ref_grad.items() if v >= 1e-3 * med]
        per_leaf = {
            "grad_gap": leaf_gaps(norms(got["grad"]), ref_grad),
            "change_gap": leaf_gaps(norms(got["change"]), norms(ref["change"]), moved),
            "grad_diff": leaf_diffs(got["grad"], ref["grad"]),
            "change_diff": leaf_diffs(got["change"], ref["change"], moved),
        }
        colour = [k for k in ref_grad if k.startswith(COLOUR_HEAD) and ref_grad[k] > 0]
        out = {"loss_gap": loss_gap, "loss_gap_first": gaps[0],
               "grad_diff_colour": median_of(own_diffs(got["grad"], ref["grad"], colour))}
        worst = {"loss_gaps": gaps, "left_out": sorted(set(ref_grad) - set(moved))}
        for name, leaves in per_leaf.items():
            out[name], worst[name] = worst_of(leaves)
            out[name + "_median"] = median_of(leaves)
        return {**out, "worst": worst}

    def numbers(self) -> dict:
        ref = self.reference()
        out = self.compare(self.readings(), ref)
        self.detail = out.pop("worst")
        return {**out, "batch_gap": ref["batch_gap"]}
