"""Traffic kind ``views``: one client rendering the novel-view sweep, frame
after frame (a closed loop).

Frame k lies in the sweep from camera p to camera p + 1 (mod the views),
p = (k // F) mod n, at the sine-eased ratio of i = k mod F of F frames, as
``interpolate_frames`` places it. Each frame is one
``ImageRenderer.render_between`` call at the mix's resolution level (rays in
chunks, synchronised per chunk, eager, under ``no_grad``), then the ``uint8``
frame on the host (span ``render.frame``); no video is written. A frame's
latency runs from the call until that ``uint8`` frame exists.

After the timed window, the program freed, the reference renders a sample
of the window's frames drawn from the seed, and the widest colour gap is
compared (:meth:`Driver.numbers`).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from vdnbench import work
from vdnbench.drivers.common import Base, quarter_rates
from vdnbench.reference import cameras, neus
from vdnbench.trace import Record


def p95_ms(latencies) -> float:
    """The 95th percentile of every latency (seconds), in ms (linear
    interpolation between order statistics)."""
    return float(np.percentile(np.asarray(latencies, np.float64), 95)) * 1e3


class Driver(Base):
    SPANS = ("render.frame",)

    def setup(self) -> None:
        t = self.traffic
        self.runner = r = self.make_runner("interpolate_0_1")
        r.iter_step = t["step"]
        self.poses, self.intrin_inv = r.resolved_cams()
        self.n_images = r.scene_data.n_images
        self.H, self.W = r.scene_data.H, r.scene_data.W
        self.k = 0
        self.frames: dict[int, np.ndarray] = {}
        for _ in range(t["warm_frames"]):
            self.frame()
        self.sync()
        self.frames.clear()
        self.mark("warm")

    def place(self, k: int) -> tuple[int, int, float]:
        F = self.traffic["frames_per_pair"]
        p = (k // F) % self.n_images
        return p, (p + 1) % self.n_images, cameras.sweep_ratio(k % F, F)

    def frame(self) -> tuple[float, bool]:
        """Render the next frame -> (latency s, finite)."""
        r = self.runner
        a, b, ratio = self.place(self.k)
        with self.spans("render.frame"):
            t0 = time.perf_counter()
            img = r.renderer.render_between(r.model, self.poses, self.intrin_inv, a, b, ratio,
                                            self.traffic["resolution_level"], r.iter_step)
            (img * 256).clip(0, 255).astype(np.uint8)  # the frame as a video takes it
            latency = time.perf_counter() - t0
        self.frames[self.k] = img
        self.k += 1
        return latency, bool(np.isfinite(img).all())

    def window(self, seconds: float) -> dict:
        self.spans.reset()
        lat, failed, ends = [], 0, []
        first = self.k
        t0 = time.perf_counter()
        while True:
            dt, ok = self.frame()
            lat.append(dt)
            failed += not ok
            ends.append((time.perf_counter() - t0, len(lat)))
            if ends[-1][0] >= seconds:
                break
        elapsed = time.perf_counter() - t0
        self.window_frames = list(range(first, self.k))
        self.timed = {"units": len(lat), "seconds": elapsed, "host_s": dict(self.spans.host_s)}
        rays = len(lat) * self.rays_per_frame()
        return {"values": {"render_rays_per_s": rays / elapsed,
                           "frame_ms_p95": p95_ms(lat)},
                "attempted": len(lat), "failed": failed,
                "info": {"frames": len(lat), "window_s": elapsed,
                         "frame_ms_median": float(np.median(lat)) * 1e3,
                         "rays_per_s_by_quarter": quarter_rates(ends, elapsed,
                                                                self.rays_per_frame()),
                         "frame_ms_max": float(np.max(lat)) * 1e3}}

    def rays_per_frame(self) -> int:
        level = self.traffic["resolution_level"]
        return (self.W // level) * (self.H // level)

    def sizes(self) -> dict:
        return {"kind": "views", "resolution_level": self.traffic["resolution_level"],
                "H": self.H, "W": self.W}

    def traced(self) -> Record:
        n = self.traffic["traced_frames"]
        events, spans = self.profile(lambda: [self.frame() for _ in range(n)])
        return Record(n, events, spans, self.timed["units"], self.timed["seconds"],
                      self.timed["host_s"], work.counts(self.model_cfg, self.sizes()))

    def picked(self) -> list[int]:
        """The window's frames the check compares, drawn from the seed."""
        rng = np.random.default_rng([self.seed, 1])
        n = min(self.traffic["checked_frames"], len(self.window_frames))
        return sorted(int(k) for k in rng.choice(self.window_frames, n, replace=False))

    def reference(self, precision: str = "f32") -> dict:
        """The reference's colour of each picked frame, from the cell's
        weights and the scene's cameras."""
        neus.plain_numerics()
        mm = neus.MM[precision]
        t = self.traffic
        cams = self.cams()
        level, chunk = t["resolution_level"], t["chunk"]
        anneal = neus.anneal_at(self.train_cfg, t["step"])
        out = {}
        for k in self.picked():
            a, b, ratio = self.place(k)
            rays_o, rays_d = cameras.rays_between(cams["c2w"][a], cams["c2w"][b], cams["K_inv"][0],
                                                  ratio, self.H, self.W, level)
            h, w = rays_o.shape[:2]
            rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
            with torch.no_grad():
                out[k] = torch.cat([
                    neus.render(self.model_cfg, self.weights, rays_o[s:s + chunk],
                                rays_d[s:s + chunk], None, mm, train=False, anneal=anneal)["color"]
                    for s in range(0, rays_o.shape[0], chunk)]).reshape(h, w, 3).cpu().numpy()
        return out

    def readings(self) -> dict:
        return {k: self.frames[k] for k in self.picked()}

    @staticmethod
    def compare(got: dict, ref: dict) -> dict:
        """``colour_gap_p99``: the 99th percentile of the gap of every colour
        value of the frames (``colour_gap``: the widest, which a sample on
        the unit sphere's edge sets in an f32 render too)."""
        diffs = [np.abs(got[k] - colour).ravel() for k, colour in ref.items()]
        d = np.concatenate(diffs).astype(np.float64)
        if np.isnan(d).any():
            return {"colour_gap_p99": math.nan, "colour_gap": math.nan, "worst": {}}
        return {"colour_gap_p99": float(np.quantile(d, 0.99)), "colour_gap": float(d.max()),
                "worst": {"colour_gap_by_frame": {k: float(x.max()) for k, x in zip(ref, diffs)}}}

    def numbers(self) -> dict:
        out = self.compare(self.readings(), self.reference())
        self.detail = out.pop("worst")
        return out
