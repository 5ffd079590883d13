"""The traced run's record and the arithmetic the per-layer metrics share:
device intervals from the profiler, their union, the kernels grouped by
exact name, and the device's idle gaps named by the host span around them.
"""

from __future__ import annotations

import dataclasses
import re

# the port's kernels, by their exact __global__ names (ops/kernels/csrc)
K1_KERNELS = frozenset({"sdf_fwd_kernel"})
MLP_KERNELS = frozenset({
    "render_fwd_kernel", "render_bwd_kernel", "nerf_fwd_kernel", "nerf_bwd_kernel",
    "dw_kernel", "reduce_dw_kernel", "reduce_db_kernel",
    "split_gemm_kernel", "split_embed_kernel", "split_embed_vjp_kernel",
})
# cuBLAS's and CUTLASS's products, matched only after the exact names
_LIBRARY = ("gemm", "gemv", "cutlass", "xmma", "cublas", "splitkreduce")


def kernel_name(name: str) -> str:
    """The function name of a device event's (demangled) name: no return
    type, namespace, template arguments or parameters."""
    s = name.replace("(anonymous namespace)::", "")
    s = re.sub(r"^void\s+", "", s.strip())
    m = re.match(r"[\w:]+", s)
    return m.group(0).split("::")[-1] if m else s


def group(name: str) -> str:
    """"K1", "mlp", "cublas" or "other" for a kernel's name."""
    base = kernel_name(name)
    if base in K1_KERNELS:
        return "K1"
    if base in MLP_KERNELS:
        return "mlp"
    low = name.lower()
    if any(s in low for s in _LIBRARY):
        return "cublas"
    return "other"


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def union(intervals) -> list[tuple[float, float]]:
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def covered(intervals) -> float:
    return sum(e - s for s, e in union(intervals))


@dataclasses.dataclass
class Record:
    """What a traced run hands the metric readers. Times in seconds.

    ``events``: every device operation of the traced sub-window (name,
    start, end); ``spans``: the harness's host spans there (name, start,
    end), on the same clock; ``units``: steps or frames in it. ``timed_*``:
    the untraced window before it (its units, its seconds, and the host's
    seconds in each span). ``work``: :func:`vdnbench.work.counts` of one
    unit."""

    units: int
    events: list[tuple[str, float, float]]
    spans: list[tuple[str, float, float]]
    timed_units: int
    timed_s: float
    host_s: dict[str, float]
    work: dict

    @property
    def window(self) -> tuple[float, float]:
        return min(s for _, s, _ in self.spans), max(e for _, _, e in self.spans)

    @property
    def window_s(self) -> float:
        lo, hi = self.window
        return hi - lo

    def busy_s(self) -> float:
        """Seconds in which some device operation ran, inside the window."""
        return covered(clip([(s, e) for _, s, e in self.events], *self.window))

    def group_s(self, name: str) -> float:
        """Device seconds of the kernels of one :func:`group` (their union),
        inside the window."""
        return covered(clip([(s, e) for n, s, e in self.events
                             if is_kernel(n) and group(n) == name], *self.window))

    def idle_gaps(self) -> list[tuple[str, float, float]]:
        """The window's stretches with no device operation, each named by
        the innermost harness span the host was in at its middle."""
        lo, hi = self.window
        busy = union(clip([(s, e) for _, s, e in self.events], lo, hi))
        gaps, t = [], lo
        for s, e in busy + [(hi, hi)]:
            if s > t:
                mid = 0.5 * (s + t)
                inside = [sp for sp in self.spans if sp[1] <= mid < sp[2]]
                name = min(inside, key=lambda sp: sp[2] - sp[1])[0] if inside else "(no span)"
                gaps.append((name, t, s))
            t = max(t, e)
        return gaps

    def breakdown(self, top: int = 10) -> dict:
        ops: dict[str, float] = {}
        for n, s, e in self.events:
            key = kernel_name(n) if is_kernel(n) else n
            ops[key] = ops.get(key, 0.0) + (e - s)
        gaps: dict[str, float] = {}
        for n, s, e in self.idle_gaps():
            gaps[n] = gaps.get(n, 0.0) + (e - s)

        def rank(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}


def from_profiler(prof, span_names) -> tuple[list, list]:
    """(device events, harness spans) of a ``torch.profiler.profile``, in
    seconds on the profiler's clock."""
    import torch

    events, spans = [], []
    for ev in prof.events():
        start, end = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if not ev.is_user_annotation:
                events.append((ev.name, start, end))
        elif ev.name in span_names:
            spans.append((ev.name, start, end))
    return events, spans
