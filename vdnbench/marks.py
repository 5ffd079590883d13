"""The program's device marks in a traced run: its layers' device time, and
the device's idle time named by the program's innermost open span.

The program (``vdnerf_tpu_torch/utils/trace.py``) launches an empty
one-thread kernel at each edge of its spans, ``vdn_mark_begin_<span>`` and
``vdn_mark_end_<span>``, and one at each backward point,
``vdn_mark_at_<point>``, each ``.`` of a name written as ``__``; in a CUDA
graph's replay the marks are the graph's own nodes. The names alone say what
a mark is, so this file reads them without importing the program.

Walking a traced run's device operations (``rec.events`` inside
``rec.window``) in the order they started:

- a begin mark opens its span, an end mark closes it (and any span opened
  inside it and not closed), a point renames the innermost open span's
  rest: ``step.backward``'s piece before the first point is the loss's and
  the composite's backward, the piece after ``bwd.sdf`` the SDF block's;
- every other operation belongs to the innermost open span or piece (its
  label; None outside every span), and each part of the busy time (the union
  of the operations' intervals, the marks' own time left out) to the
  operation that first covered it;
- each idle stretch (no operation at all, marks included, as
  ``device.idle_share`` counts it) belongs to the label open at its start:
  in eager code a mark launched during a host wait runs at once and splits
  the stretch, so the label is the host's span to within one launch; inside
  a graph's replay it names the graph's own bubbles.

Host readers read the program's registry of span seconds and counters in
the benchmark's own process (:func:`program_trace`): None where the program
has none.
"""

from __future__ import annotations

import dataclasses
import sys

from vdnbench.trace import kernel_name

PREFIX = "vdn_mark_"
KINDS = ("begin", "end", "at")

# the layers of the per-layer metrics, by the spans and backward pieces
# that make them up
LAYERS = {
    "ladder": ("render.rays", "serve.rays", "render.ladder"),
    "nerf": ("render.nerf", "bwd.nerf"),
    "sdf": ("render.sdf", "bwd.sdf"),
    "heads": ("render.depth_head", "render.colour_head", "bwd.colour_head", "bwd.depth_head"),
    "composite": ("render.composite", "step.loss", "serve.outputs", "step.backward"),
    "adam": ("step.adam",),
}
LAYER_OF = {label: layer for layer, labels in LAYERS.items() for label in labels}


def parse_mark(name: str) -> tuple[str, str] | None:
    """A device operation's name -> (kind, span or point) for a mark, else
    None."""
    base = kernel_name(name)
    if not base.startswith(PREFIX):
        return None
    kind, _, rest = base[len(PREFIX):].partition("_")
    return (kind, rest.replace("__", ".")) if kind in KINDS and rest else None


def idle_kind(label: str | None) -> str:
    """"data", "dispatch", "to_host", "outside" (no span) or "layers" (any
    other span or piece) for the label open during an idle stretch."""
    if label is None:
        return "outside"
    if label == "serve.to_host":
        return "to_host"
    top = label.split(".")[0]
    return top if top in ("data", "dispatch") else "layers"


@dataclasses.dataclass
class Marks:
    """Seconds of a traced window by label: ``busy`` (the marks' own time
    left out), ``idle``; ``placed``: each operation's (kernel name, label)."""

    busy: dict
    idle: dict
    placed: list

    def layer_s(self, layer: str) -> float:
        return sum(v for k, v in self.busy.items() if LAYER_OF.get(k) == layer)

    def unmarked_s(self) -> float:
        return sum(v for k, v in self.busy.items() if k not in LAYER_OF)

    def idle_s(self, kind: str) -> float:
        return sum(v for k, v in self.idle.items() if idle_kind(k) == kind)


def walk(events, lo: float, hi: float) -> Marks | None:
    """:class:`Marks` of the device operations ``events`` (name, start, end)
    inside [lo, hi); None where none of them is a mark."""
    inside = sorted(((n, max(s, lo), min(e, hi)) for n, s, e in events if e > lo and s < hi),
                    key=lambda ev: (ev[1], ev[2]))
    marks = [parse_mark(n) for n, _, _ in inside]
    if not any(marks):
        return None
    stack: list[list[str]] = []  # [span, label] of each open span
    busy: dict = {}
    idle: dict = {}
    placed = []
    reach = lo  # the end of every operation so far, marks included
    work_reach = lo  # ... marks left out

    def add(d, key, v):
        d[key] = d.get(key, 0.0) + v

    for (name, start, end), mark in zip(inside, marks):
        label = stack[-1][1] if stack else None
        if start > reach:
            add(idle, label, start - reach)
        reach = max(reach, end)
        if mark is None:
            placed.append((kernel_name(name), label))
            if end > work_reach:
                add(busy, label, end - max(start, work_reach))
                work_reach = end
            continue
        kind, what = mark
        if kind == "begin":
            stack.append([what, what])
        elif kind == "at":
            if stack:
                stack[-1][1] = what
        elif any(s[0] == what for s in stack):
            while stack.pop()[0] != what:
                pass
    if hi > reach:
        add(idle, stack[-1][1] if stack else None, hi - reach)
    return Marks(busy, idle, placed)


def of(rec) -> Marks | None:
    """:func:`walk` of a traced record, once a record."""
    if not hasattr(rec, "_marks"):
        rec._marks = walk(rec.events, *rec.window)
    return rec._marks


def per_unit_ms(seconds: float, rec) -> float:
    return seconds / rec.units * 1e3


def program_trace():
    """The program's tracing module where the program loaded it in this
    process, else None (a program without one)."""
    return sys.modules.get("vdnerf_tpu_torch.utils.trace")
