"""In-program tracing: spans, backward points, host counters, device marks.

One call, ``with span(name):``, does three things:

- **Host counters, always on.** The span adds its host seconds
  (``time.perf_counter``) and one to its count in the process's registry
  (:func:`host`); :func:`count` adds to a plain counter of the same registry
  (:func:`counts`). :func:`reset` empties both.
- **Host ranges while a profiler records**: a
  ``torch.profiler.record_function(name)`` range, whose args carry the
  span's ``id`` where it has one (the step of ``step``, the frame of
  ``serve.frame``).
- **Device marks while tracing is on**: with CUDA in use, an empty
  one-thread kernel on the current stream at entry (``vdn_mark_begin_<name>``)
  and at exit (``vdn_mark_end_<name>``), each ``.`` of the name written as
  ``__`` (``ops/kernels/csrc/trace_marks.cu``). A device trace then holds
  every span's edges on the device's own clock: a layer's device time is the
  busy time between its marks, and an idle gap belongs to the innermost span
  open at the mark before it (:func:`by_span`). Marks count in no
  ``build.LAUNCHES``.

:func:`point` partitions a backward the same way: an identity on the
tensors it is given whose backward launches ``vdn_mark_at_<name>``, so that
a backward's kernels from one point to the next are that layer's piece.

Tracing is on while a ``torch.profiler`` records (the benchmark's traced
sub-window, ``utils/debug.py``'s ``profile_trace``), or where
:func:`marking` says. A CUDA graph keeps what its capture launched, so
``train/dispatch.py`` captures every step program twice, plain and with its
marks, and replays the marked twin only while a profiler records. On the
CPU marks go to the list of a :func:`recording` block (the tests), and
without one nowhere. With tracing off :func:`point` returns its inputs
untouched and adds no autograd node.
"""

from __future__ import annotations

import contextlib
import time

import torch

# every span the program opens, and every backward point: the lists of
# csrc/trace_marks.cu, in its order
SPANS = (
    "step", "step.loss", "step.backward", "step.allreduce", "step.adam",
    "render.rays", "render.ladder", "render.nerf", "render.sdf", "render.depth_head",
    "render.colour_head", "render.composite",
    "serve.frame", "serve.rays", "serve.chunk", "serve.outputs", "serve.to_host",
    "data.sample", "data.gather_feats",
    "dispatch.upload", "dispatch.replay", "dispatch.eager", "dispatch.capture", "dispatch.read",
    "setup.scene", "setup.features", "setup.model", "setup.optimizer", "build.nvcc", "build.load",
    "mesh.grid", "mesh.to_host", "mesh.marching", "mesh.ply",
)
POINTS = ("bwd.colour_head", "bwd.depth_head", "bwd.sdf", "bwd.nerf")
KINDS = ("begin", "end", "at")
MARK_PREFIX = "vdn_mark_"

_SPAN_ID = {name: i for i, name in enumerate(SPANS)}
_POINT_ID = {name: i for i, name in enumerate(POINTS)}

# the registry: span -> [count, host seconds]; counter -> count
_HOST: dict[str, list] = {}
_COUNTS: dict[str, int] = {}


class _State:
    forced: bool | None = None  # marking()'s choice, over the profiler's
    record: list | None = None  # recording()'s list
    lib = None  # the marks' library, once loaded
    loading = False


def reset() -> None:
    """Empty the registry."""
    _HOST.clear()
    _COUNTS.clear()


def count(name: str, n: int = 1) -> None:
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def host() -> dict[str, tuple[int, float]]:
    """Each span's (count, host seconds) so far."""
    return {name: (int(c), s) for name, (c, s) in _HOST.items()}


def counts() -> dict[str, int]:
    return dict(_COUNTS)


def seconds(prefix: str, since: dict | None = None) -> dict[str, float]:
    """Host seconds of the spans named ``<prefix><part>``, by part, less
    what :func:`host` gave in ``since``."""
    since = since or {}
    return {name[len(prefix):]: s - since.get(name, (0, 0.0))[1]
            for name, (_, s) in host().items() if name.startswith(prefix)}


def profiling() -> bool:
    """A ``torch.profiler`` records."""
    return torch._C._autograd._profiler_enabled()


def marks_on() -> bool:
    """Spans and points mark now: as :func:`marking` says, else inside a
    :func:`recording` block or while a profiler records."""
    if _State.forced is not None:
        return _State.forced
    return _State.record is not None or profiling()


@contextlib.contextmanager
def marking(on: bool):
    """Marks on or off for the block, whatever the profiler does (a graph's
    capture)."""
    prev, _State.forced = _State.forced, on
    try:
        yield
    finally:
        _State.forced = prev


@contextlib.contextmanager
def recording():
    """Marks on for the block; yields the list of every mark made in it,
    ``(kind, name)`` in order, kind one of :data:`KINDS`."""
    prev, _State.record = _State.record, []
    try:
        yield _State.record
    finally:
        _State.record = prev


def mark_name(kind: str, name: str) -> str:
    """The kernel of a mark: ``vdn_mark_<kind>_<name>``, ``.`` as ``__``."""
    return f"{MARK_PREFIX}{kind}_{name.replace('.', '__')}"


def load_marks():
    """The marks' library, loaded and its kernels' modules with it (so that
    a capture never loads one) -> the library; None while it is loading
    (the build's own spans mark nothing)."""
    if _State.lib is None and not _State.loading:
        from vdnerf_tpu_torch.ops.kernels import build

        _State.loading = True
        try:
            lib = build.library("trace_marks")
            build.check(lib.vdn_mark_prepare(), "trace mark module")
            _State.lib = lib
        finally:
            _State.loading = False
    return _State.lib


def _mark(kind: int, name: str, cuda: bool) -> bool:
    """Record the mark, and with ``cuda`` launch it -> launched."""
    if _State.record is not None:
        _State.record.append((KINDS[kind], name))
    lib = load_marks() if cuda else None
    if lib is None:
        return False
    idx = _POINT_ID[name] if kind == 2 else _SPAN_ID[name]
    err = lib.vdn_mark_launch(kind, idx, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{mark_name(KINDS[kind], name)} launch failed: cudaError_t {err}")
    return True


class span:
    """``with span(name[, id]) as s:`` -> ``s.seconds`` after the block; see
    the module's docstring."""

    __slots__ = ("name", "id", "seconds", "_t0", "_range", "_marks", "_device")

    def __init__(self, name: str, id: int | None = None):
        self.name = name
        self.id = id
        self.seconds = 0.0

    def __enter__(self):
        self._marks = marks_on()
        self._range = None
        if self._marks:
            if profiling():
                self._range = torch.profiler.record_function(
                    self.name, None if self.id is None else str(self.id))
                self._range.__enter__()
            # the end goes where the begin went
            self._device = _mark(0, self.name, torch.cuda.is_initialized())
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if self._marks:
            _mark(1, self.name, self._device)
            if self._range is not None:
                self._range.__exit__(*exc)
        entry = _HOST.get(self.name)
        if entry is None:
            entry = _HOST[self.name] = [0, 0.0]
        entry[0] += 1
        entry[1] += self.seconds
        return False


class _Point(torch.autograd.Function):
    @staticmethod
    def forward(ctx, name, *tensors):
        ctx.name = name
        ctx.set_materialize_grads(False)
        return tensors

    @staticmethod
    def backward(ctx, *grads):
        _mark(2, ctx.name, any(g is not None and g.is_cuda for g in grads))
        return (None, *grads)


def point(name: str, *tensors: torch.Tensor):
    """``tensors`` (one tensor for one), through an identity whose backward
    marks ``name`` while tracing is on and a gradient flows; else the
    tensors themselves."""
    if marks_on() and torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        out = _Point.apply(name, *tensors)
    else:
        out = tensors
    return out[0] if len(tensors) == 1 else out


def parse_mark(kernel: str) -> tuple[str, str] | None:
    """A kernel's name -> (kind, span or point name) for a mark, else None."""
    if not kernel.startswith(MARK_PREFIX):
        return None
    kind, _, rest = kernel[len(MARK_PREFIX):].partition("_")
    return (kind, rest.replace("__", ".")) if kind in KINDS else None


def by_span(events) -> dict[str | None, float]:
    """Device seconds by the innermost span or backward piece open on the
    device when each part of the busy time ran. ``events``: a profiler's
    device operations (kernel name, start, end) of one stream of work, in
    seconds. The marks order the device's timeline: each operation belongs
    to the innermost span whose begin mark ran before it and whose end mark
    had not yet run, or, inside a span that points split, to the last
    point's piece; the busy time is their union, each part of it given to
    the operation that first covered it. Marks' own time is left out; None
    holds what no span covers."""
    stack: list[list[str]] = []
    out: dict[str | None, float] = {}
    reach = float("-inf")
    for name, start, end in sorted(events, key=lambda e: (e[1], e[2])):
        mark = parse_mark(name)
        if mark is not None:
            kind, what = mark
            if kind == "begin":
                stack.append([what, what])
            elif kind == "at":
                if stack:
                    stack[-1][1] = what
            elif any(s[0] == what for s in stack):
                while stack.pop()[0] != what:
                    pass
            continue
        label = stack[-1][1] if stack else None
        part = end - max(start, reach)
        if part > 0:
            out[label] = out.get(label, 0.0) + part
        reach = max(reach, end)
    return out
