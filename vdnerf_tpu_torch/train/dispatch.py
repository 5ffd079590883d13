"""Multi-step dispatch: training steps in windows of ``train.steps_per_call``,
each step on the card one CUDA-graph replay of the captured step.

Counterpart of ``make_train_scan_step`` (``vdnerf_tpu/train/step.py``): where
the JAX package compiles K steps into one ``lax.scan`` program, the port
captures the step once as a ``torch.cuda.CUDAGraph`` and replays it K times
per window, so that the host launches one replay a step instead of every
kernel of it. The window's K batches and step inputs go to the card in one
upload, and its metrics come back in one transfer (:meth:`Window.read`).

Programs. A step program is a render core (the faithful one before
``train.resample_from``, the resampled one after it), in the wdepth recipe
whether the distillation term is in the loss, and in the learnable recipes
whether the cameras are refined (``start_refine_pose_iter``): separate
programs rather than the JAX step's multiply by a gate and ``lax.cond``, so
that each program launches what the eager step launches (no depth-head
backward before ``depth_start_iter``) and the camera Adams neither step nor
count before the gate. Each is captured at first use, after its first
:data:`WARMUP_STEPS` steps ran eagerly on a side stream (PyTorch's
whole-network capture recipe; they are the run's own steps and fill the
kernels' cached index tensors, Adam's state and cuBLAS's workspaces, none of
which may be made during a capture). Every later step of the program is a
replay. The graphs share one memory pool: they never run at once, and what
outlives a replay (parameters, Adam's state, the step inputs, the captured
batch) was made outside it. A capture error raises: the card never carries
on eagerly.

What a replay reads is fixed at capture: the parameters (the learned
cameras' among them), their ``.grad`` (made by the captured backward), each
Adam's ``exp_avg``/``exp_avg_sq``/``step``, ``Trainer.inputs`` (the Adams'
learning rates among them), the batch buffers. A replay
copies the step's row of the window into them first. The training generator
is registered with every graph, so each replay draws the next jitter and
stratified numbers, as an eager step would. A dispatch is made per training
run, after a resume has loaded its state; whatever rebinds one of those
tensors needs a new dispatch.

Launch counts: ``build.LAUNCHES`` counts wrapper calls, which a replay does
not make; each program's launches are recorded at its capture and added on
every replay, so that the counts say what ran.

Tracing (``utils/trace.py``): a graph replays what its capture launched, so
each program is captured twice, back to back, in the same pool and with the
same generator registration: a plain graph, and a marked twin whose capture
launched the step's device marks. A step replays the twin while a profiler
records and the plain graph otherwise (one check a step); both record the
same launch counts. Spans: ``dispatch.upload`` (a window's stack and
upload), ``dispatch.eager``, ``dispatch.capture`` (each of the two
captures), ``dispatch.replay`` (a step's inputs and its replay) and
``dispatch.read`` (:meth:`Window.read`); counters per program
(:func:`program_name`): ``dispatch.eager_steps.<program>``,
``dispatch.captures.<program>`` (one a program, its twin in it) and
``dispatch.replays.<program>``.

Data parallelism: for a trainer in a grouped world (``parallel/mesh.py``,
NCCL on the card) the step's collectives (the loss normalisers' sums, the
one gradient all-reduce) are part of ``Trainer.program`` and so of the
captured graph: each replay runs them. The warm-up steps run them first, so
the communicator exists before any capture; the capture is thread-local,
since the process group's watchdog thread queries CUDA events meanwhile.
Every rank captures and replays the same program sequence: the program key
depends only on the step number.

With ``VDNERF_DEBUG_NANS`` (``utils/debug.py``: autograd's anomaly detection
with its NaN check, which a graph cannot run) steps are ``Trainer.step``
calls on the card, launched op by op.

On the CPU (``device="cpu"``, the tests) a window is ``Trainer.step`` once per
step, as the caller asked.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from vdnerf_tpu_torch.ops.kernels import build
from vdnerf_tpu_torch.ops.renderer import NeuSNetworks
from vdnerf_tpu_torch.train.step import Trainer, upload_batch
from vdnerf_tpu_torch.utils import trace
from vdnerf_tpu_torch.utils.debug import nan_debugging_enabled

# eager steps of a program before its capture
WARMUP_STEPS = 3


@dataclasses.dataclass
class Window:
    """K consecutive training steps: ``steps`` (0-based), their batches and
    step inputs on the card (``batch`` [K, ...], ``inputs`` [K, 5]; None on
    the CPU), and ``metrics`` [K, len(names)] as the steps fill it."""

    steps: list[int]
    batch: dict | None
    inputs: torch.Tensor | None
    metrics: torch.Tensor
    names: tuple[str, ...]

    def read(self) -> list[dict[str, float]]:
        """Every step's metrics, in one transfer to the host."""
        with trace.span("dispatch.read"):
            rows = self.metrics.cpu().numpy()
        return [dict(zip(self.names, map(float, row))) for row in rows]


@dataclasses.dataclass
class _Program:
    name: str
    graph: torch.cuda.CUDAGraph
    metrics: torch.Tensor
    marked: torch.cuda.CUDAGraph  # the twin with the step's device marks
    marked_metrics: torch.Tensor
    launches: dict[str, int]


def program_name(nets: NeuSNetworks, distill: bool, refine: bool) -> str:
    """A step program's name in the trace's counters: ``core<samples>``, then
    ``.distill`` and ``.refine`` where they hold."""
    r = nets.renderer
    n = r.n_samples + r.n_importance
    core = r.n_render_samples if 0 < r.n_render_samples < n and r.n_importance > 0 else n
    return f"core{core}" + ".distill" * distill + ".refine" * refine


class StepDispatch:
    """Runs windows of training steps for ``trainer``: graph replays on the
    card, ``Trainer.step`` on the CPU or under ``VDNERF_DEBUG_NANS``."""

    def __init__(self, trainer: Trainer):
        self.trainer = trainer
        self.device = trainer.device
        self.graphed = self.device.type == "cuda" and not nan_debugging_enabled()
        self.programs: dict[tuple, _Program] = {}
        self.eager_steps: collections.Counter = collections.Counter()
        self.pool = None
        self.batch = None  # the captured batch buffers
        self.side = torch.cuda.Stream(self.device) if self.graphed else None

    def run(self, steps, nets: list[NeuSNetworks], batches: list[dict]) -> Window:
        """Steps ``steps`` (0-based), step ``steps[j]`` on core ``nets[j]``
        and host batch ``batches[j]`` -> the window, its metrics in flight."""
        steps = list(steps)
        names = self.trainer.metric_names
        if not self.graphed:
            rows = []
            for s, n, b in zip(steps, nets, batches):
                with trace.span("dispatch.eager", id=s):
                    rows.append(self.trainer.step(n, b, s))
                trace.count("dispatch.eager_steps."
                            + program_name(n, self.trainer.distills(s), self.trainer.refines(s)))
            metrics = torch.stack([torch.stack([m[k] for k in names]) for m in rows])
            return Window(steps, None, None, metrics, names)
        with trace.span("dispatch.upload"):
            stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
            inputs = np.stack([self.trainer.step_inputs(s) for s in steps])
            dev = upload_batch({**stacked, "_inputs": inputs}, self.device)
            window = Window(steps, dev, dev.pop("_inputs"),
                            torch.empty(len(steps), len(names), device=self.device), names)
        for j, (s, n) in enumerate(zip(steps, nets)):
            self.step(window, j, n, self.trainer.distills(s), self.trainer.refines(s))
        return window

    def step(self, window: Window, j: int, nets: NeuSNetworks, distill: bool,
             refine: bool) -> None:
        """Step j of the window: a replay of its program, which is captured
        on first use after WARMUP_STEPS eager steps on a side stream."""
        key = (nets, distill, refine)
        prog = self.programs.get(key)
        if prog is None:
            if self.eager_steps[key] < WARMUP_STEPS:
                self.eager_steps[key] += 1
                self.side.wait_stream(torch.cuda.current_stream(self.device))
                with trace.span("dispatch.eager", id=window.steps[j]), \
                        torch.cuda.stream(self.side):
                    self.eager_step(window, j, nets, distill, refine)
                torch.cuda.current_stream(self.device).wait_stream(self.side)
                trace.count("dispatch.eager_steps." + program_name(*key))
                return
            prog = self.programs[key] = self._capture(window, nets, distill, refine)
        with trace.span("dispatch.replay", id=window.steps[j]):
            self._set_step(window, j)
            if trace.marks_on():
                prog.marked.replay()
                window.metrics[j].copy_(prog.marked_metrics)
            else:
                prog.graph.replay()
                window.metrics[j].copy_(prog.metrics)
        trace.count("dispatch.replays." + prog.name)
        for k, v in prog.launches.items():
            build.LAUNCHES[k] += v

    def eager_step(self, window: Window, j: int, nets: NeuSNetworks, distill: bool,
                   refine: bool) -> None:
        """Step j of the window launched op by op on the card: the program a
        replay runs, on the same inputs (the graph's oracle)."""
        self.trainer.inputs.copy_(window.inputs[j])
        metrics = self.trainer.program(nets, {k: v[j] for k, v in window.batch.items()},
                                       distill, refine, window.steps[j])
        window.metrics[j].copy_(self._stack(metrics))

    def _stack(self, metrics: dict) -> torch.Tensor:
        return torch.stack([metrics[k] for k in self.trainer.metric_names])

    def _set_step(self, window: Window, j: int) -> None:
        """Step j's inputs and batch into the tensors the graphs read."""
        self.trainer.inputs.copy_(window.inputs[j])
        for k, buf in self.batch.items():
            buf.copy_(window.batch[k][j])

    def _capture(self, window: Window, nets: NeuSNetworks, distill: bool,
                 refine: bool) -> _Program:
        if self.batch is None:
            self.batch = {k: torch.empty_like(v[0]) for k, v in window.batch.items()}
        trace.load_marks()  # the marks' kernels loaded before a capture launches one
        # the process group's watchdog thread queries events during a capture
        mode = "thread_local" if self.trainer.world.grouped else "global"
        made = []
        for marked in (False, True):
            graph = torch.cuda.CUDAGraph()
            if self.trainer.generator is not None:
                graph.register_generator_state(self.trainer.generator)
            before = dict(build.LAUNCHES)
            with trace.span("dispatch.capture"), trace.marking(marked), \
                    torch.cuda.graph(graph, pool=self.pool, capture_error_mode=mode):
                metrics = self._stack(self.trainer.program(nets, self.batch, distill, refine))
            # the wrappers counted what the capture recorded; nothing ran
            made.append((graph, metrics, {k: build.LAUNCHES[k] - before[k] for k in before}))
            build.LAUNCHES.update(before)
            self.pool = graph.pool()
        (graph, metrics, launches), (marked_graph, marked_metrics, marked_launches) = made
        if marked_launches != launches:
            raise RuntimeError(f"the marked twin launches {marked_launches}, the plain graph "
                               f"{launches}")
        name = program_name(nets, distill, refine)
        trace.count("dispatch.captures." + name)
        return _Program(name, graph, metrics, marked_graph, marked_metrics, launches)
