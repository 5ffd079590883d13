"""The tracing marks (``vdnerf_tpu_torch/utils/trace.py``,
``ops/kernels/csrc/trace_marks.cu``) on the card.

These tests need an NVIDIA GPU (``cuda`` marker) and skip without one: the
marks are CUDA kernels, and the marked twin a CUDA graph. The file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_trace_cuda.py

- From the same state (parameters, Adam's moments and counts, the
  generator), 10 replays of the plain graph and 10 of the marked twin give
  bit for bit equal metric rows and parameters, the same launch counts and
  the generator at the same offset; the twin's replays put every span's and
  point's mark on the device timeline, the plain graph's none.
- Every ``sdf_fwd_kernel`` of a replayed step and of a served frame lies
  inside ``render.ladder``, and every cuBLAS/CUTLASS product of a served
  frame inside ``render.sdf``, but for the ray grid's rotations in
  ``serve.rays``.
- A served frame under the profiler marks its spans; without a profiler it
  launches no mark.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_cuda import _small_trainer
from vdnerf_tpu_torch.ops.kernels import build
from vdnerf_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _device_events(fn) -> list[tuple[str, float, float]]:
    """fn under the profiler -> its device operations (name, start, end)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(ev.name, ev.time_range.start * 1e-6, ev.time_range.end * 1e-6)
            for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation]


def _marks(events) -> list[tuple[str, str]]:
    return [m for m in (trace.parse_mark(n) for n, _, _ in sorted(events, key=lambda e: e[1]))
            if m is not None]


def _within(events, kernel: str) -> set:
    """The spans or pieces that hold the device time of ``kernel``'s launches."""
    return set(trace.by_span([e for e in events if trace.parse_mark(e[0]) is not None
                              or kernel in e[0]]))


def _state(trainer):
    """Copies of everything a replay reads and writes that outlives it."""
    opt = trainer.optimizer
    return ([p.detach().clone() for p in trainer.params],
            [{k: v.clone() for k, v in opt.state[p].items()} for p in trainer.params],
            trainer.generator.get_state())


def _restore(trainer, state):
    params, moments, gen = state
    with torch.no_grad():
        for p, q, m in zip(trainer.params, params, moments):
            p.copy_(q)
            for k, v in m.items():
                trainer.optimizer.state[p][k].copy_(v)
    trainer.generator.set_state(gen)


def test_marked_twin_replays_the_plain_graph_bit_for_bit(card):
    from vdnerf_tpu_torch.train.dispatch import StepDispatch

    trainer, _, resampled, batches = _small_trainer(card)
    dispatch = StepDispatch(trainer)
    dispatch.run(range(6, 10), [resampled] * 4, batches[:4]).read()  # warm-up, capture, replay
    assert len(dispatch.programs) == 1
    state = _state(trainer)
    got = {}
    for marked in (False, True):
        _restore(trainer, state)
        build.reset_launches()
        rows = []
        with trace.marking(marked):
            for w in range(2):
                steps = range(10 + 5 * w, 15 + 5 * w)
                rows += dispatch.run(steps, [resampled] * 5,
                                     [batches[s % 12] for s in steps]).read()
        torch.cuda.synchronize()
        got[marked] = (rows, [p.detach().clone() for p in trainer.params],
                       dict(build.LAUNCHES), trainer.generator.get_offset())
    (rows0, params0, launches0, offset0), (rows1, params1, launches1, offset1) = \
        got[False], got[True]
    assert rows0 == rows1
    assert all(torch.equal(p, q) for p, q in zip(params0, params1))
    assert launches0 == launches1 and offset0 == offset1

    _restore(trainer, state)
    with trace.marking(False):
        plain = _device_events(lambda: dispatch.run(range(10, 12), [resampled] * 2,
                                                    batches[:2]).read())
    assert not _marks(plain)
    marked = _device_events(lambda: dispatch.run(range(12, 14), [resampled] * 2,
                                                 batches[:2]).read())
    names = _marks(marked)
    assert {n for k, n in names if k == "begin"} >= {
        "dispatch.upload", "dispatch.replay", "dispatch.read", "step", "render.rays",
        "render.ladder", "render.nerf", "render.sdf", "render.depth_head",
        "render.colour_head", "render.composite", "step.loss", "step.backward", "step.adam"}
    assert [n for k, n in names if k == "at"] == ["bwd.colour_head", "bwd.depth_head",
                                                  "bwd.sdf", "bwd.nerf"] * 2
    assert _within(marked, "sdf_fwd_kernel") == {"render.ladder"}


def test_served_frame_marks_only_under_the_profiler(card, monkeypatch):
    from vdnerf_tpu_torch.train.validate import ImageRenderer

    trainer, _, resampled, _ = _small_trainer(card)
    renderer = ImageRenderer(resampled, trainer.tcfg, 48, 64, chunk=1024)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -3.0
    intrin_inv = np.linalg.inv(np.array([[50.0, 0, 32, 0], [0, 50, 24, 0], [0, 0, 1, 0],
                                         [0, 0, 0, 1]], np.float32))

    def frame():
        return renderer.render_image(trainer.model, pose, intrin_inv, 1, 60)

    frame()  # kernels built and loaded
    trace.reset()
    events = _device_events(frame)
    names = _marks(events)
    assert {n for k, n in names if k == "begin"} >= {
        "serve.frame", "serve.rays", "serve.chunk", "serve.outputs", "serve.to_host",
        "render.ladder", "render.sdf", "render.colour_head", "render.composite"}
    assert trace.counts()["serve.chunks"] == 3 and trace.counts()["serve.host_syncs"] == 15
    assert _within(events, "sdf_fwd_kernel") == {"render.ladder"}
    products = [e for e in events
                if any(s in e[0].lower() for s in ("gemm", "xmma", "kernel2", "cutlass"))]
    assert products
    # the SDF block's, and the ray grid's 3 x 3 rotations (einsum)
    where = trace.by_span([e for e in events if trace.parse_mark(e[0]) is not None] + products)
    assert "render.sdf" in where and set(where) <= {"render.sdf", "serve.rays"}

    # no profiler: no mark is made
    made = []
    monkeypatch.setattr(trace, "_mark", lambda *a: made.append(a))
    frame()
    torch.cuda.synchronize()
    assert not made
