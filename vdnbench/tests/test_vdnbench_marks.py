"""The program's device marks read into layers and named idle time
(``vdnbench/marks.py``), on synthetic event lists: the partition of the busy
time into layers and backward pieces, nesting, the idle stretches named by
the span open at the mark before them, the readers' None where a trace has
no marks or the program no registry, and the host readers' arithmetic."""

from __future__ import annotations

import types

import pytest

from vdnbench import harness, marks, trace
from vdnbench.tests.small import REPO


def mk(kind, name):
    return f"vdn_mark_{kind}_{name.replace('.', '__')}"


def mark(kind, name, t):
    return (mk(kind, name), t, t + 0.01)


def record(events, units=1, window=(0.0, 20.0)):
    spans = [("runner.sample", window[0], window[0] + 0.5), ("window.read", window[1] - 0.5,
                                                              window[1])]
    return trace.Record(units, events, spans, 10, 1.0, {}, {})


# one replayed step: data, the dispatch's replay, the graph's marks
STEP = [
    mark("begin", "data.sample", 0.0), mark("begin", "data.gather_feats", 0.1),
    mark("end", "data.gather_feats", 1.0), mark("end", "data.sample", 1.1),
    mark("begin", "dispatch.replay", 2.0),
    ("void at::native::copy_kernel(x)", 2.1, 2.2),
    mark("begin", "step", 2.3),
    mark("begin", "render.rays", 2.4), ("void at::native::elementwise_kernel<x>(y)", 2.5, 2.6),
    mark("end", "render.rays", 2.6),
    mark("begin", "render.ladder", 2.7), ("void sdf_fwd_kernel<64>(float const*)", 2.8, 3.8),
    mark("end", "render.ladder", 3.8),
    mark("begin", "render.nerf", 3.9), ("nerf_fwd_kernel", 4.0, 4.5),
    mark("end", "render.nerf", 4.5),
    mark("begin", "render.sdf", 4.6), ("void cutlass::Kernel2<x>(y)", 4.7, 6.7),
    mark("end", "render.sdf", 6.7),
    mark("begin", "render.colour_head", 6.8), ("render_fwd_kernel", 6.9, 7.4),
    mark("end", "render.colour_head", 7.4),
    mark("begin", "render.composite", 7.5), ("reduce_kernel", 7.6, 7.8),
    mark("end", "render.composite", 7.8),
    mark("begin", "step.loss", 7.9), ("reduce_kernel", 8.0, 8.1), mark("end", "step.loss", 8.1),
    mark("begin", "step.backward", 8.2), ("elementwise_kernel", 8.3, 8.6),
    mark("at", "bwd.colour_head", 8.6), ("render_bwd_kernel", 8.7, 9.5),
    mark("at", "bwd.sdf", 9.5), ("sm90_xmma_gemm_f32f32", 9.6, 12.6),
    # a copy that overlaps the product: counted once
    ("Memcpy DtoD (Device -> Device)", 12.0, 12.9),
    mark("at", "bwd.nerf", 12.9), ("nerf_bwd_kernel", 13.0, 13.6),
    mark("end", "step.backward", 13.6),
    mark("begin", "step.adam", 13.7), ("multi_tensor_apply_kernel", 13.8, 14.0),
    mark("end", "step.adam", 14.0),
    mark("end", "step", 14.1),
    ("void at::native::copy_kernel(x)", 14.2, 14.3),
    mark("end", "dispatch.replay", 14.3),
    mark("begin", "dispatch.read", 15.0), ("Memcpy DtoH (Device -> Pageable)", 15.1, 15.2),
    mark("end", "dispatch.read", 16.0),
]


def test_layers_partition_the_busy_time():
    m = marks.of(record(STEP))
    assert m.layer_s("ladder") == pytest.approx(0.1 + 1.0)
    assert m.layer_s("nerf") == pytest.approx(0.5 + 0.6)
    assert m.layer_s("sdf") == pytest.approx(2.0 + 3.3)  # the copy after the product: 0.3
    assert m.layer_s("heads") == pytest.approx(0.5 + 0.8)
    assert m.layer_s("composite") == pytest.approx(0.2 + 0.1 + 0.3)
    assert m.layer_s("adam") == pytest.approx(0.2)
    assert m.unmarked_s() == pytest.approx(0.1 + 0.1 + 0.1)  # the dispatch's copies
    rec = record(STEP)
    work = [(s, e) for n, s, e in STEP if marks.parse_mark(n) is None]
    total = sum(m.layer_s(k) for k in marks.LAYERS) + m.unmarked_s()
    assert total == pytest.approx(trace.covered(work))
    assert total < rec.busy_s()  # the marks' own time is left out of the layers


def test_each_kernel_lies_in_its_layer():
    placed = dict((k, label) for k, label in marks.of(record(STEP)).placed)
    assert placed["sdf_fwd_kernel"] == "render.ladder"
    assert placed["Kernel2"] == "render.sdf"
    assert placed["sm90_xmma_gemm_f32f32"] == "bwd.sdf"
    assert placed["render_bwd_kernel"] == "bwd.colour_head"
    assert placed["multi_tensor_apply_kernel"] == "step.adam"


def test_idle_named_by_the_span_open_at_the_mark_before_it():
    rec = record(STEP)
    m = marks.of(rec)
    kinds = {k: m.idle_s(k) for k in ("data", "dispatch", "layers", "to_host", "outside")}
    # gaps: 0.01-0.1, 0.11-1.0 in data.gather_feats / data.sample, 1.11-2.0 outside ...
    assert kinds["data"] == pytest.approx(0.09 + 0.89 + 0.09)
    assert kinds["outside"] == pytest.approx(0.89 + 0.69 + 4.0 - 0.01 + 0.0)
    assert kinds["to_host"] == 0.0
    assert sum(kinds.values()) == pytest.approx(rec.window_s - rec.busy_s())
    # the gap after the point's mark is the piece's; the product and the copy leave none
    assert m.idle["bwd.sdf"] == pytest.approx(0.09)


def test_nested_spans_and_an_unclosed_one():
    events = [mark("begin", "serve.frame", 0.0), mark("begin", "serve.chunk", 1.0),
              mark("begin", "serve.to_host", 2.0), ("Memcpy DtoH", 2.5, 3.0),
              # serve.frame's end closes the chunk and the copy left open
              mark("end", "serve.frame", 5.0), mark("begin", "serve.rays", 6.0),
              ("k", 6.5, 7.0)]
    m = marks.of(record(events, window=(0.0, 8.0)))
    assert m.busy == pytest.approx({"serve.to_host": 0.5, "serve.rays": 0.5})
    assert m.idle_s("to_host") == pytest.approx(0.49 + 2.0)
    # an end without its begin (opened before the profiler started) is ignored
    m = marks.of(record([mark("end", "step", 0.0), ("k", 1.0, 2.0)], window=(0.0, 3.0)))
    assert m.busy == {None: 1.0}


def test_no_marks_no_numbers():
    rec = record([("sdf_fwd_kernel", 1.0, 2.0), ("reduce_kernel", 3.0, 4.0)])
    assert marks.of(rec) is None
    for name in ("layer.sdf_ms.train", "layer.unmarked_ms.render", "idle.data_ms.train",
                 "idle.to_host_ms.render", "layer.adam_ms.train"):
        assert harness.reader(REPO, name)(rec) is None


def test_readers_per_unit():
    rec = record(STEP, units=2)
    assert harness.reader(REPO, "layer.sdf_ms.train")(rec) == pytest.approx(5.3 / 2 * 1e3)
    assert harness.reader(REPO, "layer.heads_ms.render")(rec) == pytest.approx(1.3 / 2 * 1e3)
    assert harness.reader(REPO, "idle.dispatch_ms.train")(rec) == pytest.approx(
        marks.of(rec).idle_s("dispatch") / 2 * 1e3)


def test_marks_inside_the_window_only():
    rec = record(STEP, window=(2.0, 14.3))
    m = marks.of(rec)
    assert "data.sample" not in m.idle and m.layer_s("adam") == pytest.approx(0.2)


def test_host_readers(monkeypatch):
    rec = record(STEP)
    monkeypatch.setattr(marks, "program_trace", lambda: None)
    for name in ("data.feats_ms_per_step.train", "serve.syncs_per_frame.render",
                 "setup.optimizer_s"):
        assert harness.reader(REPO, name)(rec) is None
    program = types.SimpleNamespace(
        host=lambda: {"data.sample": (40, 0.2), "data.gather_feats": (40, 0.08),
                      "setup.optimizer": (1, 9.5)},
        counts=lambda: {"serve.frames": 4, "serve.host_syncs": 40})
    monkeypatch.setattr(marks, "program_trace", lambda: program)
    assert harness.reader(REPO, "data.feats_ms_per_step.train")(rec) == pytest.approx(2.0)
    assert harness.reader(REPO, "serve.syncs_per_frame.render")(rec) == 10
    assert harness.reader(REPO, "setup.optimizer_s")(rec) == 9.5
