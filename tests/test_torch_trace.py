"""The port's in-program tracing (``vdnerf_tpu_torch/utils/trace.py``) on the
CPU, where marks go to the list of a ``trace.recording()`` block.

- A womsk-like training step (the resampled core, ``skip_bg_inside``) and a
  wdepth-like one (its depth head and the NeRF's dpt head), each a window of
  ``StepDispatch``, give balanced begin and end marks for every span of the
  step, the data and the dispatch, properly nested.
- The backward points come in the order ``bwd.colour_head``
  (``bwd.depth_head``) ``bwd.sdf`` ``bwd.nerf``, all inside
  ``step.backward``.
- With tracing off there are no marks and no extra autograd nodes, and the
  step's loss, metrics and gradients equal the traced step's bit for bit.
- The host counters count what ran: ``data.sample`` once a step, the
  dispatch's eager steps per program, two chunks and ten host syncs for a
  two-chunk frame; ``trace.seconds`` gives a part's host seconds.
- ``metrics.jsonl``'s ``rays_per_sec`` is the window's rate: its rays over
  the host time since the window before it ended (a stand-in clock).
- The marks' kernel source lists the spans and points of ``trace.py`` in its
  order, and no span has the name of one of the benchmark harness's own.
- ``trace.by_span`` files device time under the innermost span or backward
  piece on synthetic events, leaves out the marks and counts overlap once.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch

from vdnerf_tpu_torch.data.synthetic import make_synthetic_scene, write_synthetic_conf
from vdnerf_tpu_torch.train.dispatch import StepDispatch
from vdnerf_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_IMAGES, H, W, BATCH, D_FEAT = 3, 24, 32, 32, 6
# the spans of every training step, and of the wdepth one besides
STEP_SPANS = {"step", "render.rays", "render.ladder", "render.nerf", "render.sdf",
              "render.colour_head", "render.composite", "step.loss", "step.backward",
              "step.adam"}
HARNESS_SPANS = {"runner.sample", "dispatch.run", "window.read", "render.frame"}

RESAMPLED = """    perturb = 1.0
        skip_bg_inside = True
        n_render_samples = 32
        resample_uniform_frac = 1.0
"""
DEPTH_HEAD = """    depth_extract_network {
        d_feature = 64
        mode = idr
        d_in = 9
        d_out = %d
        d_hidden = 64
        n_layers = 2
        weight_norm = True
        multires_view = 4
        squeeze_out = True
    }

    neus_renderer {""" % D_FEAT


def write_conf(d: str, wdepth: bool, **kw) -> str:
    """The synthetic conf with the resampled core; ``wdepth``: with the depth
    head, the NeRF's dpt head and seeded half-resolution features."""
    conf = os.path.join(d, "wdepth.conf" if wdepth else "womsk.conf")
    write_synthetic_conf(conf, data_dir=d, exp_dir=os.path.join(d, "exp_" + str(wdepth)),
                         batch_size=BATCH, **kw)
    text = open(conf).read().replace("    perturb = 1.0\n", RESAMPLED)
    if wdepth:
        text = text.replace("extract_depth = False", "extract_depth = True\n"
                            "    depth_start_iter = 2\n    depth_loss_scale = 10.0")
        text = text.replace("use_viewdirs = True,", "use_viewdirs = True,\n"
                            f"        gen_depth_feats = True,\n        dpt_dim = {D_FEAT},")
        text = text.replace("    neus_renderer {", DEPTH_HEAD)
        rng = np.random.default_rng(0)
        out = os.path.join(d, "image", "00")
        os.makedirs(out, exist_ok=True)
        for i in range(N_IMAGES):
            feats = rng.normal(size=(D_FEAT, H // 2, W // 2)).astype(np.float32)
            np.save(os.path.join(out, f"{i:03d}.npy"), feats)
    with open(conf, "w") as f:
        f.write(text)
    return conf


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_trace"))
    make_synthetic_scene(d, n_images=N_IMAGES, H=H, W=W)
    return d


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_runner(scene_dir: str, wdepth: bool, **kw):
    from vdnerf_tpu_torch.runner import Runner

    return Runner(write_conf(scene_dir, wdepth, **kw), device="cpu", mode="train")


def window(runner, steps, rng):
    """Sample a batch a step and run the steps as one window -> metric rows."""
    batches = [runner.store.sample_pixels(s % N_IMAGES, BATCH, rng) for s in steps]
    return StepDispatch(runner.trainer).run(steps, [runner.nets] * len(steps), batches).read()


def nesting(marks) -> list[tuple[str, tuple[str, ...]]]:
    """Each mark's (name, the spans open around it); asserts that begins and
    ends balance."""
    stack, out = [], []
    for kind, name in marks:
        if kind == "end":
            assert stack and stack[-1] == name, (name, stack)
            stack.pop()
        out.append((name, tuple(stack)))
        if kind == "begin":
            stack.append(name)
    assert not stack, stack
    return out


@pytest.mark.parametrize("wdepth", [False, True], ids=["womsk", "wdepth"])
def test_training_step_marks_balanced_and_ordered(scene_dir, wdepth):
    runner = make_runner(scene_dir, wdepth)
    rng = np.random.default_rng(0)
    with trace.recording() as marks:
        window(runner, [5, 6], rng)
    nested = nesting(marks)
    names = {name for kind, name in marks if kind == "begin"}
    want = STEP_SPANS | {"data.sample", "dispatch.eager", "dispatch.read"}
    if wdepth:
        want |= {"render.depth_head", "data.gather_feats"}
    assert names == want
    assert names <= set(trace.SPANS)
    # every render and loss span inside a step, every step inside the dispatch
    for name, outer in nested:
        if name.startswith(("render.", "step.")):
            assert "step" in outer, (name, outer)
        if name == "step":
            assert outer == ("dispatch.eager",)
        if name == "data.gather_feats":
            assert outer[-1] == "data.sample"
    points = [(name, outer) for (kind, _), (name, outer) in zip(marks, nested) if kind == "at"]
    order = ["bwd.colour_head", "bwd.depth_head", "bwd.sdf", "bwd.nerf"]
    if not wdepth:
        order.remove("bwd.depth_head")
    assert [p for p, _ in points] == order * 2  # two steps
    assert all(outer[-1] == "step.backward" for _, outer in points)


def _grads(runner, traced: bool, seed: int = 3):
    """One step's gradients and metrics from the runner's state, the
    generator reseeded, with tracing on or off -> (metrics, grads, the
    autograd nodes' names of its loss)."""
    tr = runner.trainer
    batch = runner.store.sample_pixels(1, BATCH, np.random.default_rng(seed))
    tr.generator.manual_seed(seed)
    nodes = []
    backward = torch.Tensor.backward

    def seen(loss, *a, **k):
        todo, done = [loss.grad_fn], set()
        while todo:
            fn = todo.pop()
            if fn is None or fn in done:
                continue
            done.add(fn)
            nodes.append(type(fn).__name__)
            todo += [f for f, _ in fn.next_functions]
        return backward(loss, *a, **k)

    torch.Tensor.backward = seen
    try:
        if traced:
            with trace.recording() as marks:
                metrics = tr.gradients(runner.nets, batch, 5)
        else:
            marks = None
            metrics = tr.gradients(runner.nets, batch, 5)
    finally:
        torch.Tensor.backward = backward
    grads = {n: p.grad.clone() for n, p in runner.model.named_parameters()}
    return {k: v.clone() for k, v in metrics.items()}, grads, nodes, marks


@pytest.mark.parametrize("wdepth", [False, True], ids=["womsk", "wdepth"])
def test_tracing_off_adds_nothing_and_changes_no_bit(scene_dir, wdepth):
    runner = make_runner(scene_dir, wdepth)
    m0, g0, nodes0, _ = _grads(runner, traced=False)
    m1, g1, nodes1, marks = _grads(runner, traced=True)
    assert not trace.marks_on()
    assert marks and "_PointBackward" not in nodes0
    assert nodes1.count("_PointBackward") == (4 if wdepth else 3)
    assert sorted(n for n in nodes1 if n != "_PointBackward") == sorted(nodes0)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    # off: the point is the identity on the very tensors
    x = torch.ones(3, requires_grad=True)
    y = torch.zeros(2)
    assert trace.point("bwd.sdf", x) is x
    a, b = trace.point("bwd.sdf", x, y)
    assert a is x and b is y


def test_host_counters_count_what_ran(scene_dir):
    from vdnerf_tpu_torch.train.dispatch import program_name
    from vdnerf_tpu_torch.train.validate import ImageRenderer

    runner = make_runner(scene_dir, True)
    trace.reset()
    window(runner, [5, 6, 7], np.random.default_rng(1))
    host, counts = trace.host(), trace.counts()
    assert host["data.sample"][0] == 3 and host["data.gather_feats"][0] == 3
    assert host["step"][0] == 3 and host["dispatch.read"][0] == 1
    assert counts == {"dispatch.eager_steps." + program_name(runner.nets, True, False): 3}
    assert program_name(runner.nets, True, False) == "core32.distill"
    assert host["data.sample"][1] >= host["data.gather_feats"][1] > 0

    # a frame of 12 x 16 rays in chunks of 100: two chunks, five syncs each
    renderer = ImageRenderer(runner.nets, runner.tcfg, H, W, chunk=100)
    poses, intrin_inv = runner.resolved_cams()
    trace.reset()
    with trace.recording() as marks:
        img = renderer.render_between(runner.model, poses, intrin_inv, 0, 1, 0.3, 2, 5)
    assert img.shape == (H // 2, W // 2, 3) and np.isfinite(img).all()
    assert trace.counts() == {"serve.frames": 1, "serve.chunks": 2, "serve.host_syncs": 10}
    nested = nesting(marks)
    assert [n for k, n in marks if k == "begin"].count("serve.chunk") == 2
    assert {n for k, n in marks if k == "begin"} == {
        "serve.frame", "serve.rays", "serve.chunk", "serve.outputs", "serve.to_host",
        "render.rays", "render.ladder", "render.nerf", "render.sdf", "render.depth_head",
        "render.colour_head", "render.composite"}
    assert not any(k == "at" for k, _ in marks)  # serving runs no backward
    assert all(outer[0] == "serve.frame" for _, outer in nested[1:-1])
    assert renderer.frames == 1


def test_span_registry_and_seconds():
    trace.reset()
    with trace.span("mesh.grid") as s:
        pass
    with trace.span("mesh.grid"):
        pass
    before = trace.host()
    with trace.span("mesh.ply") as p:
        pass
    trace.count("build.compiles", 2)
    host = trace.host()
    assert host["mesh.grid"][0] == 2 and host["mesh.grid"][1] >= s.seconds >= 0.0
    assert trace.seconds("mesh.", since=before) == {"grid": 0.0, "ply": p.seconds}
    assert trace.counts() == {"build.compiles": 2}
    trace.reset()
    assert trace.host() == {} and trace.counts() == {}


class _Clock:
    """perf_counter for the runner: 2 s a call."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 2.0
        return self.t


def test_metrics_rays_per_sec_is_the_window_rate(scene_dir, monkeypatch, caplog):
    from vdnerf_tpu_torch import runner as runner_mod

    runner = make_runner(scene_dir, False, end_iter=20)
    runner.tcfg = dataclasses.replace(runner.tcfg, steps_per_call=5)
    monkeypatch.setattr(runner_mod, "time", _Clock())
    trace.reset()
    with caplog.at_level("INFO", logger=runner_mod.__name__):
        runner.train()
    # the end-of-run line: each program's counts (on the CPU eager steps
    # alone) and the data, dispatch and set-up spans' host seconds
    line = next(r.getMessage() for r in caplog.records if "step programs" in r.getMessage())
    assert "{'core32': {'eager_steps': 20}}" in line
    assert "'data.sample'" in line and "'dispatch.eager'" in line
    with open(os.path.join(runner.base_exp_dir, "logs", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 10, 20]
    # windows of 5 steps, one clock read at the loop's start and one a window
    assert all(r["rays_per_sec"] == 5 * BATCH / 2.0 for r in rows)


def test_mark_kernels_list_the_spans_and_points_in_order():
    src = open(os.path.join(ROOT, "vdnerf_tpu_torch", "ops", "kernels", "csrc",
                            "trace_marks.cu")).read()

    def listed(macro):
        body = re.search(rf"#define {macro}\(X\)(.*?)\n\n", src, re.S).group(1)
        return tuple(n.replace("__", ".") for n in re.findall(r"X\((\w+)\)", body))

    assert listed("VDN_SPANS") == trace.SPANS
    assert listed("VDN_POINTS") == trace.POINTS
    assert not set(trace.SPANS) & HARNESS_SPANS
    assert trace.mark_name("begin", "render.colour_head") == "vdn_mark_begin_render__colour_head"
    assert trace.parse_mark("vdn_mark_at_bwd__sdf") == ("at", "bwd.sdf")
    assert trace.parse_mark("vdn_mark_end_step__adam") == ("end", "step.adam")
    assert trace.parse_mark("sdf_fwd_kernel") is None


def test_by_span_files_device_time_under_the_innermost_span():
    m = trace.mark_name
    events = [
        (m("begin", "step"), 0.0, 0.1),
        (m("begin", "render.ladder"), 0.1, 0.2),
        ("sdf_fwd_kernel", 0.2, 1.2),
        (m("end", "render.ladder"), 1.2, 1.3),
        ("void at::native::elementwise(x)", 1.5, 2.0),  # in step alone
        (m("begin", "step.backward"), 2.0, 2.1),
        ("reduce_kernel", 2.1, 2.6),  # the first piece
        (m("at", "bwd.sdf"), 2.6, 2.7),
        ("Kernel2", 2.7, 3.7),
        ("Memcpy DtoD", 3.5, 4.0),  # overlaps: counted once
        (m("end", "step.backward"), 4.0, 4.1),
        (m("end", "step"), 4.1, 4.2),
        ("copy_kernel", 5.0, 5.5),  # after every span
    ]
    got = trace.by_span(events)
    assert got == pytest.approx({"render.ladder": 1.0, "step": 0.5, "step.backward": 0.5,
                                 "bwd.sdf": 1.3, None: 0.5})
