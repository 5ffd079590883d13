"""The metric arithmetic on synthetic profiler records: the union of
overlapping intervals, the grouping by exact kernel names, the idle gaps
named by span, the work counts of the womsk step written out by hand, the
p95 over every frame."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from vdnbench import harness, trace, work
from vdnbench.drivers.common import quarter_rates
from vdnbench.drivers.views import p95_ms
from vdnbench.tests.small import REPO

MODEL = json.load(open(os.path.join(REPO, "vdnbench", "configs", "womsk.json")))["conf"]["model"]
WDEPTH = json.load(open(os.path.join(REPO, "vdnbench", "configs", "wdepth.json")))["conf"]["model"]


def test_union_of_overlapping_intervals():
    assert trace.union([(0, 2), (1, 3), (5, 6), (6, 7), (10, 11)]) == [(0, 3), (5, 7), (10, 11)]
    assert trace.covered([(0, 2), (1, 3), (1.5, 2.5)]) == 3
    assert trace.clip([(0, 4), (5, 9)], 2, 6) == [(2, 4), (5, 6)]


@pytest.mark.parametrize("name, group", [
    ("void (anonymous namespace)::split_gemm_kernel(SplitProbs)", "mlp"),
    ("split_gemm_kernel", "mlp"),
    ("void sdf_fwd_kernel<64>(float const*, float*, int, float const*, float const*, Params)", "K1"),
    ("void (anonymous namespace)::render_bwd_kernel(float const*)", "mlp"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x128_8x4_nn_align1>(Params)", "cublas"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_cublas", "cublas"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::AbsFunctor<float>>(int)",
     "other"),
    ("void dw_kernel_helper(float*)", "other"),
])
def test_exact_name_grouping(name, group):
    assert trace.group(name) == group


def record(events, spans, units=2):
    return trace.Record(units, events, spans, 10, 1.0, {"runner.sample": 0.01}, {})


def test_busy_group_and_idle_gaps():
    spans = [("runner.sample", 0.0, 1.0), ("dispatch.run", 1.0, 3.0), ("window.read", 3.0, 10.0)]
    events = [("void sdf_fwd_kernel<64>(x)", 1.5, 4.0), ("split_gemm_kernel", 3.0, 5.0),
              ("sm90_xmma_gemm_f32", 6.0, 8.0), ("Memcpy HtoD (Pinned -> Device)", 0.5, 1.0)]
    rec = record(events, spans)
    assert rec.window == (0.0, 10.0) and rec.window_s == 10.0
    assert rec.busy_s() == pytest.approx(0.5 + 3.5 + 2.0)
    assert rec.group_s("K1") == pytest.approx(2.5)
    assert rec.group_s("mlp") == pytest.approx(2.0)
    assert rec.group_s("cublas") == pytest.approx(2.0)
    assert rec.group_s("other") == 0.0
    gaps = rec.idle_gaps()
    assert [(n, a, b) for n, a, b in gaps] == [("runner.sample", 0.0, 0.5), ("dispatch.run", 1.0, 1.5),
                                               ("window.read", 5.0, 6.0), ("window.read", 8.0, 10.0)]
    bd = rec.breakdown()
    assert bd["idle_gaps"][0] == ["window.read", 3.0]
    assert bd["device_ops"][0][0] == "sdf_fwd_kernel"


def test_readers_on_a_record():
    root = REPO
    spans = [("dispatch.run", 0.0, 1.0)]
    events = [("sdf_fwd_kernel", 0.1, 0.2), ("split_gemm_kernel", 0.2, 0.6)]
    w = work.counts(MODEL, {"kind": "train_window", "batch_size": 512})
    rec = trace.Record(10, events, spans, 100, 3.4, {"runner.sample": 0.05}, w)
    read = {m: harness.reader(root, m)(rec) for m in (
        "device.idle_share.train", "step.device_ms.train", "kernels.K1_roofline.train",
        "mfu.train", "runner.host_ms_per_step.train", "renderer.cublas_ms.train")}
    assert read["device.idle_share.train"] == pytest.approx(50.0)
    assert read["step.device_ms.train"] == pytest.approx(50.0)
    t, by = work.bound(w["K1"]["flops"], w["K1"]["bytes"])
    assert by == "operations"
    assert read["kernels.K1_roofline.train"] == pytest.approx(100 * t * 10 / 0.1)
    assert read["mfu.train"] == pytest.approx(100 * w["model_flops"] / 0.034 / 495e12)
    assert read["runner.host_ms_per_step.train"] == pytest.approx(0.5)
    assert read["renderer.cublas_ms.train"] is None


def test_womsk_step_work_by_hand():
    w = work.counts(MODEL, {"kind": "train_window", "batch_size": 512})
    # SDF: 39 -> 256, 256 -> 256 (x2), 256 -> 217 (before the skip), 256 -> 256 (x4), 256 -> 257
    sdf = 39 * 256 + 2 * 256 * 256 + 256 * 217 + 4 * 256 * 256 + 256 * 257
    k1 = sdf - 256 * 257 + 256
    colour = (3 + 27 + 3 + 256) * 256 + 3 * 256 * 256 + 256 * 3
    nerf = (84 * 256 + 7 * 256 * 256 + 84 * 256 + 256 + 256 * 256 + (256 + 27) * 128 + 128 * 3)
    assert w["rows"] == {"rays": 512, "ladder": 512 * (64 + 16 * 3), "ladder_launches": 4,
                         "core": 512 * 96, "bg": 512 * 33}
    assert w["K1"]["flops"] == 2 * 512 * 112 * k1
    assert w["sdf_block"]["flops"] == 6 * 2 * 512 * 96 * sdf
    assert w["mlp"]["flops"] == 3 * 2 * (512 * 96 * colour + 512 * 33 * nerf)
    assert w["model_flops"] == w["K1"]["flops"] + w["sdf_block"]["flops"] + w["mlp"]["flops"]
    assert w["model_flops"] == 503_305_994_240


def test_wdepth_and_frame_work():
    d = work.counts(WDEPTH, {"kind": "train_window", "batch_size": 512})
    depth = (3 + 27 + 3 + 256) * 256 + 3 * 256 * 256 + 256 * 96
    w = work.counts(MODEL, {"kind": "train_window", "batch_size": 512})
    assert d["mlp"]["flops"] - w["mlp"]["flops"] == 3 * 2 * (512 * 96 * depth
                                                             + 512 * 33 * 128 * 96)
    f = work.counts(MODEL, {"kind": "views", "resolution_level": 4, "H": 300, "W": 400})
    assert f["rows"]["rays"] == 7500 and f["rows"]["core"] == 7500 * 96
    assert f["sdf_block"]["flops"] == 2 * 2 * 7500 * 96 * (w["sdf_block"]["flops"]
                                                           // (12 * 512 * 96))


def test_p95_over_every_frame():
    lat = list(np.linspace(0.1, 0.2, 201))
    assert p95_ms(lat) == pytest.approx(195.0)
    lat[-1] = 10.0  # a stall in the tail moves the maximum, not the 95th percentile much
    assert p95_ms(lat) == pytest.approx(195.0)
    assert p95_ms(lat + [10.0] * 20) > 200.0


def test_quarter_rates_split_no_unit():
    # a unit every 0.25 s, 2 rays each, over 4 s: 8 rays/s in every quarter
    ends = [(0.25 * (i + 1), i + 1) for i in range(16)]
    assert quarter_rates(ends, 4.0, 2.0) == pytest.approx([8.0] * 4)
    # the second half twice as fast
    ends = [(0.5 * (i + 1), i + 1) for i in range(4)] + [(2.0 + 0.25 * (i + 1), 5 + i)
                                                         for i in range(8)]
    assert quarter_rates(ends, 4.0, 1.0) == pytest.approx([2.0, 2.0, 4.0, 4.0])
