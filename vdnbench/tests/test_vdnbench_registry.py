"""A cell, a configuration, a traffic mix and a per-layer metric added as new
files (and entries in BENCHMARK.json) are picked up with no edit to the
harness; a run's last line has the contract's keys, ``checks`` last."""

from __future__ import annotations

import io
import json
import os
import shutil
import time

import pytest
import torch

from vdnbench import harness, run
from vdnbench.tests.small import REPO, small_root


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def add_cell(root: str) -> None:
    """A new configuration, mix, cell, limits and per-layer metric, as files."""
    home = os.path.join(root, harness.HOME)
    with open(os.path.join(home, "configs", "womsk.json")) as f:
        config = json.load(f)
    config["name"] = "womsk_b"
    config["conf"]["train"]["batch_size"] = 8
    with open(os.path.join(home, "configs", "womsk_b.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(home, "traffic", "train_rs96.json")) as f:
        mix = json.load(f)
    mix["start_step"] = 70000
    with open(os.path.join(home, "traffic", "train_late.json"), "w") as f:
        json.dump(mix, f)
    shutil.copy(os.path.join(home, "limits", "womsk.train_rs96.json"),
                os.path.join(home, "limits", "womsk_b.train_late.json"))
    with open(os.path.join(home, "metrics", "demo.steps_traced.train.py"), "w") as f:
        f.write("def read(rec):\n    return float(rec.units)\n")
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "womsk_b", "source": "https://example.org/womsk_b",
                             "file": "vdnbench/configs/womsk_b.json", "reduced": [],
                             "why": "a test configuration"})
    bench["workloads"].append({"name": "womsk_b.train_late", "config": "womsk_b",
                               "traffic": "train_late", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_rays_per_s":
            m["workloads"].append("womsk_b.train_late")
    bench["per_layer"].append({"name": "demo.steps_traced.train", "unit": "steps",
                               "better": "higher", "source": "program_counter",
                               "layer": "a test layer", "moves": "train_rays_per_s",
                               "workloads": ["womsk_b.train_late"]})
    with open(path, "w") as f:
        json.dump(bench, f)


def test_new_cell_and_metric_from_files_alone(tmp_path):
    root = small_root(str(tmp_path / "root"))
    add_cell(root)
    cell = harness.cell(root, "womsk_b.train_late")
    assert cell["traffic"]["start_step"] == 70000
    assert cell["config"]["conf"]["train"]["batch_size"] == 8
    assert [m["name"] for m in cell["per_layer"]] == ["demo.steps_traced.train"]
    work = tmp_path / "work"
    work.mkdir()
    out = harness.run_cell(root, "womsk_b.train_late", 2**31 + 3, 0.2, True, "cpu", str(work),
                           time.perf_counter())
    assert out["metrics"]["demo.steps_traced.train"]["value"] == 20.0
    assert out["correct"] is True
    assert harness.reader(root, "demo.steps_traced.train") is not None


def test_last_line_has_the_contract_keys(tmp_path):
    root = small_root(str(tmp_path / "root"))
    work = tmp_path / "work"
    work.mkdir()
    out = harness.run_cell(root, "womsk.views_l4", 5, 0.3, False, "cpu", str(work),
                           time.perf_counter())
    stdout, stderr = io.StringIO(), io.StringIO()
    run.emit(out, stdout, stderr)
    last = json.loads(stdout.getvalue().strip().splitlines()[-1])
    assert list(last) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(last["metrics"]) == {"render_rays_per_s", "frame_ms_p95", "setup_s"}
    assert set(last["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    err = stderr.getvalue().strip().splitlines()
    assert err[-1].startswith("check colour_gap_p99 = ") and " limit " in err[-1]


def test_traced_line_reports_per_layer_metrics_only(tmp_path):
    root = small_root(str(tmp_path / "root"))
    work = tmp_path / "work"
    work.mkdir()
    out = harness.run_cell(root, "womsk.train_rs96", 9, 0.2, True, "cpu", str(work),
                           time.perf_counter())
    names = {m["name"] for m in harness.cell(root, "womsk.train_rs96")["per_layer"]}
    assert set(out["metrics"]) <= names
    # host spans are there on the CPU; device metrics find nothing to read
    assert "runner.host_ms_per_step.train" in out["metrics"]
    assert "step.device_ms.train" not in out["metrics"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(out["device"])


@pytest.mark.parametrize("names, found", [
    (["jax.numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["vdnerf_tpu.models.fields"], ["vdnerf_tpu"]),
    (["vdnerf_tpu_torch.runner", "jaxtyping", "flaxen"], []),
])
def test_forbidden_modules_compared_by_whole_top_level_name(monkeypatch, names, found):
    import sys

    for name in names:
        monkeypatch.setitem(sys.modules, name, object())
    present = set(run.loaded_forbidden())
    assert present >= set(found)
    assert not present & ({n.split(".")[0] for n in names} - set(found))


@pytest.mark.parametrize("metric", [m["name"] for m in harness.load_json(
    os.path.join(REPO, "BENCHMARK.json"))["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(harness.reader(REPO, metric))


def test_variants_of_a_metric_share_one_reader(tmp_path):
    home = tmp_path / harness.HOME / "metrics"
    home.mkdir(parents=True)
    (home / "demo.py").write_text("def read(rec):\n    return 1.0\n")
    (home / "demo.render.py").write_text("def read(rec):\n    return 2.0\n")
    assert harness.reader(str(tmp_path), "demo.train")(None) == 1.0
    assert harness.reader(str(tmp_path), "demo.render")(None) == 2.0
    with pytest.raises(FileNotFoundError):
        harness.reader(str(tmp_path), "other.train")


def test_reduced_lists_every_departure_of_each_configuration():
    for entry in harness.load_json(os.path.join(REPO, "BENCHMARK.json"))["configs"]:
        config = harness.load_json(os.path.join(REPO, entry["file"]))
        assert entry["reduced"] == config["reduced"]
        assert set(config["reduced"]) == set(config["recipe"]) | set(config["moved"])
        assert set(config["moved"]) == set(config["overrides"])
