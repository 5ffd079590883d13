"""The benchmark's general part: find a cell's files by name, write its conf,
time its spans, run it and judge it.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own under ``vdnbench/``, found by the name
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the conf tree as it is run, the keys the
  harness overrides, the scene, the source, ``reduced`` and ``assumed``;
- ``traffic/<traffic>.json``: a traffic mix, the parameters of one of the
  traffic kinds in ``drivers/`` (``kind`` names it);
- ``limits/<workload>.json``: the limit of each number the cell's check
  compares;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(record)``
  -> a number, or None where it finds nothing to read; a reader that serves
  a metric's variants for different cells (``mfu.train``, ``mfu.render``)
  drops the last part of the name (``metrics/mfu.py``).
"""

from __future__ import annotations

import collections
import contextlib
import importlib
import importlib.util
import json
import math
import os
import time

HOME = "vdnbench"


# -- finding a cell -----------------------------------------------------------


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def for_cell(entries: list[dict], workload: str) -> list[dict]:
    """The metrics that a cell reports: those that list it, and those that
    list no cells."""
    return [m for m in entries if workload in m.get("workloads", [workload])]


def cell(root: str, workload: str) -> dict:
    """Everything a run of ``workload`` reads, from the files under ``root``."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return {
        "name": workload,
        "entry": entry,
        "config": load_json(os.path.join(root, config["file"])),
        "traffic": load_json(os.path.join(root, HOME, "traffic", entry["traffic"] + ".json")),
        "limits": load_json(os.path.join(root, HOME, "limits", workload + ".json")),
        "end_to_end": for_cell(bench["end_to_end"], workload),
        "per_layer": for_cell(bench["per_layer"], workload),
    }


def reader(root: str, metric: str):
    """The ``read`` function of ``metrics/<metric>.py``, or, where there is
    none, of the file named without the metric's last part: one reader for
    ``mfu.train`` and ``mfu.render`` is ``metrics/mfu.py``."""
    path = os.path.join(root, HOME, "metrics", metric + ".py")
    if not os.path.exists(path) and "." in metric:
        path = os.path.join(root, HOME, "metrics", metric.rsplit(".", 1)[0] + ".py")
    spec = importlib.util.spec_from_file_location("vdnbench_metric_" + metric.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(kind: str):
    """The driver class of a traffic kind (``drivers/<kind>.py``)."""
    return importlib.import_module(f"vdnbench.drivers.{kind}").Driver


# -- the conf -----------------------------------------------------------------


def _value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, list):
        return "[" + ", ".join(_value(x) for x in v) + "]"
    return json.dumps(str(v))


def hocon(tree: dict, indent: int = 0) -> str:
    """A conf tree as HOCON text."""
    pad = "    " * indent
    lines = []
    for k, v in tree.items():
        if isinstance(v, dict):
            lines += [f"{pad}{k} {{", hocon(v, indent + 1), f"{pad}}}"]
        else:
            lines.append(f"{pad}{k} = {_value(v)}")
    return "\n".join(lines)


def write_conf(config: dict, path: str, overrides: dict, control: dict | None = None) -> str:
    """The configuration's conf tree with ``overrides`` (dotted keys, each
    listed in the configuration's ``overrides``) -> ``path``. ``control``:
    the keys a precision control switches (``vdnbench/control.py``), never
    set in a benchmark run."""
    tree = json.loads(json.dumps(config["conf"]))
    for key in overrides:
        if key not in config["overrides"]:
            raise ValueError(f"{key} is not an override the configuration lists")
    for key, value in {**overrides, **(control or {})}.items():
        node = tree
        *parents, last = key.split(".")
        for part in parents:
            node = node[part]
        node[last] = value
    with open(path, "w") as f:
        f.write(hocon(tree) + "\n")
    return path


# -- spans --------------------------------------------------------------------


class Spans:
    """Host seconds in each named span; while ``tracing``, each span is also
    a ``torch.profiler.record_function`` range."""

    def __init__(self):
        self.host_s: dict[str, float] = collections.defaultdict(float)
        self.tracing = False

    def reset(self) -> None:
        self.host_s.clear()

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        if self.tracing:
            import torch

            with torch.profiler.record_function(name):
                yield
        else:
            yield
        self.host_s[name] += time.perf_counter() - t0


# -- a run --------------------------------------------------------------------


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit -> (all within, {name: [value,
    limit]}). A number that is missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = [value, limit]
    return ok, checks


def run_cell(root: str, workload: str, seed: int, seconds: float, traced: bool, device,
             workdir: str, t_start: float) -> dict:
    """One run of a cell: set-up (timed from ``t_start``), the window, the
    traced sub-window when ``traced``, the program freed, then the check.
    -> the result's fields (``checks`` last)."""
    import torch

    c = cell(root, workload)
    drv = driver(c["traffic"]["kind"])(c, seed, device, workdir)
    drv.setup()
    setup_s = time.perf_counter() - t_start
    window = drv.window(seconds)
    metrics = {}
    device_info: dict = {}
    breakdown = None
    if traced:
        rec = drv.traced()
        for m in c["per_layer"]:
            value = reader(root, m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        device_info = {"busy_s": rec.busy_s(), "window_s": rec.window_s}
        breakdown = rec.breakdown()
    else:
        values = {**window["values"], "setup_s": setup_s}
        for m in c["end_to_end"]:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
    drv.free()
    numbers = drv.numbers()
    correct, checks = judge(numbers, c["limits"])
    out = {"correct": correct and window["failed"] == 0, "attempted": window["attempted"],
           "failed": window["failed"], "metrics": metrics,
           "device": {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
                      "kind": (torch.cuda.get_device_name(device)
                               if torch.device(device).type == "cuda" else "cpu"),
                      "count": 1, "memory_peak_bytes": int(peak), **device_info}}
    if breakdown is not None:
        out["breakdown"] = breakdown
    phases, last = {}, t_start
    for phase, t in drv.marks:
        phases[phase], last = t - last, t
    out["info"] = {**window.get("info", {}), "setup_phases_s": phases, "numbers": numbers,
                   **getattr(drv, "detail", {})}
    out["checks"] = checks
    return out
