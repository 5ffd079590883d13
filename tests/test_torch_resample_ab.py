"""``vdnerf_tpu_torch/tools/resample_ab.py``, the counterpart of
``tools/resample_ab.py``, on the CPU.

- Its ``CONF`` text is the JAX tool's byte for byte, and each arm's conf
  file is the one the JAX tool writes for the same flags (the JAX tool run
  up to its first training call, which is stopped).
- A few-step run of both arms through the port's CLI writes the JAX tool's
  report (``config``, ``arms``, ``delta``) and, with ``--row``, a row of
  ``docs/RESAMPLE_AB_CPU.json``'s ``final`` form beside the JAX record's
  delta of that row.
- Without a card and an explicit CPU it refuses.
"""

from __future__ import annotations

import importlib.util
import json
import os

import pytest
import torch

from torch_parity import one_torch_thread  # noqa: F401
from vdnerf_tpu_torch.tools import resample_ab

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Stop(Exception):
    pass


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_resample_ab",
                                                  os.path.join(ROOT, "tools", "resample_ab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_conf_text_is_the_jax_tools():
    assert resample_ab.CONF == _jax_tool().CONF


@pytest.mark.parametrize("flags", [
    [],
    ["--masked", "--onset-frac", "0.5"],
    ["--fast-bg", "--onset-frac", "0.4", "--uniform-frac", "1.0", "--iters-b", "30"],
], ids=["default", "masked_onset", "fastbg_onset_frac"])
def test_arm_confs_are_the_jax_tools(tmp_path, monkeypatch, flags):
    """Each arm's conf, as the JAX tool writes it before its training call."""
    import vdnerf_tpu.cli as jax_cli

    written = {}

    def stop(argv):
        path = argv[argv.index("--conf") + 1]
        with open(path) as f:
            written[os.path.basename(path)] = f.read()
        raise _Stop

    monkeypatch.setattr(jax_cli, "main", stop)
    argv = ["--iters", "20", "--views", "2", "--img-res", "16", "--workdir",
            str(tmp_path), "--out", str(tmp_path / "r.json")] + flags
    for skip in ([], ["--skip-faithful"]):
        with pytest.raises(_Stop):
            _jax_tool().main(argv + skip)
    assert set(written) == {"faithful.conf", "resample.conf"}
    args = resample_ab.build_parser().parse_args(argv)
    scene = os.path.join(str(tmp_path), "compound")
    for arm, m in (("faithful", 0), ("resample", args.render_samples)):
        iters = args.iters_b if m and args.iters_b else args.iters
        path = resample_ab.write_arm_conf(str(tmp_path / f"port_{arm}.conf"), args,
                                          os.path.join(str(tmp_path), f"exp_{arm}"), scene,
                                          iters, m)
        with open(path) as f:
            assert f.read() == written[f"{arm}.conf"], arm


def test_few_step_cpu_run_writes_the_record_keys(tmp_path):
    with open(os.path.join(ROOT, "docs", "RESAMPLE_AB_CPU.json")) as f:
        jax_row = json.load(f)["final"]["womsk_10k_fastbg_onset"]
    record = tmp_path / "record.json"
    report = resample_ab.main(
        ["--iters", "20", "--views", "4", "--img-res", "32", "--mesh-res", "32", "--batch",
         "32", "--fast-bg", "--onset-frac", "0.5", "--workdir", str(tmp_path / "work"),
         "--out", str(tmp_path / "report.json"), "--row", "womsk_10k_fastbg_onset",
         "--record", str(record)], device="cpu")
    assert set(report) == {"config", "arms", "delta"}
    assert set(report["arms"]) == {"faithful", "resample"}
    for arm in report["arms"].values():
        assert set(arm) == {"core_samples", "object_masked_psnr_res2", "eikonal", "geometry",
                            "train_wall_s"}
        assert arm["geometry"]["mesh_res"] == 32 and arm["train_wall_s"] > 0
    assert set(report["delta"]) == {"psnr_db", "chamfer_ratio"}
    with open(record) as f:
        row = json.load(f)["final"]["womsk_10k_fastbg_onset"]
    assert set(jax_row) - {"note"} <= set(row)
    assert row["jax_delta"] == jax_row["delta"]
    for arm, rec in row["arms"].items():
        assert set(rec) == set(jax_row["arms"][arm])
    assert (row["config"]["iters"], row["onset_frac"], row["fast_bg"]) == (20, 0.5, True)


def test_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resample_ab.main(["--workdir", str(tmp_path)])
