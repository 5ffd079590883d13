"""``vdnerf_tpu_torch.tools.vdn_cycle_run.main`` on the CPU in every mode.

The conf template is shrunk (``torch_vdn_cycle.shrink``: SDF 4x64, heads
2x64, NeRF 2x32, 8+8 samples, 4 outside), the scene to 3 views of 64^2,
each leg to 10 steps, the side-car to ``mobilenet_light`` (32 channels) for
one epoch, the QC meshes to 16^3 with 2,000 Chamfer samples a side, and the
training loop's own mesh to 16^3 (``runner.mesh_resolution``). Held:

- the full cycle (camlight), then on its ``--out`` ``--skip-to-wdepth``
  with the resampled core (``--render-samples --resample-from
  --resample-frac --leg-tag``), ``--eik-boost`` at two weights and
  ``--cycle2``; and the full cycle with ``--learn --fp32``: each report has
  exactly the top-level keys of its JAX record (``VDN_CYCLE_r05_camlight_w10``,
  ``..._camlight_w10_rs96``, ``EIK_BOOST_r04``, ``VDN_CYCLE2_r04``,
  ``VDN_CYCLE_r05_learn_camlight_w10``) and their nested keys (stages,
  geometry and its cleaning, depth QC, pose recovery, distillation,
  features, the eik-boost arms), ``config`` the record's plus ``gpu``,
  ``device`` and ``card``; every loss is finite and the distillation loss
  fired; the report file holds what ``main`` returned, and the
  ``_card.json`` beside it every stage;
- the precision policy each stage ran under: every runner the tool makes
  (base training, its QC, ``getfeats``, the wdepth training, its QC) builds
  its SDF network under bf16 by default and under f32 with ``--fp32``, and
  ``VDNERF_BF16`` is restored after the run;
- the side-car's finetune and predict run under deterministic cuDNN with
  benchmarking off (entering and leaving each CLI), in every mode that runs
  them, and both cuDNN flags are restored after each stage.
"""

from __future__ import annotations

import functools
import json
import math
import os

import pytest
import torch

from torch_parity import one_torch_thread  # noqa: F401
from torch_vdn_cycle import ROOT, shrink
from vdnerf_tpu_torch import runner as runner_mod
from vdnerf_tpu_torch.tools import vdn_cycle_run as tool

SMALL = ["--iters", "10", "--views", "3", "--img-res", "64", "--wavelet-epochs", "1",
         "--encoder", "mobilenet_light", "--mesh-res", "16", "--batch", "32",
         "--shading", "camlight", "--depth-weight-scale", "10"]
EXTRA = {"gpu", "device", "card"}


def _record(name: str) -> dict:
    with open(os.path.join(ROOT, "docs", name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mode once; the runners' precision policies by mode, in order."""
    policies = []
    init = runner_mod.Runner.__init__

    def recording_init(self, *a, **k):
        init(self, *a, **k)
        policies.append((k.get("mode"), self.model.sdf_network_fine.matmul_dtype))

    side_car = []  # (stage, cuDNN flags entering, leaving, after the tool's stage)

    def cudnn_flags():
        return torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark

    def recording(name, fn):
        def run(*a, **k):
            enter = cudnn_flags()
            result = fn(*a, **k)
            side_car.append([name, enter, cudnn_flags()])
            return result
        return run

    def restored(stage):
        def run(self, *a, **k):
            result = stage(self, *a, **k)
            side_car[-1].append(cudnn_flags())
            return result
        return run

    env_before = os.environ.get(tool.BF16_ENV)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        # a caller that benchmarks nondeterministically: the tool must not
        mp.setattr(torch.backends.cudnn, "deterministic", False)
        mp.setattr(torch.backends.cudnn, "benchmark", True)
        mp.setattr(tool.finetune_cli, "finetune",
                   recording("finetune", tool.finetune_cli.finetune))
        mp.setattr(tool.predict_cli, "main", recording("predict", tool.predict_cli.main))
        mp.setattr(tool.Cycle, "finetune", restored(tool.Cycle.finetune))
        mp.setattr(tool.Cycle, "predict", restored(tool.Cycle.predict))
        shrink(mp, tool)
        mp.setattr(tool, "run_qc", functools.partial(tool.run_qc, n_points=2000))
        mp.setattr(runner_mod, "mesh_resolution", lambda step: (16, False))
        mp.setattr(runner_mod.Runner, "__init__", recording_init)
        d = str(tmp_path_factory.mktemp("vdn_cycle"))
        main = SMALL + ["--out", d]
        out["full"] = tool.main(main, device="cpu")
        out["policies_full"] = list(policies)
        out["rs96"] = tool.main(main + ["--skip-to-wdepth", "--render-samples", "24",
                                        "--resample-from", "5", "--resample-frac", "1.0",
                                        "--leg-tag", "_rs96"], device="cpu")
        out["eik"] = tool.main(main + ["--eik-boost", "0.1", "1", "--eik-iters", "10"],
                               device="cpu")
        out["cycle2"] = tool.main(main + ["--cycle2"], device="cpu")
        policies.clear()
        learn = str(tmp_path_factory.mktemp("vdn_cycle_learn"))
        out["learn"] = tool.main(SMALL + ["--learn", "--fp32", "--out", learn], device="cpu")
        out["policies_learn"] = list(policies)
        out["env_after"] = os.environ.get(tool.BF16_ENV)
    out["env_before"] = env_before
    out["side_car"] = side_car
    out["dirs"] = {"main": d, "learn": learn}
    return out


def _finite(x) -> bool:
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_finite(v) for v in x)
    if isinstance(x, float):
        return math.isfinite(x)
    return True


def _same_keys(got: dict, want: dict, nested=()) -> None:
    assert set(got) == set(want)
    for k in nested:
        assert set(got[k]) == set(want[k]), k


GEOMETRY_NESTED = ("clean",)


def _check_leg(rep: dict, want: dict, prefix: str) -> None:
    _same_keys(rep[f"{prefix}_geometry"], want[f"{prefix}_geometry"], GEOMETRY_NESTED)
    _same_keys(rep[f"{prefix}_depth_export_qc"], want[f"{prefix}_depth_export_qc"])
    assert rep[f"{prefix}_geometry"]["mesh_res"] == 16
    assert math.isfinite(rep[f"{prefix}_object_masked_psnr_res2"])
    assert math.isfinite(rep[f"{prefix}_eikonal"])


def _check_distillation(rep: dict) -> None:
    dist = rep["distillation"]
    assert set(dist) == {"depth_loss_first", "depth_loss_last", "all_losses_finite"}
    assert dist["all_losses_finite"] is True
    assert dist["depth_loss_first"] is not None and math.isfinite(dist["depth_loss_first"])
    assert math.isfinite(dist["depth_loss_last"])


def _check_config(rep: dict, want: dict) -> None:
    assert set(want["config"]) <= set(rep["config"])
    assert set(rep["config"]) - set(want["config"]) <= EXTRA | set(_record(
        "VDN_CYCLE_r05_learn_camlight_w10.json")["config"])
    assert EXTRA <= set(rep["config"])
    assert rep["config"]["device"] == "cpu" and rep["config"]["card"] is None


def _check_files(out_dir: str, name: str, rep: dict, stages) -> None:
    with open(os.path.join(out_dir, name)) as f:
        assert json.load(f) == json.loads(json.dumps(rep))
    with open(os.path.join(out_dir, name[:-5] + "_card.json")) as f:
        card = json.load(f)
    assert card["card"] is None and card["device"] == "cpu"
    assert list(card["stages"]) == list(stages)
    for st in card["stages"].values():
        assert set(st) == {"wall_s", "peak_memory_bytes", "launches"}
        assert st["peak_memory_bytes"] is None  # no card
        assert set(st["launches"]) == {"sdf_fwd", "render_fwd", "nerf_fwd", "render_bwd",
                                       "nerf_bwd", "dw_contract", "render_fwd_f32",
                                       "nerf_fwd_f32", "render_bwd_f32", "nerf_bwd_f32",
                                       "dw_contract_f32", "sdf_block"}


CYCLE_STAGES = ("scene_gen", "train_base", "qc_base", "getfeats", "wavelet_finetune",
                "predict", "train_wdepth", "qc_wdepth")


@pytest.mark.parametrize("name,record", [("full", "VDN_CYCLE_r05_camlight_w10.json"),
                                         ("learn", "VDN_CYCLE_r05_learn_camlight_w10.json")])
def test_full_cycle_report_has_the_jax_records_keys(runs, name, record):
    rep, want = runs[name], _record(record)
    _same_keys(rep, want, ("stages", "depth_export", "vdn_features", "distillation"))
    _check_config(rep, want)
    for prefix in ("base", "wdepth"):
        _check_leg(rep, want, prefix)
    if name == "learn":
        _same_keys(rep["base_pose_recovery"], want["base_pose_recovery"])
        _same_keys(rep["wdepth_pose_recovery"], want["wdepth_pose_recovery"])
    _check_distillation(rep)
    assert rep["depth_export"]["n_maps"] == 3 and rep["depth_export"]["depth_finite"]
    assert rep["vdn_features"] == {"n_views": 3, "shape": [1, 32, 32, 32], "finite": True}
    assert _finite({k: v for k, v in rep.items() if k != "config"})
    _check_files(runs["dirs"]["main" if name == "full" else "learn"], "vdn_cycle_report.json",
                 rep, CYCLE_STAGES)


def test_skip_to_wdepth_report_has_the_jax_records_keys(runs):
    rep, want = runs["rs96"], _record("VDN_CYCLE_r05_camlight_w10_rs96.json")
    _same_keys(rep, want, ("stages", "base_from", "distillation"))
    _check_config(rep, want)
    assert rep["base_from"]["base_geometry"] == runs["full"]["base_geometry"]
    _check_leg(rep, want, "wdepth")
    _check_distillation(rep)
    assert rep["config"]["render_samples"] == 24 and rep["config"]["leg_tag"] == "_rs96"
    _check_files(runs["dirs"]["main"], "vdn_cycle_report_wdepth10_rs96.json", rep,
                 ("train_wdepth", "qc_wdepth"))
    assert os.path.isdir(os.path.join(runs["dirs"]["main"], "exp_wdepth_10_rs96"))


def test_eik_boost_report_has_the_jax_records_keys(runs):
    rep, want = runs["eik"], _record("EIK_BOOST_r04.json")
    _same_keys(rep, want, ("wdepth_baseline",))
    _check_config(rep, want)
    assert list(rep["arms"]) == ["igr_0.1", "igr_1"]
    for arm_name, arm in rep["arms"].items():
        want_arm = want["arms"][arm_name]
        _same_keys(arm, want_arm, ("depth_export_qc",))
        _same_keys(arm["geometry"], want_arm["geometry"], GEOMETRY_NESTED)
        assert _finite(arm)
    assert rep["arms"]["igr_1"]["igr_weight"] == 1.0
    _check_files(runs["dirs"]["main"], "eik_boost_report.json", rep,
                 ("train_eikboost_w0p1", "qc_eikboost_w0p1", "train_eikboost_w1",
                  "qc_eikboost_w1"))
    for tag in ("w0p1", "w1"):
        assert os.path.exists(os.path.join(runs["dirs"]["main"], f"exp_eikboost_{tag}",
                                           "checkpoints", "ckpt_000020.pth"))


def test_cycle2_report_has_the_jax_records_keys(runs):
    rep, want = runs["cycle2"], _record("VDN_CYCLE2_r04.json")
    _same_keys(rep, want, ("stages", "cycle1", "vdn_features", "distillation"))
    _check_config(rep, want)
    assert rep["cycle1"]["wdepth_geometry"] == runs["full"]["wdepth_geometry"]
    _check_leg(rep, want, "wdepth")
    _check_distillation(rep)
    img = os.path.join(runs["dirs"]["main"], "compound", "image")
    for kept in ("depth_from_sdf_c1", "wavelet_feats_c1", "depth_from_sdf", "wavelet_feats"):
        assert os.path.isdir(os.path.join(img, kept)), kept
    _check_files(runs["dirs"]["main"], "vdn_cycle2_report.json", rep,
                 ("getfeats", "wavelet_finetune", "predict", "train_wdepth", "qc_wdepth"))


@pytest.mark.parametrize("name,dtype", [("policies_full", torch.bfloat16),
                                        ("policies_learn", None)])
def test_every_stage_runs_under_one_precision_policy(runs, name, dtype):
    modes = [m for m, _ in runs[name]]
    assert modes == ["train", "eval", "getfeats", "train", "eval"]
    assert [p for _, p in runs[name]] == [dtype] * 5
    assert runs["env_after"] == runs["env_before"]


def test_side_car_stages_run_under_deterministic_cudnn(runs):
    # the full cycle, --cycle2 and --learn each run finetune then predict
    names = [rec[0] for rec in runs["side_car"]]
    assert names == ["finetune", "predict"] * 3
    for name, enter, leave, after in runs["side_car"]:
        assert enter == (True, False), name
        assert leave == (True, False), name
        assert after == (False, True), name
