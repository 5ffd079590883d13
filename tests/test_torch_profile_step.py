"""``vdnerf_tpu_torch/tools/profile_step.py``, the counterpart of
``tools/profile_step.py``, on the CPU at small widths.

- Its FLOP table is the JAX tool's formulas (``mlp_flops`` per layer stack,
  the NeRF's heads, 3x for a backward, 4 lanes for the SDF value + gradient
  + feature) on the same networks, with and without a resampled core.
- Its forward components compute what the JAX package's functions compute
  on the same seeded inputs and weights (``torch_parity``): the SDF value,
  the value + gradient + feature, the colour head, the background NeRF, one
  up-sample round, the inverse-CDF draw, the transmittance composite within
  1e-5 of each output's largest entry, and the whole forward render within
  1e-4 (the ladder amplifies f32 summation order, as in
  ``tests/test_torch_novel_views.py``); its backward components give the
  parameter gradients autograd gives.
- ``main(..., device="cpu")`` at ``--iters 2`` writes a report with the JAX
  report's keys, and without a card and an explicit CPU it refuses.
"""

from __future__ import annotations

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_nets, jax_params, one_torch_thread, port_model, port_nets  # noqa: F401
from vdnerf_tpu.models import fields as jf
from vdnerf_tpu.ops import renderer as jr
from vdnerf_tpu.ops import sampling as js
from vdnerf_tpu_torch.data.synthetic import write_synthetic_conf
from vdnerf_tpu_torch.tools import profile_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
JAX_REPORT_KEYS = {"batch", "bf16", "fused", "fast_bg", "render_samples", "dispatch_floor_ms",
                   "components_ms", "derived_bwd_ms", "tflops_est", "rays_per_sec"}


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_profile_step",
                                                  os.path.join(ROOT, "tools", "profile_step.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_table(nets, B, rs):
    """The JAX tool's FLOP accounting (tools/profile_step.py), written out
    with its own mlp_flops on the JAX configs."""
    mlp_flops = _jax_tool().mlp_flops
    r = nets.renderer
    n_s, n_imp, n_out = r.n_samples, r.n_importance, r.n_outside
    per_round = n_imp // r.up_sample_steps
    sdf_f, color_f = mlp_flops(nets.sdf.dims), mlp_flops(nets.color.dims)
    W = nets.nerf.W
    nerf_f = mlp_flops((nets.nerf.input_ch,) + (W,) * nets.nerf.D) + 2 * W * (W + 1) + \
        2 * (W + nets.nerf.input_ch_view) * (W // 2) + 2 * (W // 2) * 3
    n_core = B * (n_s + n_imp)
    nc, nb = n_s + n_imp, n_s + n_imp + n_out
    want = {
        f"sdf_fwd_{n_s}spp": B * n_s * sdf_f,
        f"sdf_valgradfeat_{nc}spp": n_core * sdf_f * 4,
        f"color_net_{nc}spp": n_core * color_f,
        f"bg_nerf_{nb}spp": B * nb * nerf_f,
        "full_train_step": (B * (n_s + 3 * per_round) * sdf_f + n_core * sdf_f * 4
                            + n_core * color_f + B * nb * nerf_f) * 3.0,
        f"sdf_vgf_fwdbwd2nd_{nc}spp": n_core * sdf_f * 4 * 3.0,
        f"sdf_value_fwdbwd1st_{nc}spp": n_core * sdf_f * 3.0,
        f"color_fwdbwd_{nc}spp": n_core * color_f * 3.0,
        f"bg_nerf_fwdbwd_{nb}spp": B * nb * nerf_f * 3.0,
    }
    if rs and rs != nc:
        want[f"sdf_valgradfeat_{rs}spp"] = B * rs * sdf_f * 4
        want[f"color_net_{rs}spp"] = B * rs * color_f
        want[f"sdf_vgf_fwdbwd2nd_{rs}spp"] = B * rs * sdf_f * 4 * 3.0
        want[f"color_fwdbwd_{rs}spp"] = B * rs * color_f * 3.0
    return want


@pytest.mark.parametrize("width", ["small", "full"])
@pytest.mark.parametrize("rs", [0, 24])
def test_flop_table_is_the_jax_tools_formulas(width, rs):
    if width == "small":
        nets = jax_nets()
    else:  # the JAX configs' defaults: the womsk_white dims
        nets = jr.NeuSNetworks(sdf=jf.SDFConfig(), color=jf.RenderConfig(),
                               nerf=jf.NeRFConfig(), renderer=jr.RendererConfig())
        rs = rs * 4
    got = profile_step.flop_table(port_nets(nets), 512, rs)
    assert got == _jax_table(nets, 512, rs)
    assert profile_step.mlp_flops((3, 5, 7)) == _jax_tool().mlp_flops((3, 5, 7)) == 100.0


@pytest.fixture(scope="module")
def setup():
    nets = jax_nets(skip_bg_inside=True, n_render_samples=24, resample_uniform_frac=1.0)
    params = jax_params(nets)
    pnets = port_nets(nets)
    model = port_model(nets, params, torch.float32)
    s = profile_step.shapes(pnets, 16, 24)
    x = profile_step.make_inputs(pnets, s, CPU)
    return nets, params, pnets, model, s, x


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), f"{what}: {err:.3e}"


def test_forward_components_compute_the_jax_functions(setup):
    nets, params, pnets, model, s, x = setup
    comps = profile_step.forward_components(pnets, model, s, x)
    j = {k: jnp.asarray(v.numpy()) for k, v in x.items()}
    n_s, nc, nb, rs = s["n_s"], s["n_core"], s["n_bg"], s["rs"]
    _close(comps[f"sdf_fwd_{n_s}spp"](), jf.sdf_value(nets.sdf, params["sdf"], j["pts_s"]),
           1e-5, "sdf value")
    for n in (nc, rs):
        got = comps[f"sdf_valgradfeat_{n}spp"]()
        want = jf.sdf_value_grad_feat(nets.sdf, params["sdf"], j[f"pts_{n}"])
        for g, w, what in zip(got, want, ("sdf", "gradient", "feature")):
            _close(g, w, 1e-5, f"{what} at {n}")
        _close(comps[f"color_net_{n}spp"](),
               jf.render_net_apply(nets.color, params["color"], j[f"pts_{n}"], j[f"dirs_{n}"],
                                   j[f"dirs_{n}"], j[f"feat_{n}"]), 1e-5, f"colour at {n}")
    dens, rgb, _ = comps[f"bg_nerf_{nb}spp"]()
    jd, jc, _ = jf.nerf_apply(nets.nerf, params["nerf"], j[f"pts4_{nb}"], j[f"views_{nb}"])
    _close(dens, jd, 1e-5, "nerf density")
    _close(rgb, jc, 1e-5, "nerf colour")
    _close(comps[f"up_sample_round({n_s}spp)"](),
           js.up_sample(j["rays_o"], j["rays_d"], j["z0"], j["sdf0"], s["per_round"], 64.0),
           1e-5, "up-sample round")
    _close(comps[f"sample_pdf({n_s + 3 * s['per_round']}bins)"](),
           js.sample_pdf(j["z_last"], j["w_last"], s["per_round"], det=True), 1e-5, "sample_pdf")
    _close(comps[f"transmittance_{nb}"](), j["alpha0"] * js.transmittance(j["alpha0"]), 1e-5,
           "transmittance")
    want = jr.render(nets, params, j["rays_o"], j["rays_d"], j["near"], j["far"],
                     perturb_overwrite=0, background_rgb=jnp.ones((1, 3)),
                     cos_anneal_ratio=1.0)["color_fine"]
    _close(comps["full_render_fwd"](), want, 1e-4, "full render")


def test_backward_components_give_autograds_gradients(setup):
    _, _, pnets, model, s, x = setup
    comps = profile_step.backward_components(pnets, model, s, x)
    n = s["step_core"]
    assert {f"sdf_vgf_fwdbwd2nd_{n}spp", f"color_fwdbwd_{n}spp", f"render_core_fwdbwd_{n}spp",
            f"bg_nerf_fwdbwd_{s['step_bg']}spp"} <= set(comps)
    sdf = model.sdf_network_fine
    got = comps[f"sdf_vgf_fwdbwd2nd_{n}spp"]()
    pts = x[f"pts_{n}"].clone().requires_grad_(True)
    v, f = sdf.forward_split(pts)
    (g,) = torch.autograd.grad(v.sum(), pts, create_graph=True)
    scalar = (v.sum() + ((torch.linalg.norm(g, dim=-1) - 1.0) ** 2).sum() + f.sum()) * 1e-6
    want = torch.autograd.grad(scalar, list(sdf.parameters()))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-9)
    core = comps[f"render_core_fwdbwd_{n}spp"]()
    assert all(t is not None and torch.isfinite(t).all() and t.any() for t in core)


def test_cpu_run_writes_a_report_with_the_jax_keys(tmp_path):
    conf = write_synthetic_conf(str(tmp_path / "small.conf"), data_dir=str(tmp_path),
                                exp_dir=str(tmp_path / "exp"))
    out = tmp_path / "report.json"
    report = profile_step.main(["--conf", conf, "--iters", "2", "--batch", "16", "--fp32",
                                "--fast-bg", "--render-samples", "24", "--resample-frac", "1.0",
                                "--out", str(out)], device="cpu")
    with open(out) as f:
        assert json.load(f).keys() == report.keys()
    assert JAX_REPORT_KEYS <= set(report)
    assert report["config"]["mlp_operands"] == "float32" and not report["fused"]
    parts = report["step_parts_ms"]
    assert parts["sum"] == pytest.approx(sum(v for k, v in parts.items()
                                             if k not in ("sum", "rest_rays_loss_adam")))
    assert report["components_sum_ms"] == parts["sum"]
    assert {"full_train_step", "full_loss_fwd_only", "full_step_igr0", "ladder",
            f"serving_chunk_{profile_step.SERVING_RAYS}"} <= set(report["components_ms"])
    assert all(v > 0 for v in report["components_ms"].values())


def test_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_step.main(["--out", str(tmp_path / "r.json")])
