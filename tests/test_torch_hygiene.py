"""Package rules of vdnerf_tpu_torch.

- No module of the port, and not ``chip_smoke.py``, imports ``jax`` or anything
  of ``vdnerf_tpu`` (an AST scan, so a lazy import inside a function counts),
  nor ``matplotlib``: the card's machine is not known to have it, and the
  frustum plot is drawn with cv2.
- The entry points run on the card: without an explicit ``device="cpu"`` they
  raise when CUDA is missing, and do not carry on on the CPU.
- On CPU tensors the kernel wrappers run their plain versions and count no
  launch.
"""

from __future__ import annotations

import ast
import os
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "vdnerf_tpu")


def _port_sources() -> list[Path]:
    files = sorted((ROOT / "vdnerf_tpu_torch").rglob("*.py"))
    assert len(files) > 20
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_matplotlib(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] == "matplotlib"]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_catches_the_forbidden_forms(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import jax.numpy as jnp\n"
        "def f():\n    from vdnerf_tpu.utils import hocon\n"
        "import vdnerf_tpu_torch.ops\n"
    )
    assert [m for m in _imported_modules(src) if _forbidden(m)] == [
        "jax.numpy", "vdnerf_tpu.utils"
    ]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_runner_and_cli_refuse_to_run_without_cuda(no_cuda, tmp_path):
    from vdnerf_tpu_torch.cli import main
    from vdnerf_tpu_torch.runner import Runner
    from vdnerf_tpu_torch.utils.device import resolve_device

    conf = str(ROOT / "confs" / "womsk_white_tpu.conf")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Runner(conf, case="none")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--conf", conf, "--case", "none", "--mode", "valimg_0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None, gpu=1)
    assert resolve_device("cpu") == torch.device("cpu")
    assert not os.path.exists(ROOT / "exp" / "none")


def test_cpu_render_runs_plain_versions_and_counts_no_launch():
    from torch_parity import jax_nets, jax_params, port_model, port_nets, rays
    from vdnerf_tpu_torch.data.dataset import near_far_from_sphere
    from vdnerf_tpu_torch.ops.kernels import build
    from vdnerf_tpu_torch.ops.renderer import render

    nets = jax_nets(skip_bg_inside=True)
    model = port_model(nets, jax_params(nets), torch.bfloat16)
    o, d = (torch.from_numpy(a) for a in rays(8))
    build.reset_launches()
    with torch.no_grad():
        out = render(port_nets(nets), model, o, d, *near_far_from_sphere(o, d),
                     perturb_overwrite=0, background_rgb=torch.ones(1, 3))
    assert torch.isfinite(out["color_fine"]).all()
    assert set(build.LAUNCHES) == {"sdf_fwd", "render_fwd", "nerf_fwd", "render_bwd", "nerf_bwd",
                                   "dw_contract", "render_fwd_f32", "nerf_fwd_f32",
                                   "render_bwd_f32", "nerf_bwd_f32", "dw_contract_f32",
                                   "sdf_block"}
    assert not any(build.LAUNCHES.values())
