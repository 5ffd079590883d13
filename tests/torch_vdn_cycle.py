"""Shared set-up of the VDN cycle tool's tests (``test_torch_vdn_cycle*.py``).

- :func:`jax_tool`: ``tools/vdn_cycle_run.py`` loaded by path, as
  ``tests/test_vdn_cycle.py`` loads it (it is a script, not a package module).
- :func:`shrink`: both tools' conf templates at small widths (SDF 4x64,
  colour and depth heads 2x64, background NeRF 2x32, 8+8 samples and 4
  outside, 2 up-sample rounds), so that the conf text the two tools write
  stays equal and small.
"""

from __future__ import annotations

import importlib.util
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = [("D = 8", "D = 2"), ("W = 256", "W = 32"), ("multires = 10", "multires = 4"),
         ("d_out = 257", "d_out = 65"), ("d_hidden = 256", "d_hidden = 64"),
         ("n_layers = 8", "n_layers = 4"), ("skip_in = [4]", "skip_in = [2]"),
         ("d_feature = 256", "d_feature = 64"),
         ("n_layers = 4\n        weight_norm", "n_layers = 2\n        weight_norm"),
         ("n_samples = 64", "n_samples = 8"), ("n_importance = 64", "n_importance = 8"),
         ("n_outside = 32", "n_outside = 4"), ("up_sample_steps = 4", "up_sample_steps = 2")]


def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "vdn_cycle_run", os.path.join(ROOT, "tools", "vdn_cycle_run.py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def small_templates(module) -> tuple[str, str]:
    """(BASE_CONF, DEPTH_BLOCK) of ``module`` at small widths."""
    base, depth = module.BASE_CONF, module.DEPTH_BLOCK
    for old, new in SMALL:
        assert old in base, old
        base = base.replace(old, new)
        depth = depth.replace(old, new)
    return base, depth


def shrink(monkeypatch, *modules) -> None:
    for m in modules:
        base, depth = small_templates(m)
        monkeypatch.setattr(m, "BASE_CONF", base)
        monkeypatch.setattr(m, "DEPTH_BLOCK", depth)
