"""A copy of the benchmark's files under a temporary root, with every
configuration cut to widths and sizes a CPU test run holds."""

from __future__ import annotations

import json
import os
import shutil

from vdnbench.harness import HOME

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def shrink(config: dict) -> dict:
    c = json.loads(json.dumps(config))
    m = c["conf"]["model"]
    m["sdf_network"].update(d_hidden=32, n_layers=4, skip_in=[2], multires=2, d_out=33)
    for head in ("rendering_network", "depth_extract_network"):
        if head in m:
            m[head].update(d_feature=32, d_hidden=32, n_layers=2, multires_view=2)
    if "depth_extract_network" in m:
        m["depth_extract_network"]["d_out"] = 6
        m["nerf"]["dpt_dim"] = 6
    m["nerf"].update(D=4, W=32, skips=[2], multires=3, multires_view=2)
    m["neus_renderer"].update(n_samples=8, n_importance=8, up_sample_steps=2, n_outside=4,
                              n_render_samples=12)
    c["conf"]["train"]["batch_size"] = 16
    c["scene"].update(n_images=4, H=30, W=40, focal=56.0)
    if "feature_hw" in c["scene"]:
        c["scene"]["feature_hw"] = [15, 20]
    return c


def small_root(tmp: str) -> str:
    """``tmp``/BENCHMARK.json and ``tmp``/vdnbench/{configs,traffic,limits,
    metrics}, the configurations shrunk -> ``tmp``."""
    os.makedirs(tmp, exist_ok=True)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp)
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(REPO, HOME, sub), os.path.join(tmp, HOME, sub))
    for name in os.listdir(os.path.join(tmp, HOME, "configs")):
        path = os.path.join(tmp, HOME, "configs", name)
        with open(path) as f:
            config = json.load(f)
        with open(path, "w") as f:
            json.dump(shrink(config), f)
    traffic = os.path.join(tmp, HOME, "traffic", "views_l4.json")
    with open(traffic) as f:
        views = json.load(f)
    views.update(chunk=512, frames_per_pair=6)
    with open(traffic, "w") as f:
        json.dump(views, f)
    return tmp
