"""Synthetic scene generator: analytically rendered scenes in the reference's
on-disk layout.

Counterpart of ``vdnerf_tpu/data/synthetic.py``, whose numpy half it copies
(so both packages write byte-identical scenes): ``<data_dir>/<img_dir>/*.png``
images plus a ``cameras_sphere.npz`` with per-image ``world_mat_<stem>`` /
``scale_mat_<stem>`` keys (and, for the textured-backdrop scenes, dummy
``mask/`` and the true object masks under ``eval_mask/``), and the conf
template the CPU rehearsals train on.

Scenes: :func:`make_synthetic_scene`, a normal-coloured sphere; and
:func:`make_compound_scene`, one of the analytic geometries of
:data:`GEOMETRIES` (``compound``: sphere + torus + bump; ``arch``: slab +
pillars + beam + knob) shaded ``fixed``, ``camlight`` or ``glossy``, on a
white or a textured backdrop. Ground-truth geometry is known in closed form:
each geometry's SDF is given in numpy (the renderer's) and in torch on any
device (the Chamfer ground truth of ``mesh/qc.py``), with the same constants.
"""

from __future__ import annotations

import os

import cv2 as cv
import numpy as np
import torch


def look_at_pose(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """OpenCV-convention c2w (x right, y down, z forward)."""
    forward = target - eye
    forward = forward / np.linalg.norm(forward)
    up_world = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(forward, up_world)) > 0.98:
        up_world = np.array([0.0, 1.0, 0.0])
    right = np.cross(forward, up_world)
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = down
    c2w[:3, 2] = forward
    c2w[:3, 3] = eye
    return c2w


def ray_sphere_hit(
    rays_o: np.ndarray, rays_d: np.ndarray, radius: float
) -> tuple[np.ndarray, np.ndarray]:
    """Nearest positive intersection depth + hit mask, vectorized."""
    b = 2.0 * np.sum(rays_o * rays_d, axis=-1)
    c = np.sum(rays_o**2, axis=-1) - radius**2
    disc = b**2 - 4 * c
    hit = disc > 0
    t = (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0
    hit &= t > 0
    return t, hit


def render_sphere_image(
    c2w: np.ndarray, K: np.ndarray, H: int, W: int, radius: float
) -> tuple[np.ndarray, np.ndarray]:
    """Analytic RGBA render (uint8) + float depth of the normal-colored
    sphere."""
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    p = np.stack([xs, ys, np.ones_like(xs)], axis=-1).astype(np.float64)
    Kinv = np.linalg.inv(K[:3, :3])
    d = p @ Kinv.T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = d @ c2w[:3, :3].T
    o = np.broadcast_to(c2w[:3, 3], d.shape)

    t, hit = ray_sphere_hit(o, d, radius)
    pts = o + d * t[..., None]
    normal = pts / max(radius, 1e-9)
    color = (0.5 + 0.5 * normal).clip(0, 1)
    rgba = np.zeros((H, W, 4), dtype=np.uint8)
    rgba[..., :3] = (color * 255).astype(np.uint8)
    rgba[..., :3][~hit] = 255
    rgba[..., 3] = (hit * 255).astype(np.uint8)
    depth = np.where(hit, t, 0.0).astype(np.float32)
    return rgba, depth


def make_synthetic_scene(
    out_dir: str,
    n_images: int = 8,
    H: int = 64,
    W: int = 64,
    radius: float = 0.5,
    cam_dist: float = 3.0,
    focal: float = 80.0,
    img_dir: str = "image",
) -> dict:
    """Write a full synthetic scene; returns its metadata dict."""
    img_path = os.path.join(out_dir, img_dir)
    os.makedirs(img_path, exist_ok=True)

    K = np.eye(4, dtype=np.float64)
    K[0, 0] = K[1, 1] = focal
    K[0, 2] = W / 2.0
    K[1, 2] = H / 2.0

    cam_npz = {}
    rng = np.random.default_rng(7)
    poses = []
    for i in range(n_images):
        # spiral of viewpoints, poles avoided
        theta = 2 * np.pi * i / n_images
        phi = np.pi / 2 + (rng.uniform(-0.5, 0.5))
        eye = cam_dist * np.array(
            [np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi),
             np.cos(phi)]
        )
        c2w = look_at_pose(eye, np.zeros(3))
        poses.append(c2w)
        rgba, _ = render_sphere_image(c2w, K, H, W, radius)
        stem = f"{i:03d}"
        cv.imwrite(os.path.join(img_path, f"{stem}.png"), rgba)

        w2c = np.linalg.inv(c2w)
        world_mat = (K @ w2c).astype(np.float32)
        cam_npz[f"world_mat_{stem}"] = world_mat
        cam_npz[f"scale_mat_{stem}"] = np.eye(4, dtype=np.float32)

    np.savez(os.path.join(out_dir, img_dir, "cameras_sphere.npz"), **cam_npz)
    # also at the data_dir root (conf convention: IMG_DIR/cameras_sphere.npz)
    np.savez(os.path.join(out_dir, "cameras_sphere.npz"), **cam_npz)
    return {
        "data_dir": out_dir,
        "img_dir": img_dir,
        "n_images": n_images,
        "H": H,
        "W": W,
        "radius": radius,
        "poses": np.stack(poses),
        "K": K,
    }


# -- compound scene: a nontrivial analytic SDF (sphere + torus + bump) -------


# Compound-scene geometry (single source of truth for BOTH the numpy scene
# renderer and the torch Chamfer ground truth — keep in sync by construction)
COMPOUND_SPHERE_R = 0.35
COMPOUND_TORUS_R = 0.55
COMPOUND_TORUS_r = 0.12
COMPOUND_BUMP_C = (0.0, 0.0, 0.45)
COMPOUND_BUMP_R = 0.18


def compound_sdf(pts: np.ndarray) -> np.ndarray:
    """Exact union SDF of a sphere, an xy-plane torus, and a top bump.

    Everything fits in the unit sphere. Used as ground truth for the
    flagship-scale convergence run (Chamfer against a 512^3 extraction of
    this field).
    """
    p = np.asarray(pts, dtype=np.float64)
    sphere = np.linalg.norm(p, axis=-1) - COMPOUND_SPHERE_R
    q = np.stack(
        [np.linalg.norm(p[..., :2], axis=-1) - COMPOUND_TORUS_R, p[..., 2]],
        axis=-1,
    )
    torus = np.linalg.norm(q, axis=-1) - COMPOUND_TORUS_r
    bump = (
        np.linalg.norm(p - np.array(COMPOUND_BUMP_C), axis=-1)
        - COMPOUND_BUMP_R
    )
    return np.minimum(np.minimum(sphere, torus), bump)


def compound_sdf_torch(pts: torch.Tensor) -> torch.Tensor:
    """torch twin of :func:`compound_sdf` (same constants) on ``pts``' device
    and dtype, e.g. for the Chamfer ground-truth grid."""
    sphere = torch.linalg.norm(pts, dim=-1) - COMPOUND_SPHERE_R
    q = torch.stack(
        [torch.linalg.norm(pts[..., :2], dim=-1) - COMPOUND_TORUS_R,
         pts[..., 2]],
        dim=-1,
    )
    torus = torch.linalg.norm(q, dim=-1) - COMPOUND_TORUS_r
    bump = (
        torch.linalg.norm(pts - pts.new_tensor(COMPOUND_BUMP_C), dim=-1)
        - COMPOUND_BUMP_R
    )
    return torch.minimum(torch.minimum(sphere, torus), bump)


# -- second analytic geometry: "arch" (slab + two pillars + beam + knob) -----
#
# A qualitatively different shape family from the compound scene: an arch
# with a genuine see-through opening between the pillars and a concave
# under-beam region (overhang), plus an off-axis knob that breaks the x/y
# symmetries. Union of EXACT primitive SDFs (rounded box, capsules, sphere),
# so min() is the exact union distance outside the surface — the same
# property the compound scene relies on for sphere tracing and for the
# Chamfer ground-truth zero set. Everything fits well inside the unit
# sphere (max extent ~0.75).

ARCH_SLAB_C = (0.0, 0.0, -0.32)
ARCH_SLAB_B = (0.46, 0.30, 0.07)  # half-extents before rounding
ARCH_SLAB_ROUND = 0.04
ARCH_PILLAR_R = 0.11
ARCH_PILLAR_A = ((-0.30, 0.0, -0.30), (-0.30, 0.0, 0.34))
ARCH_PILLAR_B = ((0.30, 0.0, -0.30), (0.30, 0.0, 0.34))
ARCH_BEAM = ((-0.32, 0.0, 0.38), (0.32, 0.0, 0.38))
ARCH_BEAM_R = 0.12
ARCH_KNOB_C = (0.0, -0.24, 0.02)
ARCH_KNOB_R = 0.15


def _capsule_sdf_np(p: np.ndarray, a, b, r: float) -> np.ndarray:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    pa = p - a
    ba = b - a
    h = np.clip((pa @ ba) / float(ba @ ba), 0.0, 1.0)
    return np.linalg.norm(pa - ba * h[..., None], axis=-1) - r


def arch_sdf(pts: np.ndarray) -> np.ndarray:
    """Exact union SDF of the arch scene (see constants above)."""
    p = np.asarray(pts, dtype=np.float64)
    q = np.abs(p - np.asarray(ARCH_SLAB_C)) - np.asarray(ARCH_SLAB_B)
    slab = (
        np.linalg.norm(np.maximum(q, 0.0), axis=-1)
        + np.minimum(np.max(q, axis=-1), 0.0)
        - ARCH_SLAB_ROUND
    )
    pil_a = _capsule_sdf_np(p, *ARCH_PILLAR_A, ARCH_PILLAR_R)
    pil_b = _capsule_sdf_np(p, *ARCH_PILLAR_B, ARCH_PILLAR_R)
    beam = _capsule_sdf_np(p, *ARCH_BEAM, ARCH_BEAM_R)
    knob = (
        np.linalg.norm(p - np.asarray(ARCH_KNOB_C), axis=-1) - ARCH_KNOB_R
    )
    return np.minimum.reduce([slab, pil_a, pil_b, beam, knob])


def arch_sdf_torch(pts: torch.Tensor) -> torch.Tensor:
    """torch twin of :func:`arch_sdf` (same constants)."""

    def capsule(a, b, r):
        a = pts.new_tensor(a)
        b = pts.new_tensor(b)
        pa = pts - a
        ba = b - a
        h = torch.clamp((pa @ ba) / (ba @ ba), 0.0, 1.0)
        return torch.linalg.norm(pa - ba * h[..., None], dim=-1) - r

    q = torch.abs(pts - pts.new_tensor(ARCH_SLAB_C)) - pts.new_tensor(ARCH_SLAB_B)
    slab = (
        torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1)
        + torch.clamp(torch.amax(q, dim=-1), max=0.0)
        - ARCH_SLAB_ROUND
    )
    knob = (
        torch.linalg.norm(pts - pts.new_tensor(ARCH_KNOB_C), dim=-1)
        - ARCH_KNOB_R
    )
    return torch.minimum(
        torch.minimum(
            torch.minimum(slab, capsule(*ARCH_PILLAR_A, ARCH_PILLAR_R)),
            torch.minimum(
                capsule(*ARCH_PILLAR_B, ARCH_PILLAR_R),
                capsule(*ARCH_BEAM, ARCH_BEAM_R),
            ),
        ),
        knob,
    )


# name -> (numpy sdf, torch sdf): the single lookup the scene renderer and
# the flagship QC ground truth share.
GEOMETRIES = {
    "compound": (compound_sdf, compound_sdf_torch),
    "arch": (arch_sdf, arch_sdf_torch),
}


def _compound_normal(
    pts: np.ndarray, eps: float = 1e-4, sdf=compound_sdf
) -> np.ndarray:
    n = np.stack(
        [
            sdf(pts + np.eye(3)[i] * eps)
            - sdf(pts - np.eye(3)[i] * eps)
            for i in range(3)
        ],
        axis=-1,
    )
    return n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12)


def _sphere_trace(
    rays_o: np.ndarray, rays_d: np.ndarray, t0: float, t1: float,
    n_steps: int = 192, eps: float = 5e-5, sdf=compound_sdf,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized sphere tracing of an exact analytic SDF: (t, hit)."""
    t = np.full(rays_o.shape[:-1], t0, dtype=np.float64)
    hit = np.zeros(rays_o.shape[:-1], dtype=bool)
    active = np.ones_like(hit)
    for _ in range(n_steps):
        pts = rays_o + rays_d * t[..., None]
        d = sdf(pts)
        newly_hit = active & (d < eps)
        hit |= newly_hit
        active &= ~newly_hit
        t = np.where(active, t + np.maximum(d, eps), t)
        active &= t < t1
        if not active.any():
            break
    return t, hit


def backdrop_texture(pts: np.ndarray) -> np.ndarray:
    """View-consistent procedural texture on the backdrop sphere surface.

    Multi-frequency sinusoids of the 3-D hit point: smooth, colorful, and
    rich enough that a background NeRF must actually model it (parallax
    across views disambiguates it from the foreground object).
    """
    p = np.asarray(pts, dtype=np.float64)
    r = np.linalg.norm(p, axis=-1, keepdims=True) + 1e-9
    u = p / r
    c0 = 0.5 + 0.35 * np.sin(3.0 * u[..., 0] + 5.0 * u[..., 2])
    c1 = 0.5 + 0.35 * np.sin(4.0 * u[..., 1] - 2.0 * u[..., 0] + 1.3)
    c2 = 0.5 + 0.35 * np.cos(5.0 * u[..., 2] + 3.0 * u[..., 1] - 0.7)
    stripes = 0.12 * np.sin(17.0 * u[..., 0]) * np.sin(13.0 * u[..., 1])
    return np.clip(np.stack([c0, c1, c2], axis=-1) + stripes[..., None], 0, 1)


def render_compound_image(
    c2w: np.ndarray,
    K: np.ndarray,
    H: int,
    W: int,
    background: str = "white",
    bg_radius: float = 4.0,
    shading: str = "fixed",
    geometry: str = "compound",
) -> np.ndarray:
    """Analytic RGBA render (uint8) of the shaded analytic object.

    geometry selects the analytic SDF family from :data:`GEOMETRIES`
    ('compound' = sphere+torus+bump; 'arch' = slab+pillars+beam+knob, a
    shape with a see-through opening and a concave overhang).

    background='white': miss pixels are pure white (adversarial for
    mask-free training). background='textured': miss rays
    hit a procedurally textured sphere of radius ``bg_radius`` — the
    real-capture-like setting the reference's womsk confs target (textured
    surroundings the background NeRF can model). The alpha channel is the
    object mask in both cases.

    shading='fixed': lambertian from a fixed world light — radiance is a
    function of the surface point alone (multi-view consistent).
    shading='camlight': a light CO-LOCATED with the camera plus a strong
    Blinn-Phong specular lobe — the dynamic-lighting/view-dependent setting
    the VDN paper targets (arXiv 2303.17968: headlamp-style capture causes
    shape-radiance ambiguity that view-dependence normalization resolves;
    reference dpt_runner.py:239-247 is the distillation loss that fixes
    it). With a co-located light, diffuse = n.v and specular = (n.v)^k, so
    the same surface point changes brightness with every camera.
    shading='glossy': a FIXED world light with a sharp Blinn-Phong lobe
    (spec = (n.h)^64): the static-illumination specular setting — highlights
    SLIDE across the surface as the camera moves (the textbook
    shape-radiance-ambiguity stressor, a third view-dependence axis next to
    camlight's global brightness modulation).
    """
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    p = np.stack([xs, ys, np.ones_like(xs)], axis=-1).astype(np.float64)
    Kinv = np.linalg.inv(K[:3, :3])
    d = p @ Kinv.T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = d @ c2w[:3, :3].T
    o = np.broadcast_to(c2w[:3, 3], d.shape)

    sdf = GEOMETRIES[geometry][0]
    cam_dist = float(np.linalg.norm(c2w[:3, 3]))
    t, hit = _sphere_trace(o, d, cam_dist - 1.0, cam_dist + 1.0, sdf=sdf)
    pts = o + d * t[..., None]
    normal = _compound_normal(pts, sdf=sdf)
    albedo = 0.5 + 0.5 * normal  # normal-colored: real texture everywhere
    if shading == "camlight":
        # view direction from surface point back to the camera == light dir
        v = o - pts
        v /= np.linalg.norm(v, axis=-1, keepdims=True) + 1e-12
        ndv = np.maximum(np.sum(normal * v, axis=-1), 0.0)[..., None]
        spec = (ndv**40)
        color = (albedo * (0.25 + 0.55 * ndv) + 0.55 * spec).clip(0, 1)
    elif shading == "glossy":
        # fixed world light + sharp Blinn-Phong half-vector lobe: the
        # highlight is view-dependent (moves across the surface per camera)
        # while the diffuse term stays multi-view consistent
        light = np.array([0.577, 0.577, 0.577])
        v = o - pts
        v /= np.linalg.norm(v, axis=-1, keepdims=True) + 1e-12
        h = light + v
        h /= np.linalg.norm(h, axis=-1, keepdims=True) + 1e-12
        ndl = np.maximum(normal @ light, 0.0)[..., None]
        ndh = np.maximum(np.sum(normal * h, axis=-1), 0.0)[..., None]
        spec = ndh**64
        color = (albedo * (0.3 + 0.5 * ndl) + 0.7 * spec).clip(0, 1)
    else:
        # lambertian from a fixed world light
        light = np.array([0.577, 0.577, 0.577])
        diffuse = (0.35 + 0.65 * np.maximum(normal @ light, 0.0))[..., None]
        color = (albedo * diffuse).clip(0, 1)
    rgba = np.zeros((H, W, 4), dtype=np.uint8)
    rgba[..., :3] = (color * 255).astype(np.uint8)
    if background == "textured":
        # exact ray / backdrop-sphere intersection (cameras are inside it)
        b = np.sum(o * d, axis=-1)
        t_bg = -b + np.sqrt(
            np.maximum(b * b - (np.sum(o * o, axis=-1) - bg_radius**2), 0.0)
        )
        bg_pts = o + d * t_bg[..., None]
        bg_rgb = (backdrop_texture(bg_pts) * 255).astype(np.uint8)
        rgba[..., :3][~hit] = bg_rgb[~hit]
    else:
        rgba[..., :3][~hit] = 255
    rgba[..., 3] = (hit * 255).astype(np.uint8)
    return rgba


def make_compound_scene(
    out_dir: str,
    n_images: int = 24,
    H: int = 256,
    W: int = 256,
    cam_dist: float = 2.2,
    focal: float | None = None,
    img_dir: str = "image",
    background: str = "white",
    shading: str = "fixed",
    geometry: str = "compound",
) -> dict:
    """Write a nontrivial analytic scene in the reference's on-disk layout.

    Default framing is DTU-like (cam_dist 2.2, focal 1.4*W): the object
    fills most of the frame. Measured with the JAX package: at ~17% frame coverage the
    mask-BCE on the background-dominated ray batches pushes the SDF's zero
    set out of the bbox within ~2k iters (|grad sdf|=1 exactly, empty mesh,
    photometric fit via soft alpha only); at DTU-like coverage the flagship
    schedule converges to a sharp surface (inv_s ~ 2000) reliably.
    """
    if focal is None:
        focal = 1.4 * W
    img_path = os.path.join(out_dir, img_dir)
    os.makedirs(img_path, exist_ok=True)

    K = np.eye(4, dtype=np.float64)
    K[0, 0] = K[1, 1] = focal
    K[0, 2] = W / 2.0
    K[1, 2] = H / 2.0

    textured = background == "textured"
    if textured:
        # womsk layout: 3-channel images (backdrop kept), full-white masks
        # (the reference's mask-free datasets carry dummy masks; the
        # img*mask + (1-mask) composite is then the identity), and the true
        # object masks under eval_mask/ for metrics only.
        os.makedirs(os.path.join(img_path, "mask"), exist_ok=True)
        os.makedirs(os.path.join(img_path, "eval_mask"), exist_ok=True)

    cam_npz = {}
    rng = np.random.default_rng(11)
    poses = []
    for i in range(n_images):
        theta = 2 * np.pi * i / n_images
        phi = np.pi / 2 + rng.uniform(-0.7, 0.7)
        eye = cam_dist * np.array(
            [np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi),
             np.cos(phi)]
        )
        c2w = look_at_pose(eye, np.zeros(3))
        poses.append(c2w)
        rgba = render_compound_image(
            c2w, K, H, W, background=background, shading=shading,
            geometry=geometry,
        )
        stem = f"{i:03d}"
        if textured:
            cv.imwrite(os.path.join(img_path, f"{stem}.png"), rgba[..., :3])
            white = np.full((H, W), 255, np.uint8)
            cv.imwrite(os.path.join(img_path, "mask", f"{stem}.png"), white)
            cv.imwrite(
                os.path.join(img_path, "eval_mask", f"{stem}.png"),
                rgba[..., 3],
            )
        else:
            cv.imwrite(os.path.join(img_path, f"{stem}.png"), rgba)

        w2c = np.linalg.inv(c2w)
        cam_npz[f"world_mat_{stem}"] = (K @ w2c).astype(np.float32)
        cam_npz[f"scale_mat_{stem}"] = np.eye(4, dtype=np.float32)

    np.savez(os.path.join(out_dir, img_dir, "cameras_sphere.npz"), **cam_npz)
    np.savez(os.path.join(out_dir, "cameras_sphere.npz"), **cam_npz)
    return {
        "data_dir": out_dir,
        "img_dir": img_dir,
        "n_images": n_images,
        "H": H,
        "W": W,
        "poses": np.stack(poses),
        "K": K,
        "geometry": geometry,
    }


SYNTHETIC_CONF_TEMPLATE = """\
general {{
    base_exp_dir = {exp_dir}
    recording = []
}}

dataset {{
    data_dir = {data_dir}
    img_dir = {img_dir}
    depth_dir = 00
    render_cameras_name = {img_dir}/cameras_sphere.npz
    object_cameras_name = {img_dir}/cameras_sphere.npz
}}

train {{
    learning_rate = 5e-4
    learning_rate_alpha = 0.05
    end_iter = {end_iter}

    batch_size = {batch_size}
    validate_resolution_level = 2
    warm_up_end = 50
    anneal_end = 100
    use_white_bkgd = True

    save_freq = {save_freq}
    val_freq = {val_freq}
    val_mesh_freq = {val_mesh_freq}
    report_freq = 50

    igr_weight = 0.1
    mask_weight = 0.0
    use_mask = False

    extract_depth = False
    rgb_dims = 3
}}

model {{
    nerf {{
        D = 2,
        d_in = 4,
        d_in_view = 3,
        W = 64,
        multires = 4,
        multires_view = 2,
        output_ch = 4,
        skips = [4],
        rgb_dims = 3,
        use_viewdirs = True,
    }}

    sdf_network {{
        d_out = 65
        d_in = 3
        d_hidden = 64
        n_layers = 4
        skip_in = [2]
        multires = 6
        bias = 0.5
        scale = 1.0
        geometric_init = True
        weight_norm = True
    }}

    variance_network {{
        init_val = 0.3
    }}

    rendering_network {{
        d_feature = 64
        mode = idr
        d_in = 9
        d_out = 3
        d_hidden = 64
        n_layers = 2
        weight_norm = True
        multires_view = 4
        squeeze_out = True
    }}

    neus_renderer {{
        n_samples = 24
        n_importance = 24
        n_outside = 8
        up_sample_steps = 4
        perturb = 1.0
    }}
}}
"""


def write_synthetic_conf(
    path: str,
    data_dir: str,
    exp_dir: str,
    img_dir: str = "image",
    end_iter: int = 200,
    batch_size: int = 128,
    save_freq: int = 100000,
    val_freq: int = 100000,
    val_mesh_freq: int = 100000,
) -> str:
    conf_text = SYNTHETIC_CONF_TEMPLATE.format(
        data_dir=data_dir, exp_dir=exp_dir, img_dir=img_dir,
        end_iter=end_iter, batch_size=batch_size, save_freq=save_freq,
        val_freq=val_freq, val_mesh_freq=val_mesh_freq,
    )
    with open(path, "w") as f:
        f.write(conf_text)
    return path
