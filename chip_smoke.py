"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit.
2. Builds the port's CUDA kernels (K1 sdf_fwd; K2 render_fwd, K3 render_bwd,
   K4 nerf_fwd, K5 nerf_bwd) from the sources in this checkout, one nvcc per
   source, in parallel.
3. Kernel phase: holds each kernel against its plain PyTorch version on the
   card at the full ``confs/womsk_white_tpu.conf`` widths, at the row counts
   one 4096-ray chunk (K1, K2, K4) or one 512-ray training step (K1's ladder,
   K2, K3, K4, K5) gives it plus a ragged tail, and times kernel and plain
   version with CUDA events. ``ms`` is the wrapper's call, as the main path
   makes it (packing the weights and allocating each call); every kernel
   also gives ``kernel_ms``, its launches alone on weights packed once. K2 is
   held at a chunk's rows, and K2 and K3 at a step's rows on each of the three
   core widths (128 samples; 96 resampled at womsk_white_tpu, 64 at
   wmask_tpu), and every kernel of the step also at the rows of a rank's
   256-ray block on two cards (K1 16,384 and 4,096; K2/K3 24,576 and
   16,384; K4/K5 8,448 and 40,960); K2 and K3 with the colour head's 3 outputs and with the depth
   head's 96 (the same net). K4 is held and timed at a chunk's rows and at a
   training step's, K5 at a step's rows without and with the dpt head, both
   also at the learn confs' rows, whose background NeRF runs over all 160
   merged samples (K4 at 81,920 and 655,360, K5 at 81,920, with its d_pts
   and d_views, which feed the camera gradient, printed on their own). K1
   also holds the plain version's division by 100 on the
   card against the kernel's multiply by 0.01f. Then the dW contraction that
   K3 and K5 share, alone on the scratch their launches left (K3's colour and
   depth heads at 65,536 rows, K5 without dpt): held against
   f32 matmuls of the same bf16 operands, two launches bit-identical, timed
   beside its plain version. Every kernel is timed beside its library
   yardstick, which the port never calls: its products alone as
   ``torch.matmul`` calls at its row counts, f32 with TF32 off for K1, bf16
   on pre-rounded operands for the others (a backward with each layer's dX
   and dW products), no epilogue.
4. Slice phase: writes a scene (8 views of 400x300 of a shaded sphere, its
   cameras, and the same cameras with COLMAP-grade noise for the learn
   confs), the conf with only its paths rewritten and a seeded full-width geometric-init
   ``ckpt_000000.pth``, then runs ``valimg_0`` and ``getfeats_0`` through the
   port's CLI on ``cuda`` with the launch counts set to 0 just before and
   read just after; prints each mode's rays/s beside the bf16 mode's
   (``BF16_SERVING_RAYS_S``). Fails if K1 or a split forward was not
   launched, or a bf16 K2-K5 was.

   Every phase from here on runs JAX's default precision unless it says
   otherwise: under the f32 policy with ``VDNERF_FUSED`` unset (the script
   unsets it), K2-K5 and the dW contraction run their split-operand f32 mode
   (``split_gemm_kernel``), and each phase's launch checks count the split
   kernels (``SPLIT_NAMES``) at their launches a call (``SPLIT_PER_CALL``: K2
   9, K3 18, K4 14, K5 29 or 30 with the dpt head, the contraction 2 a
   backward) and fail on any bf16 K2-K5 launch. The bf16 operand mode runs
   in the fused phase (``VDNERF_FUSED=1``, JAX's opt-in), the bf16 phase
   (``train.bf16``), the flagship and the VDN cycle phases, whose tools
   select the bf16 policy.
5. Output check: the summaries are finite, every depth ``.npy`` was written at
   full resolution, and a 512-ray render through the kernels agrees with the
   same render through the plain versions on the CPU (colour 5e-3, the bar
   set for bf16 operands; the f32 value is printed beside it).
6. Training phase: ``--mode train`` through the CLI at full width, 40 steps
   across ``resample_from`` (only the paths and five ``train`` keys
   rewritten, ``val_mesh_freq`` 20) in windows of the conf's
   ``steps_per_call`` (10: the gcd rule leaves it whole), each step a replay
   of the captured step after each program's 3 eager warm-up steps, launch
   counts set to 0 before and read after (fails unless all five kernels ran;
   a replay adds its program's launches as recorded at capture); checks that
   the loop's cadence wrote a 128^3 mesh at steps 20 and 40 with 8 K1
   launches each, finite logged losses, the checkpoints, that every network
   moved, and that ``valimg_40`` from the last checkpoint gives the run's
   closing summary. Then the dispatch check: the same 40 steps again with the
   window's per-step call patched to the eager card step; the logged steps,
   checkpoints, meshes and launch counts must be the same, every logged loss
   within 1e-5 relative and every parameter within 1e-5 relative L2 (the
   differences are printed; both run the same kernels on the same inputs).
   Then times steps per core width, replayed and eager in turns, with the
   device's idle share of one profiled window of each.
   Then the parallel phase (data parallelism on the one card; NCCL refuses
   two ranks on one device): the same 40 steps through ``python -m
   torch.distributed.run --standalone --nproc_per_node=1`` of this script's
   ``--rank-child nccl`` (a NCCL world of 1 through ``cli.main``: the loss
   sums and the one flat gradient all-reduce inside every captured step)
   under ``VDNERF_PROFILE_DIR``: logs and the last checkpoint within 1e-6
   relative of the run above (an all-reduce over one rank is a copy; the
   differences are printed), the same launches, its replayed steps timed
   beside the run above's, the flat all-reduce and one scalar global sum
   timed alone, the trace of steps 11-20 naming every kernel of the step;
   then ``--nproc_per_node=2 ... --rank-child gloo``: two gloo ranks on
   cuda:0, one full-width eager step each on its 256-ray block, against one
   512-ray step here (loss 1e-5 relative, every summed gradient 1e-4
   relative L2; K1-K5 launched on both ranks). The NCCL child also times its
   replayed steps with ``VDNERF_FUSED=1``, beside the default mode's.
7. Gradient check: one full-width step on 128 rays through the kernels on the
   card against the plain versions on the CPU with f32 operands: loss within
   1e-4 relative, every gradient within 2e-3 relative L2 (the ladder's
   amplification of f32 summation order); the same bars on wmask, wdepth,
   learn and wdepth-learn.
8. Mesh phase: ``validate_mesh_40`` through the CLI (512^3, world space,
   ``--mcube_threshold 0.0``) with the launch counts set to 0 before and read
   after (K1 512 times, nothing else), timed by part; the 128^3 grid through
   K1 against the plain grid on the card (1e-4; the two meshes' triangle
   counts within 0.1%, and their Chamfer within 1e-3 of the plain mesh's
   against itself, the floor of its 100,000-point sampling); ``geometry_qc``
   at 512^3 against the scene's radius-0.5 sphere, reported only.
9. Masked phase: phases 6 (without the dispatch check) and 7 again on
   ``confs/wmask_tpu.conf`` (no outside samples, a 64-of-128 resampled core
   at frac 0.25, the mask BCE): K1-K3 must run and K4/K5 never; the
   background NeRF must not move; the mask loss is logged finite. Its steps
   (and wdepth's) are timed in one replayed and one eager window a core,
   unprofiled.
10. Cycle phase (the monodepth side-car between NeuS's first and last
    stage): ``getfeats_40`` through the CLI from phase 6's checkpoint (the
    ``depth_from_sdf`` export, launch counts set to 0 before and read
    after); ``vdnerf_tpu_torch.wavelet.finetune`` at its defaults
    (DenseNet-161, the wavelet decoder, 800^2 inputs, batch 4, from flax's
    initialisation) for 2 epochs over the 8 views (4 steps, each timed by
    CUDA events, every loss finite, one validation with its images, the
    checkpoints); ``wavelet.predict`` on ``image/``: one float32 [1, 96,
    150, 200] file per view under ``image/wavelet_feats/0``, finite and
    nonzero; then the side-car on the card against the same module and
    weights on the CPU: DenseNet-161's five eval taps at one 256^2 image
    (1e-4 relative L2 each), and one training-mode step's loss and encoder
    gradients at a batch of 2 (1e-3, or 1.5x the CPU's own distance from
    f64), the card's step twice, bit for bit. The whole phase runs under
    deterministic cuDNN (no algorithm timing), so the finetuned weights and
    that gate's numbers repeat from run to run. Prints the step's median
    time after the first, images/s, predict's ms per image, the peak memory
    and the card's name and power limit.
11. wdepth phase: on the features predict wrote, phase 6 on
    ``confs/womsk_white_wdepth_tpu.conf`` at full width (the depth head
    4x256 -> 96, the NeRF's dpt head) with ``depth_start_iter`` 10: K3 must
    be called once a step for the colour head and once more from step 11 on,
    K5 once a step (three programs: the faithful core without and with the
    distillation term, the resampled core with it); the depth loss is logged
    finite and the depth head moves. Its timed steps (after
    depth_start_iter) must launch K2 and K3 twice and
    K4/K5 once each; the gradient check runs past the distillation ramp
    (ramp > 0.99) and holds the depth and dpt heads' gradients too;
    ``getfeats_40`` from the run's checkpoint calls K2 twice per K4 call and
    writes finite full-resolution depths. Then ``depth_before_color`` on the
    same conf (the colour head's features widened by the 96 depth features:
    400 padded inputs), its replayed steps timed: K2 and K3 twice a step.
12. Learn phase: phase 6 on ``confs/womsk_learn_white_colmap.conf`` at full
    width (the poses and the focal learned from the noisy cameras; the
    background NeRF over all 160 samples; one step a window) with
    ``save_freq`` 10 and ``start_refine_pose_iter`` 10, so that both refine
    programs are captured: every ``pnf_<it>.pth`` holds the JAX importer's
    keys, r, t and fx are at their initial values in ``pnf_000010`` and
    have moved by ``pnf_000020``; then the dispatch check on it (r, t and fx
    of ``pnf_000040`` included), the gradient check with the camera
    gradients held too, and the timed steps (after the refine gate).
13. wdepth-learn phase: phase 6 on
    ``confs/womsk_learn_white_wdepth_colmap.conf`` with ``depth_start_iter``
    10 and the cameras refined from step 0, as shipped: K2 twice a step, K3
    once and twice from step 11 on, K4/K5 once; timed steps; the gradient
    check past the distillation ramp with the camera gradients (split K5's
    d_pts/d_views with the dpt head feed them); ``getfeats_40`` through the
    cameras of ``pnf_000040``.
14. Capture and novel-view phase: a binary COLMAP model under
    ``capture/sparse/0`` (one SIMPLE_PINHOLE camera at f = 350 and 400x300,
    the scene's noisy cameras, 300 points around the sphere), then
    ``python -m vdnerf_tpu_torch.colmap.imgs2poses`` (COLMAP skipped) and
    ``...colmap.gen_cameras_cli``: ``poses.npy`` is [8, 3, 5], and each
    ``world_mat_<i> @ scale_mat_<i>`` decomposes to that camera's rotation
    (1e-4) and f = 350 (1e-4 relative); ``showcam_40 -c`` through the CLI on
    phase 12's run with ``dataset.gt_cameras_name`` at the clean cameras:
    init, learned and GT c2w [8, 4, 4], the learned K [4, 4], the learned
    poses moved, a frustum PNG; ``interpolate_0_1 -c`` on phase 6's run
    (fixed cameras, K4 over 33 outside rows a ray) and on phase 12's (learned
    cameras, K4 over all 160 samples), each with the launch counts set to 0
    before and read after: K1, K2 and K4 launch, K2 and K4 called once per
    4096-ray chunk (2 a frame of 100x75, 120 in all), no backward kernel; the video
    decodes to 120 frames of 100x74 (mp4v keeps even sizes); the sweep's
    middle frame (ratio 0.5) through the kernels, every 16th of its rays
    within 5e-3 of the plain versions on the CPU (the bar set for bf16
    operands; the f32 value is printed). Prints each sweep's wall clock,
    frames/s and rays/s beside the bf16 mode's (``BF16_FRAMES_S``).
15. bf16 phase (``train.bf16``, the bf16 SDF block): phase 6's step timing
    on ``womsk_white_tpu`` with ``train.bf16 = true`` (both core widths, one
    replayed and one eager window each, unprofiled); the gradient check of phase 7 with the SDF block
    in bf16 on both sides, the CPU also taking the f32 step: each gradient
    within 2^-6 or 1.5x the CPU bf16 step's own distance from the CPU f32
    step, whichever is larger (both printed).
16. Flagship phase: ``vdnerf_tpu_torch.tools.flagship_run`` at full width on
    its 24 views of 256^2, bf16, 300 steps (``FLAGSHIP_ARGS``), launch
    counts set to 0 before and read after: fails unless every kernel and the
    contraction ran, the masked PSNR at step 300 is above that at step 100,
    and the extracted 256^3 mesh is non-empty with a finite Chamfer distance
    to the analytic surface (the uncleaned mesh's: after 300 steps the
    visual-hull cleaning culls the whole early surface).
17. VDN cycle phase: ``vdnerf_tpu_torch.tools.vdn_cycle_run`` at full width
    on 8 views of 64^2 (``VDN_CYCLE_ARGS``: 100 steps a leg, DenseNet-161
    for one epoch, 128^3 QC meshes), then ``--skip-to-wdepth`` on the same
    ``--out``, launch counts set to 0 before and read after; prints each
    report's summary line and every stage's wall time, peak memory and
    launches (the tool's ``_card.json``). Fails unless K1-K5 and the
    contraction launched in both wdepth legs, and every report value the CPU
    tests hold is present and finite.
18. Split kernel phase (after phase 3): the split-operand f32 mode of K2-K5
    and of the contraction (``split_gemm_kernel``) at full width against the
    plain versions with f32 operands: K2 at a chunk's 393,216 rows and a
    step's 65,536 (3 and 96 outputs), K3 at each core width with 3 and 96
    outputs, K4 at 16,896 and 81,920 rows with and without dpt and at
    655,360, K5 at 16,896 and 81,920 with and without dpt, the contraction on
    seeded layer inputs and deltas; forwards within 1e-4 * max(1,
    max|plain|), backward outputs within 1e-4 relative L2 on the rows with no
    relu near its kink and 1e-2 on every row, two launches bit-identical;
    each timed beside the bf16 mode, the plain version and the f32
    ``torch.matmul`` yardstick (TF32 off).
    Fused phase (after phase 13, ``VDNERF_FUSED=1``: JAX's fused path, the
    opt-in): ``womsk_white_tpu`` trained through the CLI as in phase 6 (bf16
    K2-K5 counted, no split launch), the replayed steps of womsk, wmask,
    wdepth, depth_before_color, learn and wdepth-learn timed beside phases
    6-13's (bf16 K2-K5 once a call, no split launch), and one full-width
    step's gradients against the CPU with bf16 operands (loss 1e-3 relative,
    every gradient 2^-6 relative L2).
19. SDF block phase (after phase 18): the seven elementwise stages of
    ``ops/sdf_block.py`` (``sdfb_*_kernel``) through their wrappers at a
    step's 49,152 rows and a views chunk's 393,216 against their plain
    formulas on the same card tensors (1e-5 relative, 1e-6 of the scale;
    column sums 1e-4 of the largest), each timed beside the plain formula,
    torch's own softplus / sigmoid ops and its bound by bytes; then the whole
    block at full width, a step's forward and backward and a chunk's
    forward, through the Function against autograd's route (1e-4 of each
    output's largest entry; 34 and 17 stage launches), both timed with their
    peak memory. Every training and serving path of the f32 policy must
    launch the stages, and the bf16 policy's (``train.bf16``, flagship,
    vdn_cycle) none.
20. Prints a JSON line of the end-to-end numbers (with each phase's wall
    seconds, ``phase_s``), one ``{"kernels": [...]}``
    line (the five kernels and the contraction, then their split f32 modes,
    then the SDF block's stages under one name, each with its launches by
    path),
    then the last line ``{"ok": true, "device": {...}}``.

Any failure exits non-zero and prints no result. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published dense peaks at the 700 W limit (NVIDIA data sheet)
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_BF16_S = 989e12
PEAK_TF32_S = 495e12

# rows per 4096-ray chunk at womsk_white_tpu: ladder 64 + 3 x 16 per ray
# (the last round's SDF call is skipped at resample_uniform_frac = 1.0), the
# 96-sample resampled core, 32 outside samples + 1 with skip_bg_inside; K1
# also at the ladder's rows of one 512-ray training step
CHUNK = 4096
BATCH = 512
# a rank's block of the batch on two cards (the parallel phase): every kernel
# of the step is also held and timed at its half-batch rows, where a launch's
# fixed costs weigh more
HALF = BATCH // 2
K1_ROWS = (CHUNK * 64, CHUNK * 16, BATCH * 64, BATCH * 16, HALF * 64, HALF * 16)
K2_ROWS = CHUNK * 96
K4_ROWS = CHUNK * 33
RAGGED = 37
# rows per training step (batch 512): the colour head (K2 and K3) over the
# faithful 128-sample core, then over the resampled core after resample_from
# (96 samples at womsk_white_tpu, 64 at wmask_tpu); the background NeRF's
# backward over 32 outside samples + 1
CORE_ROWS = (BATCH * 128, BATCH * 96, BATCH * 64)
K5_ROWS = BATCH * 33
# HALF * 128 is BATCH * 64, held above
HALF_CORE_ROWS = (HALF * 96, HALF * 64)
HALF_K5_ROWS = HALF * 33
# the learn confs run the background NeRF over every one of the 128 + 32
# merged samples (no skip_bg_inside): K4 and K5 at a step's 81,920 rows, K4
# at a serving chunk's 655,360
LEARN_ROWS = BATCH * 160
LEARN_K4_ROWS = CHUNK * 160
HALF_LEARN_ROWS = HALF * 160

# K1 is f32 throughout: the kernel and torch differ in summation order and in
# the last ulp of exp/log1p/sin/cos. K2/K4 round every matmul operand to bf16
# on both sides, so a last-ulp difference upstream can flip one rounding and
# cascade: two bf16 ulps at the output's scale.
K1_TOL = 1e-4


def bf16_tol(ref) -> float:
    return 2.0**-7 * max(1.0, float(ref.abs().max()))


# K3/K5: each output (input cotangents, dW, db) within 2^-6 relative L2
# error of its plain version. Both round every layer's delta to bf16, but in
# another summation order; once a row takes one rounding (or a relu kink) the
# other way its later values drift by ~1e-4 and round differently again, so
# the two differ by about a bf16 ulp (2^-8) times the square root of the
# depth (5 layers for K3, 11 for K5); the point embedding's VJP multiplies
# K5's d(pts) by up to 2^9. The log prints the plain version's own distance
# from its f32-operand twin beside it, the size of that rounding noise.
BWD_L2_TOL = 2.0**-6


REPLACES = {
    "sdf_fwd": "vdnerf_tpu/ops/pallas/sdf_fwd.py:114",
    "render_fwd": "vdnerf_tpu/ops/pallas/fused_mlp.py:272",
    "nerf_fwd": "vdnerf_tpu/ops/pallas/fused_mlp.py:518",
    "render_bwd": "vdnerf_tpu/ops/pallas/fused_mlp.py:314",
    "nerf_bwd": "vdnerf_tpu/ops/pallas/fused_mlp.py:575",
    # the dW half of K3 and K5 (_mm_dw inside _render_kernel_bwd/_nerf_kernel_bwd)
    "dw_contract": "vdnerf_tpu/ops/pallas/fused_mlp.py:112",
    # no pallas_call: XLA's fusions of jax.vjp under the outer grad
    "sdf_block": "vdnerf_tpu/models/fields.py:163",
}
SOURCE = {
    "sdf_fwd": "vdnerf_tpu_torch/ops/kernels/csrc/sdf_fwd.cu",
    "render_fwd": "vdnerf_tpu_torch/ops/kernels/csrc/fused_mlp.cu",
    "nerf_fwd": "vdnerf_tpu_torch/ops/kernels/csrc/fused_mlp.cu",
    "render_bwd": "vdnerf_tpu_torch/ops/kernels/csrc/fused_mlp.cu",
    "nerf_bwd": "vdnerf_tpu_torch/ops/kernels/csrc/fused_mlp.cu",
    "dw_contract": "vdnerf_tpu_torch/ops/kernels/csrc/fused_mlp.cu",
    "sdf_block": "vdnerf_tpu_torch/ops/kernels/csrc/sdf_block.cu",
}

SCENE_VIEWS, SCENE_H, SCENE_W = 8, 300, 400


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(rows: int, flops_row: int, io_bytes_row: int, weight_bytes: int, peak_ops: float):
    """(bound_ms, bound_by): each input read once, each output written once."""
    t_bytes = (rows * io_bytes_row + weight_bytes) / PEAK_BYTES_S
    t_ops = rows * flops_row / peak_ops
    return max(t_bytes, t_ops) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _weights(gen, dims, device, std_from_out=False):
    """Random effective [in, out] weights and small biases."""
    import torch

    ws, bs = [], []
    for k, n in dims:
        std = math.sqrt(2.0 / n) if std_from_out else 1.0 / math.sqrt(k)
        ws.append((torch.randn(k, n, generator=gen) * std).to(device))
        bs.append((torch.randn(n, generator=gen) * 0.05).to(device))
    return ws, bs


def _compare(name, got, want, tol_fn) -> float:
    """Each output against its plain version within tol_fn(plain) -> the
    largest abs error."""
    import torch

    torch.cuda.synchronize()
    pairs = [(g, w) for g, w in zip(got, want) if w is not None]
    err = max(float((g - w).abs().max()) for g, w in pairs)
    tol = max(tol_fn(w) for _, w in pairs)
    finite = all(bool(torch.isfinite(g).all()) for g, _ in pairs)
    scale = max(float(w.abs().max()) for _, w in pairs)
    print(f"[kernel] {name}: rows={pairs[0][1].shape[0]} max_abs_err={err:.3e} "
          f"tol={tol:.3e} max|plain|={scale:.3e} finite={finite}")
    if not finite or not err <= tol:
        raise SystemExit(f"{name}: the kernel disagrees with its plain version")
    return err


def _rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _compare_bwd(name, got, again, want, want32) -> float:
    """A backward kernel's outputs against the plain version within
    BWD_L2_TOL relative L2 error each, and two launches bit for bit equal ->
    the largest abs error. ``want32``: the plain version with f32 operands."""
    import torch

    torch.cuda.synchronize()
    errs, worst = [], (0.0, "")
    for i, (g, a, w, w32) in enumerate(zip(got, again, want, want32)):
        if not bool(torch.isfinite(g).all()) or not torch.equal(g, a):
            raise SystemExit(f"{name} #{i}: not finite, or two launches differ")
        errs.append(float((g - w).abs().max()))
        rel, noise = _rel_l2(g, w), _rel_l2(w, w32)
        worst = max(worst, (rel, f"#{i} {tuple(w.shape)} (plain vs f32 operands {noise:.3e})"))
        if not rel <= BWD_L2_TOL:
            raise SystemExit(f"{name} #{i}: relative L2 error {rel:.3e} > {BWD_L2_TOL:.3e}")
    print(f"[kernel] {name}: rows={want[0].shape[0]} tensors={len(errs)} "
          f"max_abs_err={max(errs):.3e} worst rel L2 error {worst[0]:.3e} at {worst[1]} "
          f"(tol {BWD_L2_TOL:.3e}); two launches bit-identical")
    return max(errs)


def _bwd_runs(kernel, plain, args):
    """(kernel, kernel again, plain with bf16 operands, plain with f32 operands)
    on args."""
    import torch

    return (kernel(*args), kernel(*args), plain(*args, mm=torch.bfloat16),
            plain(*args, mm=torch.float32))


def kernel_phase(device) -> dict:
    """Each kernel against its plain version at full width -> {name: record}."""
    import torch

    from vdnerf_tpu_torch.ops.kernels import fused_mlp, sdf_fwd

    gen = torch.Generator().manual_seed(0)
    rec = {}
    bf16 = torch.bfloat16  # K2-K5's operand mode in this phase

    # K1: SDF 8x256, skip at 4, multires 6 -> 39-ch embedding; sdf column only
    sdf_dims = [(39, 256), (256, 256), (256, 256), (256, 217)] + [(256, 256)] * 4 + [(256, 1)]
    ws, bs = _weights(gen, sdf_dims, device, std_from_out=True)
    sdf_args = (ws, bs, (4,), 6, 1.0)
    flops_row = 2 * sum(k * n for k, n in sdf_dims)
    wbytes = sum(w.numel() + b.numel() for w, b in zip(ws, bs)) * 4
    errs, shapes = [], []
    for rows in K1_ROWS:
        pts = (torch.rand(rows + RAGGED, 3, generator=gen) * 2 - 1).to(device)
        errs.append(_compare("sdf_fwd", [sdf_fwd.sdf_value(pts, *sdf_args)],
                             [sdf_fwd.sdf_value_plain(pts, *sdf_args)], lambda _: K1_TOL))
        pts = pts[:rows].contiguous()
        # the launch alone, on weights packed once
        W, B, meta = sdf_fwd._sdf_kernel_args(pts, *sdf_args[:4])
        out = torch.empty(rows, 1, device=device)
        # the kernel runs 3xTF32: three tensor-core products per f32 product
        b_ms, b_by = bound(rows, 3 * flops_row, (3 + 1) * 4, wbytes, PEAK_TF32_S)
        f32_ms, _ = bound(rows, flops_row, (3 + 1) * 4, wbytes, PEAK_F32_S)
        shapes.append({
            "rows": rows,
            "ms": time_ms(lambda: sdf_fwd.sdf_value(pts, *sdf_args)),
            "kernel_ms": time_ms(lambda: sdf_fwd._sdf_launch(pts, out, W, B, meta, 1.0)),
            "plain_ms": time_ms(lambda: sdf_fwd.sdf_value_plain(pts, *sdf_args)),
            "library_ms": _time_products(sdf_dims, rows, torch.float32, device),
            "library": "products only: nine f32 torch.matmul, TF32 off",
            "bound_ms": b_ms, "bound_by": b_by, "bound_f32_simt_ms": f32_ms,
        })
    # The kernel's softplus ends with a multiply by 0.01f where the plain
    # version divides by the Python float 100.0: on a CUDA tensor torch runs
    # that division as a multiply by the f32 reciprocal. Held bit for bit
    # here, beside how often a true IEEE division would differ.
    v = (torch.randn(1 << 20, generator=gen) * torch.exp(torch.rand(1 << 20, generator=gen) * -95
                                                          + 5)).to(device)
    as_plain = v / 100.0
    same = torch.equal(as_plain, v * torch.tensor(0.01, device=device))
    n_div = int((as_plain != torch.div(v, torch.full_like(v, 100.0))).sum())
    print(f"[kernel] sdf_fwd softplus scaling: torch's x / 100.0 on the card equals x * 0.01f "
          f"bit for bit: {same}; a true division differs at {n_div} of {v.numel()}")
    rec["sdf_fwd"] = {"max_abs_err": max(errs), "flops_row": flops_row, "shapes": shapes,
                      "plain_div_is_mul_by_0.01f": same}

    # K2: IDR colour head, 4x256, multires_view 4 -> 3 + 27 + 3 + 256 = 289 inputs;
    # the wdepth recipe's depth head is the same net with 96 outputs
    r_dims = [(289, 256), (256, 256), (256, 256), (256, 256), (256, 3)]
    ws, bs = _weights(gen, r_dims, device)
    ws96, bs96 = _weights(gen, [(256, 96)], device)
    ws96, bs96 = ws[:4] + ws96, bs[:4] + bs96
    plan = ("idr", 4, True)

    def r_inputs(rows):
        t = [torch.randn(rows, 3, generator=gen) for _ in range(3)]
        t[2] = t[2] / t[2].norm(dim=-1, keepdim=True)
        feat = torch.randn(rows, 256, generator=gen) * 0.5
        return [x.to(device) for x in (*t, feat)]

    flops_row = 2 * sum(k * n for k, n in r_dims)
    wbytes = sum(w.numel() * 2 + b.numel() * 4 for w, b in zip(ws, bs))
    packed = fused_mlp._render_pack(plan, r_inputs(1)[3], ws, bs, device)
    packed96 = fused_mlp._render_pack(plan, r_inputs(1)[3], ws96, bs96, device)
    errs, shapes = [], []
    for rows in (K2_ROWS, *CORE_ROWS, *HALF_CORE_ROWS):
        inp = r_inputs(rows + RAGGED)
        for w_, b_ in ((ws, bs), (ws96, bs96)):
            errs.append(_compare(
                f"render_fwd(rows={rows + RAGGED}, d_out={w_[-1].shape[1]})",
                [fused_mlp.render_net(plan, *inp, w_, b_, bf16)],
                [fused_mlp.render_net_plain(plan, *inp, w_, b_, mm=bf16)], bf16_tol))
        inp = [x[:rows].contiguous() for x in inp]
        b_ms, b_by = bound(rows, flops_row, (3 + 3 + 3 + 256 + 3) * 4, wbytes, PEAK_BF16_S)
        shapes.append({
            "rows": rows,
            "ms": time_ms(lambda: fused_mlp.render_net(plan, *inp, ws, bs, bf16)),
            # the launch alone, on weights packed once
            "kernel_ms": time_ms(lambda: fused_mlp._render_fwd_run(*inp, packed)),
            "kernel_ms_d_out_96": time_ms(lambda: fused_mlp._render_fwd_run(*inp, packed96)),
            "plain_ms": time_ms(lambda: fused_mlp.render_net_plain(plan, *inp, ws, bs, mm=bf16)),
            "library_ms": _time_products(r_dims, rows, torch.bfloat16, device),
            "library": BF16_PRODUCTS,
            "bound_ms": b_ms, "bound_by": b_by,
        })
    rec["render_fwd"] = {"max_abs_err": max(errs), "flops_row": flops_row, "shapes": shapes}

    # K4: background NeRF 8x256, skip after 4, d_in 4 multires 10 (84 ch),
    # views multires 4 (27 ch); heads alpha, feature, views0, rgb[, dpt 96]
    t_dims = [(84, 256)] + [(256, 256)] * 4 + [(340, 256)] + [(256, 256)] * 2
    tw, tb = _weights(gen, t_dims, device)
    h_dims = [(256, 1), (256, 256), (283, 128), (128, 3), (128, 96)]
    hw, hb = _weights(gen, h_dims, device)

    def n_inputs(rows):
        p = torch.randn(rows, 3, generator=gen)
        p = p / p.norm(dim=-1, keepdim=True)
        inv_r = torch.rand(rows, 1, generator=gen)
        v = torch.randn(rows, 3, generator=gen)
        v = v / v.norm(dim=-1, keepdim=True)
        return torch.cat([p, inv_r], -1).to(device), v.to(device)

    # K4 at a serving chunk's rows and at a training step's outside rows: held
    # with and without the dpt head at those rows plus a ragged tail, timed
    # without it on the first rows of the same inputs
    nplan = (10, 4, (4,), 8, False)
    flops_row = 2 * (sum(k * n for k, n in t_dims) + sum(k * n for k, n in h_dims[:4]))
    wbytes = sum(w.numel() * 2 + b.numel() * 4 for w, b in zip(tw + hw[:4], tb + hb[:4]))
    packed = fused_mlp._nerf_pack(nplan, 4, tw, tb, hw[:4], hb[:4], device)
    errs, shapes = [], []
    for rows in (K4_ROWS, K5_ROWS, LEARN_ROWS, LEARN_K4_ROWS, HALF_K5_ROWS, HALF_LEARN_ROWS):
        pts4, views = n_inputs(rows + RAGGED)
        for has_dpt in (False, True):
            dplan = (10, 4, (4,), 8, has_dpt)
            heads = (hw, hb) if has_dpt else (hw[:4], hb[:4])
            errs.append(_compare(
                f"nerf_fwd(rows={rows + RAGGED}, has_dpt={has_dpt})",
                list(fused_mlp.nerf(dplan, pts4, views, tw, tb, *heads, bf16)),
                list(fused_mlp.nerf_plain(dplan, pts4, views, tw, tb, *heads, mm=bf16)), bf16_tol))
        pts4, views = (x[:rows].contiguous() for x in (pts4, views))
        b_ms, b_by = bound(rows, flops_row, (4 + 3 + 1 + 3) * 4, wbytes, PEAK_BF16_S)
        shapes.append({
            "rows": rows,
            "ms": time_ms(lambda: fused_mlp.nerf(nplan, pts4, views, tw, tb, hw[:4], hb[:4],
                                                 bf16)),
            # the launch alone, on weights packed once
            "kernel_ms": time_ms(lambda: fused_mlp._nerf_fwd_run(pts4, views, packed, False)),
            "plain_ms": time_ms(lambda: fused_mlp.nerf_plain(nplan, pts4, views, tw, tb, hw[:4],
                                                             hb[:4], mm=bf16)),
            "library_ms": _time_products(t_dims + h_dims[:4], rows, torch.bfloat16, device),
            "library": BF16_PRODUCTS,
            "bound_ms": b_ms, "bound_by": b_by,
        })
    rec["nerf_fwd"] = {"max_abs_err": max(errs), "flops_row": flops_row, "shapes": shapes}

    # K3: the colour head's backward at each of a training step's core rows,
    # then the wdepth recipe's depth head's (d_out 96) at the same rows. A
    # backward recomputes the forward, then runs dx and dW products: three
    # times the forward's operations. Bytes: the inputs and g read once, the
    # input cotangents written once, bf16 weights read, f32 dW/db written.
    def flat(grads):
        return [t for x in grads for t in (x if isinstance(x, list) else [x])]

    errs, shapes, sc3 = [], [], {}
    for d_out, hw_, hb_ in ((3, ws, bs), (96, ws96, bs96)):
        dims = r_dims[:4] + [(256, d_out)]
        flops_row = 3 * 2 * sum(k * n for k, n in dims)
        wbytes = sum(w.numel() * 2 + b.numel() * 4 + (w.numel() + b.numel()) * 4
                     for w, b in zip(hw_, hb_))
        for rows in (*CORE_ROWS, *HALF_CORE_ROWS):
            inp = r_inputs(rows + RAGGED)
            g = torch.randn(rows + RAGGED, d_out, generator=gen).to(device)
            errs.append(_compare_bwd(
                f"render_bwd(rows={rows + RAGGED}, d_out={d_out})", *(flat(x) for x in _bwd_runs(
                    fused_mlp._render_bwd_launch, fused_mlp.render_net_bwd_plain,
                    (plan, *inp, hw_, hb_, g)))))
            inp, g = [x[:rows].contiguous() for x in inp], g[:rows].contiguous()
            b_ms, b_by = bound(rows, flops_row, (3 * 3 + 256 + d_out + 3 * 3 + 256) * 4, wbytes,
                               PEAK_BF16_S)
            # the launches alone (tile kernel, then the contraction), on weights
            # packed and scratch allocated once
            W, B, meta = fused_mlp._render_meta(plan, inp[3], hw_, hb_, device)
            sc = sc3[(rows, d_out)] = fused_mlp._BwdScratch(rows, meta, device)
            outs = [torch.empty_like(x) for x in inp]

            def k3_launches():
                fused_mlp._render_bwd_tile((*inp, g), outs, W, B, meta, sc)
                sc.contract()

            shapes.append({
                "rows": rows, "d_out": d_out,
                "ms": time_ms(lambda: fused_mlp._render_bwd_launch(plan, *inp, hw_, hb_, g)),
                "kernel_ms": time_ms(k3_launches),
                "plain_ms": time_ms(lambda: fused_mlp.render_net_bwd_plain(plan, *inp, hw_, hb_,
                                                                           g, mm=bf16)),
                "library_ms": _time_products(dims, rows, torch.bfloat16, device, backward=True),
                "library": BF16_PRODUCTS + ", with each layer's dX and dW products",
                "bound_ms": b_ms, "bound_by": b_by, "flops_row": flops_row,
            })
    # the colour head under depth_before_color: 289 + 96 = 385 inputs, 400
    # padded, K2 on its 3-stage ring, then K3, at a step's faithful core
    wd, bd = _weights(gen, [(385, 256)], device)
    wd, bd = wd + ws[1:], bd + bs[1:]
    inp = r_inputs(CORE_ROWS[0] + RAGGED)
    inp[3] = torch.cat([inp[3], torch.rand(inp[3].shape[0], 96, generator=gen).to(device)], -1)
    stages = fused_mlp.render_ring_stages(fused_mlp._render_meta(plan, inp[3], wd, bd, device)[2])
    errs.append(_compare(f"render_fwd(rows={CORE_ROWS[0] + RAGGED}, 400 padded inputs, "
                         f"{stages} ring stages)", [fused_mlp.render_net(plan, *inp, wd, bd, bf16)],
                         [fused_mlp.render_net_plain(plan, *inp, wd, bd, mm=bf16)], bf16_tol))
    g = torch.randn(CORE_ROWS[0] + RAGGED, 3, generator=gen).to(device)
    errs.append(_compare_bwd(
        f"render_bwd(rows={CORE_ROWS[0] + RAGGED}, 400 padded inputs)", *(flat(x) for x in _bwd_runs(
            fused_mlp._render_bwd_launch, fused_mlp.render_net_bwd_plain, (plan, *inp, wd, bd, g)))))
    if stages != 3:
        raise SystemExit(f"render_fwd at 400 padded inputs: {stages} ring stages, expected 3")
    inp = [x[:CORE_ROWS[0]].contiguous() for x in inp]
    rec["render_fwd"]["depth_before_color"] = {
        "rows": CORE_ROWS[0], "stages": stages,
        "ms": time_ms(lambda: fused_mlp.render_net(plan, *inp, wd, bd, bf16)),
        "plain_ms": time_ms(lambda: fused_mlp.render_net_plain(plan, *inp, wd, bd, mm=bf16))}
    print(f"[kernel] render_fwd at 400 padded inputs: {rec['render_fwd']['depth_before_color']}")
    rec["render_bwd"] = {"max_abs_err": max(errs), "flops_row": shapes[0]["flops_row"],
                         "shapes": shapes}

    # K5: the background NeRF's backward at one training step's outside rows,
    # without the dpt head (womsk_white_tpu) and with it (the wdepth recipe)
    # (and at the learn confs' 81,920 rows, where its input cotangents d_pts
    # and d_views feed the camera gradient, each held and printed on its own)
    errs, shapes = [], []
    for rows, has_dpt in ((K5_ROWS, False), (K5_ROWS, True), (LEARN_ROWS, False),
                          (LEARN_ROWS, True), (HALF_K5_ROWS, False), (HALF_K5_ROWS, True),
                          (HALF_LEARN_ROWS, False), (HALF_LEARN_ROWS, True)):
        nplan = (10, 4, (4,), 8, has_dpt)
        heads = (hw, hb) if has_dpt else (hw[:4], hb[:4])
        dims = t_dims + (h_dims if has_dpt else h_dims[:4])
        pts4, views = n_inputs(rows + RAGGED)
        gs = [torch.randn(rows + RAGGED, k, generator=gen).to(device)
              for k in ((1, 3, 96) if has_dpt else (1, 3))]
        runs = [flat(x) for x in _bwd_runs(fused_mlp._nerf_bwd_launch, fused_mlp.nerf_bwd_plain,
                                           (nplan, pts4, views, tw, tb, *heads, *gs))]
        name = f"nerf_bwd(rows={rows + RAGGED}, has_dpt={has_dpt})"
        errs.append(_compare_bwd(name, *runs))
        for i, what in ((0, "d_pts"), (1, "d_views")):
            print(f"[kernel] {name} {what}: rel L2 error {_rel_l2(runs[0][i], runs[2][i]):.3e} "
                  f"(tol {BWD_L2_TOL:.3e}), max abs err "
                  f"{float((runs[0][i] - runs[2][i]).abs().max()):.3e}")
        pts4, views = (x[:rows].contiguous() for x in (pts4, views))
        gs = [x[:rows].contiguous() for x in gs]
        nargs = (nplan, pts4, views, tw, tb, *heads)
        flops_row = 3 * 2 * sum(k * n for k, n in dims)
        wbytes = sum(w.numel() * 6 + b.numel() * 8 for w, b in zip(tw + heads[0], tb + heads[1]))
        b_ms, b_by = bound(rows, flops_row, (4 + 3 + 1 + 3 + (96 if has_dpt else 0) + 4 + 3) * 4,
                           wbytes, PEAK_BF16_S)
        k5_packed = fused_mlp._nerf_pack(nplan, 4, tw, tb, *heads, device)
        sc = fused_mlp._BwdScratch(rows, k5_packed[2], device)
        if (rows, has_dpt) == (K5_ROWS, False):
            sc5 = sc  # the contraction below is held on womsk_white_tpu's K5 scratch
        outs = [torch.empty_like(pts4), torch.empty_like(views)]
        # without the dpt head the kernel never reads the g_dpt slot
        tile_ins = (pts4, views, *gs) if has_dpt else (pts4, views, *gs, gs[1])

        def k5_launches():
            fused_mlp._nerf_bwd_tile(tile_ins, outs, k5_packed, sc)
            sc.contract()

        shapes.append({
            "rows": rows, "has_dpt": has_dpt,
            "ms": time_ms(lambda: fused_mlp._nerf_bwd_launch(*nargs, *gs)),
            "kernel_ms": time_ms(k5_launches),
            "plain_ms": time_ms(lambda: fused_mlp.nerf_bwd_plain(*nargs, *gs, mm=bf16)),
            "library_ms": _time_products(dims, rows, torch.bfloat16, device, backward=True),
            "library": BF16_PRODUCTS + ", with each layer's dX and dW products",
            "bound_ms": b_ms, "bound_by": b_by, "flops_row": flops_row,
        })
    rec["nerf_bwd"] = {"max_abs_err": max(errs), "flops_row": shapes[0]["flops_row"],
                       "shapes": shapes}

    # the dW contraction alone (dw_kernel + the two fixed-order reductions), on
    # the scratch the timed K3 (colour and depth head) and K5 launches left
    errs, shapes = [], []
    for rows, sc in ((CORE_ROWS[0], sc3[(CORE_ROWS[0], 3)]), (CORE_ROWS[0], sc3[(CORE_ROWS[0], 96)]),
                     (K5_ROWS, sc5)):
        errs.append(_check_contraction(sc, rows))
        shapes.append(_time_contraction(sc, rows))
    rec["dw_contract"] = {"max_abs_err": max(errs), "flops_row": shapes[0]["flops_row"],
                          "shapes": shapes}
    return rec


BF16_PRODUCTS = "products only: one bf16 torch.matmul per layer on pre-rounded operands"


def _time_products(dims, rows, dtype, device, backward=False) -> float:
    """The library yardstick of every kernel: its products alone, one
    ``torch.matmul`` per layer on operands made in ``dtype`` beforehand, with
    no bias, activation, concat or embedding. A backward adds each layer's dX
    (delta @ W^T) and dW (act^T @ delta) products. The port never calls it."""
    import torch

    ops = []
    for k, n in dims:
        a = torch.randn(rows, k, device=device).to(dtype)
        w = torch.randn(k, n, device=device).to(dtype)
        ops.append((a, w))
        if backward:
            d = torch.randn(rows, n, device=device).to(dtype)
            ops += [(d, w.t()), (a.t(), d)]
    return time_ms(lambda: [torch.matmul(a, b) for a, b in ops])


def _contraction_operands(sc):
    """Per layer (acts_l [rows, Kp], dels_l [rows, Np]) views of a backward's
    scratch, and where the layer's dW sits in the packed result."""
    out, aoff, doff = [], 0, 0
    for _, _, Kp, Np, woff, _ in sc.layers:
        out.append((sc.acts[:, aoff:aoff + Kp], sc.dels[:, doff:doff + Np], woff))
        aoff, doff = aoff + Kp, doff + Np
    return out


def _contraction_plain(sc):
    """The contraction's plain version: f32 products of the same bf16
    operands, one matmul per layer."""
    return [a.float().t() @ d.float() for a, d, _ in _contraction_operands(sc)]


def _check_contraction(sc, rows) -> float:
    """dW of every layer within 2^-12 relative L2 of the plain version (f32
    sums of the same bf16 products in another order), and two launches of
    the contraction bit-identical -> the largest abs error."""
    import torch

    sc.contract()
    first = sc.dW.clone()
    sc.contract()
    torch.cuda.synchronize()
    if not torch.equal(first, sc.dW):
        raise SystemExit("dw_contract: two launches differ")
    errs, worst = [], 0.0
    for (a, d, woff), want in zip(_contraction_operands(sc), _contraction_plain(sc)):
        got = sc.dW[woff:woff + want.numel()].view_as(want)
        errs.append(float((got - want).abs().max()))
        worst = max(worst, _rel_l2(got, want))
    print(f"[kernel] dw_contract: rows={rows} layers={len(errs)} max_abs_err={max(errs):.3e} "
          f"worst rel L2 error {worst:.3e} (tol {2.0**-12:.3e}); two launches bit-identical")
    if not worst <= 2.0**-12:
        raise SystemExit("dw_contract: the contraction disagrees with its plain version")
    return max(errs)


def _time_contraction(sc, rows) -> dict:
    """CUDA-event times of the contraction alone, its plain version and the
    library yardstick (one bf16 torch.matmul per layer), and its bound: the
    acts/dels read once and dW written once over the memory rate, against
    the bf16 products over the bf16 peak."""
    import torch

    ops = _contraction_operands(sc)
    macs = sum(a.shape[1] * d.shape[1] for a, d, _ in ops)
    io = rows * (sc.acts.shape[1] + sc.dels.shape[1]) * 2 + sc.dW.numel() * 4
    b_ms, b_by = bound(rows, 2 * macs, 0, io, PEAK_BF16_S)
    return {
        "rows": rows, "flops_row": 2 * macs,
        "ms": time_ms(sc.contract),
        "plain_ms": time_ms(lambda: _contraction_plain(sc)),
        "library_ms": time_ms(lambda: [torch.matmul(a.t(), d) for a, d, _ in ops]),
        "bound_ms": b_ms, "bound_by": b_by,
    }


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------


def _look_at(eye):
    import numpy as np

    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(fwd, right), fwd, eye
    return c2w


def write_scene(data_dir: str):
    """8 RGBA views of a Lambertian sphere of radius 0.5 from a ring at
    distance 3, with ``image/cameras_sphere.npz`` (world_mat_<stem> = K w2c,
    scale_mat_<stem> = I), and ``image/cameras_sphere_colmap.npz``, the
    learn confs' cameras: the same poses with COLMAP-grade noise from
    ``perturb_poses`` (seed 5), for the learned cameras to correct -> those
    noisy c2w [8, 4, 4]."""
    import cv2 as cv
    import numpy as np

    from vdnerf_tpu_torch.data.cameras import perturb_poses

    img_dir = os.path.join(data_dir, "image")
    os.makedirs(img_dir)
    K = np.eye(4)
    K[0, 0] = K[1, 1] = 350.0
    K[0, 2], K[1, 2] = SCENE_W / 2, SCENE_H / 2
    light = np.array([0.4, -0.3, 0.85]) / np.linalg.norm([0.4, -0.3, 0.85])
    xs, ys = np.meshgrid(np.arange(SCENE_W), np.arange(SCENE_H))
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float64)
    cams, c2ws = {}, []
    for i in range(SCENE_VIEWS):
        theta = 2 * np.pi * i / SCENE_VIEWS
        c2w = _look_at(3.0 * np.array([np.cos(theta), np.sin(theta), 0.4 + 0.1 * (i % 3)]))
        d = pix @ np.linalg.inv(K[:3, :3]).T
        d = (d / np.linalg.norm(d, axis=-1, keepdims=True)) @ c2w[:3, :3].T
        o = c2w[:3, 3]
        b = d @ o
        disc = b**2 - (o @ o - 0.25)
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        n = (o + d * t[..., None]) / 0.5
        shade = 0.15 + 0.85 * np.clip(n @ light, 0.0, 1.0)
        rgb = np.stack([0.9 * shade, 0.6 * shade, 0.3 + 0.5 * shade], -1)
        rgba = np.zeros((SCENE_H, SCENE_W, 4), np.uint8)
        rgba[..., :3] = np.where(hit[..., None], rgb * 255, 255).astype(np.uint8)
        rgba[..., 3] = hit * 255
        stem = f"{i:03d}"
        cv.imwrite(os.path.join(img_dir, f"{stem}.png"), rgba)
        cams[f"world_mat_{stem}"] = (K @ np.linalg.inv(c2w)).astype(np.float32)
        cams[f"scale_mat_{stem}"] = np.eye(4, dtype=np.float32)
        c2ws.append(c2w)
    np.savez(os.path.join(img_dir, "cameras_sphere.npz"), **cams)
    noisy = perturb_poses(np.stack(c2ws), np.random.default_rng(5))
    np.savez(os.path.join(img_dir, "cameras_sphere_colmap.npz"), **{
        **cams, **{f"world_mat_{i:03d}": (K @ np.linalg.inv(c2w)).astype(np.float32)
                   for i, c2w in enumerate(noisy)}})
    return noisy


# train keys that write_conf adds where a conf has none
NEW_TRAIN_KEYS = ("bf16",)


def write_conf(tmp: str, exp: str = "exp", train: dict | None = None,
               name: str = "womsk_white_tpu") -> str:
    """confs/<name>.conf with only its two paths (and the given ``train``
    keys) rewritten, or added (``NEW_TRAIN_KEYS``)."""
    with open(os.path.join(ROOT, "confs", f"{name}.conf")) as f:
        text = f.read()
    subs = [("./exp/CASE_NAME", f"{tmp}/{exp}/CASE_NAME"),
            ("./depth_data/CASE_NAME", f"{tmp}/depth_data/CASE_NAME")]
    for key, value in (train or {}).items():
        line = next((ln for ln in text.splitlines() if ln.strip().startswith(f"{key} =")), None)
        if line is None and key in NEW_TRAIN_KEYS:
            # a key the shipped conf leaves at its default
            subs.append(("train {", f"train {{\n    {key} = {value}"))
            continue
        if line is None:
            raise SystemExit(f"{name}.conf: no train key {key!r}")
        subs.append((line, f"    {key} = {value}"))
    for old, new in subs:
        if text.count(old) != 1:
            raise SystemExit(f"{name}.conf: expected one {old!r}")
        text = text.replace(old, new)
    path = os.path.join(tmp, f"{name}_{exp}.conf")
    with open(path, "w") as f:
        f.write(text)
    return path


# the bf16 operand mode's serving rates on this phase's scene, from this
# script's earlier runs on an H100 80GB HBM3 at 700 W, printed beside the
# default mode's
BF16_SERVING_RAYS_S = {"valimg_0": "23,267-25,834", "getfeats_0": "45,133-46,284"}


def slice_phase(tmp: str) -> dict:
    """valimg_0 and getfeats_0 through the port's CLI on the card, in JAX's
    default precision: ``VDNERF_FUSED`` unset under the f32 policy, so K2 and
    K4 run their split-operand mode at a serving chunk's rows (393,216 and
    135,168); no bf16 K2-K5 launch, every split one counted."""
    import numpy as np
    import torch

    from vdnerf_tpu_torch import cli
    from vdnerf_tpu_torch.io.checkpoints import save_training_checkpoint
    from vdnerf_tpu_torch.ops.kernels import build
    from vdnerf_tpu_torch.train.builder import build_model, build_networks
    from vdnerf_tpu_torch.utils.hocon import load_conf

    case = "sphere"
    data_dir = os.path.join(tmp, "depth_data", case)
    noisy_c2w = write_scene(data_dir)
    conf_path = write_conf(tmp)
    conf = load_conf(conf_path, case)
    model = build_model(conf, build_networks(conf), seed=0, mlp_dtype=torch.float32)
    exp_dir = conf.get_string("general.base_exp_dir")
    save_training_checkpoint(os.path.join(exp_dir, "checkpoints", "ckpt_000000.pth"), model, 0)

    base = ["--conf", conf_path, "--case", case]
    res = {"launches": {}, "summary": {}, "rays_per_s": {}}
    build.reset_launches()
    for mode, level in (("valimg_0", 2), ("getfeats_0", 1)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = cli.main(base + ["--mode", mode])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rays = SCENE_VIEWS * (SCENE_H // level) * (SCENE_W // level)
        res["summary"][mode] = summary
        res["rays_per_s"][mode] = rays / wall
        print(f"[slice] {mode} (split f32 mode): {summary} rays={rays} wall_s={wall:.3f} "
              f"rays/s={rays / wall:.1f} (bf16 mode: {BF16_SERVING_RAYS_S[mode]})")
        if not all(math.isfinite(v) for v in summary.values()):
            raise SystemExit(f"{mode}: non-finite summary {summary}")
    res["launches"] = dict(build.LAUNCHES)
    print(f"[slice] launches on the serving path: {res['launches']}")
    missing = [k for k in ("sdf_fwd", "sdf_block", "render_fwd_f32", "nerf_fwd_f32")
               if res["launches"][k] == 0]
    bf16 = [k for k in BF16_NAMES if res["launches"][k]]
    if missing or bf16:
        raise SystemExit(f"the serving path launched no {missing}, or bf16 {bf16}")

    depth_dir = os.path.join(data_dir, "image", "depth_from_sdf")
    names = sorted(os.listdir(depth_dir))
    if names != [f"sdf_{i:03d}.npy" for i in range(SCENE_VIEWS)]:
        raise SystemExit(f"getfeats wrote {names}")
    for name in names:
        depth = np.load(os.path.join(depth_dir, name))
        if depth.shape != (SCENE_H, SCENE_W, 1) or not np.isfinite(depth).all():
            raise SystemExit(f"{name}: shape {depth.shape}, finite={np.isfinite(depth).all()}")
    print(f"[slice] depth .npy written: {len(names)} x {(SCENE_H, SCENE_W, 1)}, finite")
    res["conf"] = conf
    res["noisy_c2w"] = noisy_c2w
    return res


def reference_check(conf, device) -> dict:
    """512 rays of the full-width model in the default mode (K2 and K4
    split): kernels on the card against the plain versions with f32 operands
    on the CPU. color atol 5e-3 (the bar set for bf16 operand rounding, as
    the port's render tests; the f32 value is printed); argmax-weight depth
    within 1e-3 on >= 99% of rays."""
    import numpy as np
    import torch

    from vdnerf_tpu_torch.data.dataset import near_far_from_sphere
    from vdnerf_tpu_torch.ops.renderer import render
    from vdnerf_tpu_torch.train.builder import build_model, build_networks

    nets = build_networks(conf)
    rng = np.random.default_rng(1)
    o = rng.normal(size=(512, 3))
    o = 3.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-0.6, 0.6, size=(512, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    outs = {}
    for key, dev in (("card", device), ("plain", torch.device("cpu"))):
        model = build_model(conf, nets, seed=0, mlp_dtype=torch.float32).to(dev)
        ro, rd = (torch.tensor(a, dtype=torch.float32, device=dev) for a in (o, d))
        with torch.no_grad():
            out = render(nets, model, ro, rd, *near_far_from_sphere(ro, rd), perturb_overwrite=0,
                         background_rgb=torch.ones(1, 3, device=dev), cos_anneal_ratio=1.0)
        inside = out["inside_sphere"]
        w = out["weights"][:, : inside.shape[1]] * inside
        depth = torch.gather(out["z_vals"], -1, w.argmax(-1, keepdim=True))
        outs[key] = (out["color_fine"].cpu(), depth.cpu())
    color_err = float((outs["card"][0] - outs["plain"][0]).abs().max())
    depth_agree = float(((outs["card"][1] - outs["plain"][1]).abs() <= 1e-3).float().mean())
    print(f"[check] 512-ray render, split kernels vs plain f32 on the CPU: color max_abs_err="
          f"{color_err:.3e} (tol 5e-3, set for bf16 operands), depth agreement "
          f"{depth_agree:.4f} (>= 0.99)")
    if not color_err <= 5e-3 or depth_agree < 0.99:
        raise SystemExit("the render through the kernels disagrees with the plain render")
    return {"color_max_abs_err": color_err, "depth_agreement": depth_agree}


# the training phases: 40 steps across the resample_from switch, both
# checkpoints and validations inside the run, and a 128^3 mesh at steps 20
# and 40 through the loop's cadence
TRAIN_KEYS = {"end_iter": 40, "resample_from": 20, "save_freq": 20, "val_freq": 20,
              "val_mesh_freq": 20}
TIMED_STEPS = 10
# the background NeRF's kernels; the masked recipe (n_outside = 0) runs none
BACKGROUND = ("nerf_fwd", "nerf_bwd")
# the wdepth recipe, cut in depth only: distillation from step 10 (not 5,000),
# so 29 of the 40 steps train the depth head
WDEPTH = "womsk_white_wdepth_tpu"
WDEPTH_KEYS = {**TRAIN_KEYS, "depth_start_iter": 10}
# the learned-camera recipes, cut in depth only; they have no resample_from
# and no steps_per_call (one step a window, each a replay). The mask-free one
# refines the cameras from step 11 (not from step 0), so that both refine
# programs are captured and pnf_000010 still holds the initial cameras; the
# wdepth one refines from step 0 as shipped, and distills from step 11
LEARN = "womsk_learn_white_colmap"
LEARN_KEYS = {"end_iter": 40, "save_freq": 10, "val_freq": 20, "val_mesh_freq": 20,
              "start_refine_pose_iter": 10}
LEARN_WDEPTH = "womsk_learn_white_wdepth_colmap"
LEARN_WDEPTH_KEYS = {"end_iter": 40, "save_freq": 10, "val_freq": 20, "val_mesh_freq": 20,
                     "depth_start_iter": 10}
def train_phase(tmp: str, name: str = "womsk_white_tpu", keys: dict = TRAIN_KEYS,
                exp: str = "exp_train", mode: str = "f32") -> dict:
    """--mode train of confs/<name>.conf (with the ``keys`` of its train
    block rewritten) through the port's CLI on the card, then valimg_40 from
    its last checkpoint. ``mode``: the operand mode K2-K5 must run in (the
    environment selects it): their launches in that mode counted, none in
    the other."""
    import torch

    from vdnerf_tpu_torch import cli
    from vdnerf_tpu_torch.mesh import load_ply
    from vdnerf_tpu_torch.ops.kernels import build
    from vdnerf_tpu_torch.runner import Runner
    from vdnerf_tpu_torch.train.builder import build_model, build_networks
    from vdnerf_tpu_torch.utils.hocon import load_conf

    case, tag = "sphere", f"[train {name}]"
    conf_path = write_conf(tmp, exp, keys, name)
    conf = load_conf(conf_path, case)
    exp_dir = conf.get_string("general.base_exp_dir")
    base = ["--conf", conf_path, "--case", case]
    masked = conf.get_int("model.neus_renderer.n_outside") == 0
    wdepth = conf.get_bool("train.extract_depth")
    learn = conf.get_bool("train.focal_learnable", default=False)

    # the cadence's meshes, each with the launches it made
    meshes, validate_mesh = [], Runner.validate_mesh

    def counted_mesh(self, *args, **kwargs):
        before = dict(build.LAUNCHES)
        out = validate_mesh(self, *args, **kwargs)
        meshes.append({**out, "launches": {k: v - before[k] for k, v in build.LAUNCHES.items()}})
        return out

    Runner.validate_mesh = counted_mesh
    try:
        build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = cli.main(base + ["--mode", "train"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
    finally:
        Runner.validate_mesh = validate_mesh
    print(f"{tag} {TRAIN_KEYS['end_iter']} steps + validations + meshes: {summary} "
          f"wall_s={wall:.3f}")
    print(f"{tag} launches on the training path: {launches}")
    names = SPLIT_NAMES if mode == "f32" else BF16_NAMES
    background = (names[2], names[3])
    # every recipe here runs the f32 policy, so the SDF block's Function
    expected = ("sdf_fwd", "sdf_block") + names
    missing = [k for k in expected if launches[k] == 0 and not (masked and k in background)]
    if missing:
        raise SystemExit(f"the training path launched no {missing}")
    stray = [k for k, v in launches.items() if v and k not in expected]
    if stray:
        raise SystemExit(f"{tag} the {mode} operand mode launched {stray}")
    if masked and any(launches[k] for k in background):
        raise SystemExit(f"the masked path launched the background NeRF: {launches}")
    if wdepth:
        # K3 once a step for the colour head and once for the depth head from
        # the step past depth_start_iter on (the Trainer's 0-based step), K5
        # once a step with the dpt head, the contraction once a backward
        n, start = keys["end_iter"], keys["depth_start_iter"]
        pc = per_call(mode, True)
        k3, k5 = n + (n - start - 1), n
        want = {names[1]: k3 * pc[names[1]], names[3]: k5 * pc[names[3]],
                names[4]: (k3 + k5) * pc[names[4]]}
        if any(launches[k] != v for k, v in want.items()):
            raise SystemExit(f"{tag} backward launches {launches}, expected {want}")

    # 128^3 = 8 chunks of 64^3 through K1 per mesh, and nothing else
    for m in meshes:
        verts, tris = load_ply(m["path"])
        print(f"{tag} mesh {os.path.basename(m['path'])}: {m['resolution']}^3 "
              f"{len(verts)} vertices {len(tris)} triangles, launches {m['launches']}, "
              f"seconds {m['seconds']}")
        others = {k: v for k, v in m["launches"].items() if k != "sdf_fwd" and v}
        if (m["resolution"], m["world_space"], m["launches"]["sdf_fwd"]) != (128, False, 8) \
                or others or not len(tris) or (len(verts), len(tris)) != (m["n_verts"], m["n_tris"]):
            raise SystemExit(f"{tag} mesh {m}: expected 128^3, 8 K1 launches, triangles")
    names = [os.path.basename(m["path"]) for m in meshes]
    if names != ["00000020.ply", "00000040.ply"] or launches["sdf_fwd"] < 16:
        raise SystemExit(f"{tag} the cadence wrote {names}")

    with open(os.path.join(exp_dir, "logs", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = {r["step"]: r["loss"] for r in recs}
    mask_losses = {r["step"]: r["mask_loss"] for r in recs}
    depth_losses = {r["step"]: r["depth_loss"] for r in recs if "depth_loss" in r}
    print(f"{tag} logged loss by step: {losses}; mask_loss: {mask_losses}"
          + (f"; depth_loss: {depth_losses}" if wdepth else ""))
    if sorted(losses) != [1, 10, 20, 30, 40] or not all(
            map(math.isfinite, [*losses.values(), *mask_losses.values(),
                                *depth_losses.values()])):
        raise SystemExit(f"logged losses: {losses}, mask losses {mask_losses}")
    if wdepth and sorted(depth_losses) != sorted(losses):
        raise SystemExit(f"{tag} the run logged no depth loss: {depth_losses}")
    if masked and not all(v > 0 for v in mask_losses.values()):
        raise SystemExit(f"the masked run logged no mask BCE: {mask_losses}")
    saves = list(range(keys["save_freq"], keys["end_iter"] + 1, keys["save_freq"]))
    ckpts = sorted(os.listdir(os.path.join(exp_dir, "checkpoints")))
    if ckpts != [f"ckpt_{it:06d}.pth" for it in saves]:
        raise SystemExit(f"checkpoints written: {ckpts}")
    pnf = check_pnf(conf, exp_dir, saves, tag) if learn else None
    trained = torch.load(os.path.join(exp_dir, "checkpoints", "ckpt_000040.pth"),
                         map_location="cpu", weights_only=True)
    fresh = build_model(conf, build_networks(conf, wdepth), seed=0,
                        mlp_dtype=torch.float32 if mode == "f32" else torch.bfloat16)
    moved = {net: max(float((trained[net][k] - v).abs().max())
                      for k, v in getattr(fresh, net).state_dict().items())
             for net in ("nerf", "sdf_network_fine", "variance_network_fine",
                         "color_network_fine") + (("depth_network_fine",) if wdepth else ())}
    print(f"{tag} largest parameter change per network after 40 steps: {moved}")
    # with no outside samples the background NeRF gets a zero gradient, and
    # Adam leaves it as it was
    if not all((v == 0) if (masked and net == "nerf") else (v > 0) for net, v in moved.items()):
        raise SystemExit("training left a network unchanged, or moved an unused one")
    if not all(os.listdir(os.path.join(exp_dir, sub)) for sub in ("validations_fine", "normals")):
        raise SystemExit("no validation images were written")

    served = cli.main(base + ["--mode", "valimg_40"])
    diff = max(abs(served[k] - summary[k]) for k in summary)
    print(f"{tag} valimg_40 from ckpt_000040.pth: {served}; max difference to the run's "
          f"closing val_all_imgs {diff:.3e} (tol 1e-6: same weights, deterministic kernels)")
    if set(served) != set(summary) or not diff <= 1e-6:
        raise SystemExit("valimg_40 disagrees with the training run's closing validation")
    return {"launches": launches, "summary": summary, "wall_s": wall, "losses": losses,
            "mask_losses": mask_losses, "depth_losses": depth_losses, "meshes": meshes,
            "conf": conf, "conf_path": conf_path, "case": case, "name": name, "keys": keys,
            "pnf": pnf}


def initial_cameras(conf):
    """The learned cameras a learnable conf starts from (r = t = 0, fx from
    the scene's focal), on the CPU."""
    from vdnerf_tpu_torch.data.cameras import LearnedCameras
    from vdnerf_tpu_torch.data.dataset import SceneData

    scene = SceneData(conf["dataset"])
    return LearnedCameras(scene.pose_all, float(scene.focal), scene.H, scene.W,
                          conf.get_int("model.focal.order", default=2))


def check_pnf(conf, exp_dir: str, saves: list[int], tag: str) -> dict:
    """Each save's ``pnf_<it>.pth``: the reference keys the JAX importer
    reads (``pose_param_net`` r, t, init_c2w; ``intrin_net`` fx;
    ``poses_iter_step``) and both camera Adams; r, t and fx exactly at their
    initial values in a save before the refine gate's first update (step
    ``start_refine_pose_iter`` + 1), moved in every later one -> the largest
    change of each per save."""
    import torch

    start = conf.get_int("train.start_refine_pose_iter")
    init = initial_cameras(conf).state_dict()
    names = sorted(os.listdir(os.path.join(exp_dir, "pnf_checkpoints")))
    if names != [f"pnf_{it:06d}.pth" for it in saves]:
        raise SystemExit(f"{tag} pnf checkpoints written: {names}")
    moved = {}
    for it in saves:
        ckpt = torch.load(os.path.join(exp_dir, "pnf_checkpoints", f"pnf_{it:06d}.pth"),
                          map_location="cpu", weights_only=True)
        if set(ckpt["pose_param_net"]) != {"r", "t", "init_c2w"} or set(ckpt["intrin_net"]) \
                != {"fx"} or ckpt["poses_iter_step"] != it \
                or not {"optimizer_pose", "optimizer_focal"} <= set(ckpt):
            raise SystemExit(f"{tag} pnf_{it:06d}.pth holds {sorted(ckpt)}")
        got = {**ckpt["pose_param_net"], **ckpt["intrin_net"]}
        moved[it] = {k: float((got[k] - init[k]).abs().max()) for k in ("r", "t", "fx")}
        if not torch.equal(got["init_c2w"], init["init_c2w"]):
            raise SystemExit(f"{tag} pnf_{it:06d}.pth changed init_c2w")
        # a save at step it holds the updates of steps 0 .. it - 1
        frozen = it - 1 <= start
        if (frozen and any(moved[it].values())) or (not frozen and not all(moved[it].values())):
            raise SystemExit(f"{tag} pnf_{it:06d}.pth: cameras moved by {moved[it]}, refine "
                             f"gate after step {start}")
    print(f"{tag} learned cameras, largest change from their initial values per save: {moved} "
          f"(refine gate after step {start})")
    return moved


def time_train_steps(conf_path: str, world=None, modes=("replay", "eager", "replay", "eager"),
                     profile: bool = True) -> dict:
    """Steady-state ms/step, rays/s and device idle share per core width (the
    faithful core, and the resampled one after resample_from), the captured
    step replayed against the same step launched eagerly, in turns (replay,
    eager, replay, eager), each a window of TIMED_STEPS steps through
    ``StepDispatch`` between torch.cuda.synchronize() calls, without the
    loop's validations and meshes, after the program's warm-up and capture;
    then one profiled window of each for the device's busy and idle share. On
    a wdepth conf the steps come after depth_start_iter, so they train the
    depth head, and on a learnable conf after start_refine_pose_iter, so
    they update the cameras; a conf without a resampled core times its one
    core. Also each kernel's launches per timed step. ``world``: the
    process group's ``World`` (the parallel phase's rank); ``modes``: the
    timed windows in turn; ``profile``: one profiled window of each mode."""
    import dataclasses

    import numpy as np
    import torch

    from vdnerf_tpu_torch.ops.kernels import build
    from vdnerf_tpu_torch.runner import Runner
    from vdnerf_tpu_torch.tools.profile_render import profile_window
    from vdnerf_tpu_torch.train.dispatch import WARMUP_STEPS, StepDispatch

    runner = Runner(conf_path, case="sphere", mode="train", world=world)
    rcfg = runner.nets.renderer
    policy = runner.model.sdf_network_fine.matmul_dtype
    if (policy is not None) != runner.tcfg.bf16:
        raise SystemExit(f"{conf_path}: train.bf16 {runner.tcfg.bf16} but the SDF block runs "
                         f"under {policy}")
    faithful = dataclasses.replace(runner.nets, renderer=dataclasses.replace(rcfg,
                                                                             n_render_samples=0))
    # one trainer, two per-step calls: a replay, and the eager step
    dispatch = {"replay": StepDispatch(runner.trainer), "eager": StepDispatch(runner.trainer)}
    dispatch["eager"].step = dispatch["eager"].eager_step
    rng = np.random.default_rng(0)
    tag = f"[train {os.path.basename(conf_path)}]"
    print(f"{tag} SDF block matmul dtype: {policy or torch.float32}")
    out = {}
    cores = [(f"core_{rcfg.n_samples + rcfg.n_importance}", faithful)]
    if rcfg.n_render_samples:
        cores.append((f"core_{rcfg.n_render_samples}", runner.nets))
    tcfg = runner.tcfg
    for name, nets in cores:
        step = max(tcfg.depth_start_iter + 1 if tcfg.extract_depth else 0,
                   tcfg.start_refine_pose_iter + 1 if tcfg.learnable else 0)

        sampling_ms = []

        def window(mode, n=TIMED_STEPS):
            nonlocal step
            steps = range(step, step + n)
            t0 = time.perf_counter()
            batches = [runner.store.sample_pixels(s % runner.scene_data.n_images,
                                                  runner.tcfg.batch_size, rng) for s in steps]
            sampling_ms.append((time.perf_counter() - t0) * 1e3 / n)
            step += n
            dispatch[mode].run(steps, [nets] * n, batches)

        window("replay", WARMUP_STEPS + 1)  # the program's warm-up steps, then its capture
        if "eager" in modes:
            window("eager", 2)
        torch.cuda.synchronize()
        rec = {mode: {"ms_per_step": []} for mode in modes}
        for mode in modes:
            build.reset_launches()
            t0 = time.perf_counter()
            window(mode)
            torch.cuda.synchronize()
            rec[mode]["ms_per_step"].append((time.perf_counter() - t0) * 1e3 / TIMED_STEPS)
            rec[mode]["launches_per_step"] = {k: v / TIMED_STEPS for k, v in build.LAUNCHES.items()}
        for mode, r in rec.items():
            r["rays_per_s"] = [runner.tcfg.batch_size * 1e3 / ms for ms in r["ms_per_step"]]
            if not profile:
                print(f"{tag} {name} {mode}: ms/step {[round(v, 3) for v in r['ms_per_step']]}"
                      f", rays/s {[round(v, 1) for v in r['rays_per_s']]}; launches per step "
                      f"{r['launches_per_step']}")
                continue
            prof = profile_window(lambda: window(mode))
            r.update(device_busy_ms_per_step=(prof["device_busy_ms"] or 0.0) / TIMED_STEPS,
                     profiled_ms_per_step=prof["profiled_window_ms"] / TIMED_STEPS,
                     device_events_per_step=prof["device_events"] / TIMED_STEPS,
                     device_span_ms_per_step=(prof["device_span_ms"] or 0.0) / TIMED_STEPS,
                     device_gaps_ms_per_step=(prof["device_gaps_ms"] or 0.0) / TIMED_STEPS,
                     device_idle_share=prof["device_idle_share"],
                     device_ms_per_step_by_span={k: v / TIMED_STEPS for k, v in
                                                 prof["device_ms_by_span"].items()})
            print(f"{tag} {name} {mode}: ms/step {[round(v, 3) for v in r['ms_per_step']]}, "
                  f"rays/s {[round(v, 1) for v in r['rays_per_s']]} (batch "
                  f"{runner.tcfg.batch_size}, windows of {TIMED_STEPS} steps); profiled window "
                  f"{r['profiled_ms_per_step']:.3f} ms/step, device busy "
                  f"{r['device_busy_ms_per_step']:.3f} ms/step in "
                  f"{r['device_events_per_step']:.0f} device events over a span of "
                  f"{r['device_span_ms_per_step']:.3f} ms/step with "
                  f"{r['device_gaps_ms_per_step']:.3f} ms/step of gaps, device idle share "
                  f"{r['device_idle_share']}; device ms/step by span "
                  f"{ {k: round(v, 3) for k, v in r['device_ms_per_step_by_span'].items()} }; "
                  f"launches per step {r['launches_per_step']}")
            if not r["device_busy_ms_per_step"] > 0:
                raise SystemExit(f"{tag} {name} {mode}: the profiler saw no device time")
        # the host's sampling of a window's batches, before its first step
        rec["host_sampling_ms_per_step"] = sampling_ms[-1]
        print(f"{tag} {name}: host pixel sampling {sampling_ms[-1]:.3f} ms a step, done "
              f"before a window's first step")
        if "eager" in rec and \
                rec["replay"]["launches_per_step"] != rec["eager"]["launches_per_step"]:
            raise SystemExit(f"{tag} {name}: a replay counts other launches than an eager step")
        out[name] = rec
    return out


def dispatch_check(tmp: str, graphed: dict) -> dict:
    """A training phase's 40 steps again (womsk_white_tpu's, and the learned
    cameras'), with the window's per-step call patched to the eager card
    step: the same logged steps, checkpoints and meshes, every logged loss
    within 1e-5 relative of the replayed run's and every parameter tensor of
    the last checkpoint (and of its pnf checkpoint: r, t, fx) within 1e-5
    relative L2, the same launches (a replay adds its program's recorded
    launches). Replays and eager steps run the same kernels on the same
    inputs, so both differences are expected to be 0."""
    import torch

    from vdnerf_tpu_torch import cli
    from vdnerf_tpu_torch.ops.kernels import build
    from vdnerf_tpu_torch.train.dispatch import StepDispatch
    from vdnerf_tpu_torch.utils.hocon import load_conf

    case, tag = graphed["case"], f"[dispatch {graphed['name']}]"
    conf_path = write_conf(tmp, "exp_eager", graphed["keys"], graphed["name"])
    dirs = {"replay": graphed["conf"].get_string("general.base_exp_dir"),
            "eager": load_conf(conf_path, case).get_string("general.base_exp_dir")}
    replay_step = StepDispatch.step
    StepDispatch.step = StepDispatch.eager_step
    try:
        build.reset_launches()
        cli.main(["--conf", conf_path, "--case", case, "--mode", "train"])
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
    finally:
        StepDispatch.step = replay_step

    def listing(sub):
        return {k: sorted(os.listdir(os.path.join(d, sub))) for k, d in dirs.items()}

    logs = {}
    for k, d in dirs.items():
        with open(os.path.join(d, "logs", "metrics.jsonl")) as f:
            logs[k] = [json.loads(line) for line in f]
    steps = {k: [r["step"] for r in v] for k, v in logs.items()}
    loss_keys = [k for k in logs["replay"][0] if k.endswith("loss")]
    loss_err = max(abs(e[k] - r[k]) / max(abs(r[k]), 1e-30)
                   for r, e in zip(logs["replay"], logs["eager"]) for k in loss_keys)
    ckpts = {k: torch.load(os.path.join(d, "checkpoints", "ckpt_000040.pth"),
                           map_location="cpu", weights_only=True) for k, d in dirs.items()}
    param_err = max(_rel_l2(ckpts["replay"][net][name], ckpts["eager"][net][name])
                    for net in ckpts["replay"] if isinstance(ckpts["replay"][net], dict)
                    and net != "optimizer" for name in ckpts["replay"][net])
    cam_err = None
    if graphed["pnf"] is not None:
        pnfs = {k: torch.load(os.path.join(d, "pnf_checkpoints", "pnf_000040.pth"),
                              map_location="cpu", weights_only=True) for k, d in dirs.items()}
        cam_err = max(_rel_l2(pnfs["replay"][net][name], pnfs["eager"][net][name])
                      for net, name in (("pose_param_net", "r"), ("pose_param_net", "t"),
                                        ("intrin_net", "fx")))
        param_err = max(param_err, cam_err)
    meshes_same = {}
    for name in listing("meshes")["replay"]:
        data = {}
        for k, d in dirs.items():
            with open(os.path.join(d, "meshes", name), "rb") as f:
                data[k] = f.read()
        meshes_same[name] = data["replay"] == data["eager"]
    res = {"logged_loss_max_rel_err": loss_err, "param_max_rel_l2": param_err,
           "camera_max_rel_l2": cam_err,
           "logged_steps": steps["replay"], "meshes_byte_equal": meshes_same,
           "launches_replay": graphed["launches"], "launches_eager": launches}
    print(f"{tag} replayed vs eager 40-step run: logged steps {steps}; "
          f"logged losses {loss_keys} max rel err {loss_err:.3e} (tol 1e-5); parameters max rel "
          f"L2 {param_err:.3e} (tol 1e-5) over ckpt_000040"
          + ("" if cam_err is None else f" and pnf_000040 (r, t, fx: {cam_err:.3e})")
          + f"; meshes byte-equal {meshes_same}; "
          f"launches replayed {graphed['launches']} eager {launches}")
    if steps["replay"] != steps["eager"] or listing("checkpoints")["replay"] != \
            listing("checkpoints")["eager"] or listing("meshes")["replay"] != \
            listing("meshes")["eager"]:
        raise SystemExit(f"{tag} the runs logged, saved or meshed other steps")
    if not loss_err <= 1e-5 or not param_err <= 1e-5:
        raise SystemExit(f"{tag} the replayed run disagrees with the eager run")
    if launches != graphed["launches"]:
        raise SystemExit(f"{tag} launch counts differ")
    return res


# ---------------------------------------------------------------------------
# parallel phase
# ---------------------------------------------------------------------------

# the kernels the profiler must name in the NCCL run's trace of steps 11-20
# (the default mode: K1 and the split kernels of K2-K5 and the contraction)
TRACE_KERNELS = ("sdf_fwd_kernel", "split_gemm_kernel", "split_embed_kernel",
                 "split_embed_vjp_kernel")
TORCHRUN_TIMEOUT_S = 600


def _torchrun(nproc: int, args: list[str], env: dict | None = None) -> float:
    """This script's rank child on ``nproc`` ranks of this machine through
    ``python -m torch.distributed.run --standalone`` -> wall seconds; raises
    if a rank fails. The launcher and its ranks run in a process group of their
    own, killed whole if they outlive the time limit."""
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", os.path.abspath(__file__), "--rank-child", *args]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env={**os.environ, **(env or {})}, start_new_session=True)
    try:
        rc = proc.wait(timeout=TORCHRUN_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    if rc != 0:
        raise SystemExit(f"torchrun {args[0]} on {nproc} rank(s) exited with {rc}")
    return time.perf_counter() - t0


def full_batch_step(conf_path: str, device, world=None):
    """One full-width 512-ray step at step 1,000 (perturb 0, no generator)
    through the kernels in the default mode (K2-K5 split), on ``world``'s block of the batch when given ->
    (loss, {name: gradient on the CPU}, launches). The gradients are the
    summed ones under a process group."""
    import dataclasses

    import numpy as np
    import torch

    from vdnerf_tpu_torch.data.dataset import SceneData
    from vdnerf_tpu_torch.data.rays import RayStore
    from vdnerf_tpu_torch.ops.kernels import build
    from vdnerf_tpu_torch.parallel import shard_batch
    from vdnerf_tpu_torch.train.builder import build_model, build_networks
    from vdnerf_tpu_torch.train.config import TrainConfig
    from vdnerf_tpu_torch.train.step import Trainer
    from vdnerf_tpu_torch.utils.hocon import load_conf

    conf = load_conf(conf_path, "sphere")
    tcfg = TrainConfig.from_conf(conf)
    nets = build_networks(conf, tcfg.extract_depth)
    nets = dataclasses.replace(nets, renderer=dataclasses.replace(nets.renderer, perturb=0.0))
    scene = SceneData(conf["dataset"])
    batch = RayStore(scene.images_lis, scene.masks_lis).sample_pixels(
        2, BATCH, np.random.default_rng(5))
    if world is not None:
        batch = shard_batch(batch, world)
    model = build_model(conf, nets, seed=0, mlp_dtype=torch.float32).to(device)
    cams = {"pose_all": torch.as_tensor(scene.pose_all, device=device),
            "intrin_inv_all": torch.as_tensor(scene.intrinsics_all_inv, device=device)}
    build.reset_launches()
    metrics = Trainer(tcfg, model, cams, None, world).gradients(nets, batch, 1000)
    torch.cuda.synchronize()
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    return float(metrics["loss"]), grads, dict(build.LAUNCHES)


def rank_child(kind: str, conf_path: str, out: str) -> int:
    """A rank of the parallel phase, started by torchrun. ``nccl``: the
    training run through the CLI in the NCCL group, its replayed steps timed,
    the flat gradient all-reduce and one scalar global sum timed alone ->
    ``out`` (JSON). ``gloo``: a gloo group on cuda:0, shared by every rank,
    and one full-width step on the rank's block -> ``out/rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from vdnerf_tpu_torch import cli, parallel
    from vdnerf_tpu_torch.ops.kernels import build
    from vdnerf_tpu_torch.utils.device import configure_numerics

    configure_numerics()
    if kind == "gloo":
        device = torch.device("cuda:0")  # every rank on the one card
        dist.init_process_group("gloo")
        with parallel.world_from_env(device) as world:
            loss, grads, launches = full_batch_step(conf_path, device, world)
            torch.save({"loss": loss, "grads": grads, "launches": launches,
                        "rays": BATCH // world.size},
                       os.path.join(out, f"rank{world.rank}.pt"))
        dist.destroy_process_group()
        return 0

    device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    with parallel.world_from_env(device) as world:
        build.reset_launches()
        t0 = time.perf_counter()
        summary = cli.main(["--conf", conf_path, "--case", "sphere", "--mode", "train"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        os.environ.pop("VDNERF_PROFILE_DIR", None)
        steps = time_train_steps(conf_path, world=world, modes=("replay", "replay"),
                                 profile=False)
        # the same replayed steps in the bf16 operand mode, for comparison
        os.environ["VDNERF_FUSED"] = "1"
        try:
            steps_bf16 = time_train_steps(conf_path, world=world, modes=("replay",),
                                          profile=False)
        finally:
            os.environ.pop("VDNERF_FUSED")
        from vdnerf_tpu_torch.train.builder import build_model, build_networks
        from vdnerf_tpu_torch.utils.hocon import load_conf

        conf = load_conf(conf_path, "sphere")
        params = list(build_model(conf, build_networks(conf, False), seed=0,
                                  mlp_dtype=torch.float32).to(device).parameters())
        for p in params:
            p.grad = torch.randn_like(p)
        x = torch.ones((), device=device)
        res = {"summary": summary, "launches": launches, "wall_s": wall, "steps": steps,
               "steps_bf16": steps_bf16, "world": [world.rank, world.size, dist.get_backend()],
               "n_params": sum(p.numel() for p in params),
               "all_reduce_grads_ms": time_ms(lambda: parallel.all_reduce_grads(params), 20),
               "global_sum_ms": time_ms(lambda: parallel.global_sum(x), 20)}
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def parallel_phase(tmp: str, train: dict, steps: dict) -> dict:
    """Data parallelism on the one card: (1) the womsk run's 40 steps again
    through ``torchrun --nproc_per_node=1`` (a NCCL world of 1: the loss sums
    and the one gradient all-reduce inside the captured step) under
    ``VDNERF_PROFILE_DIR``: logs and the last checkpoint within 1e-6
    relative of the train phase's run (an all-reduce over one rank is a
    copy), the same launches, the replayed step's ms beside the train
    phase's, the trace of steps 11-20 naming every kernel of the step;
    (2) two gloo ranks on cuda:0, one full-width step each on its 256-ray
    block, against one 512-ray step here: loss within 1e-5 relative, every
    summed gradient within 1e-4 relative L2 (the kernels compute row by row:
    only summation orders differ), K1-K5 launched on both ranks."""
    import torch

    from vdnerf_tpu_torch.utils.hocon import load_conf

    tag = "[parallel]"
    conf_path = write_conf(tmp, "exp_nccl1", TRAIN_KEYS)
    prof_dir = os.path.join(tmp, "profile_nccl1")
    out = os.path.join(tmp, "nccl1.json")
    wall = _torchrun(1, ["nccl", conf_path, out], {"VDNERF_PROFILE_DIR": prof_dir})
    with open(out) as f:
        nccl = json.load(f)
    dirs = {"train": train["conf"].get_string("general.base_exp_dir"),
            "nccl": load_conf(conf_path, "sphere").get_string("general.base_exp_dir")}
    logs = {}
    for k, d in dirs.items():
        with open(os.path.join(d, "logs", "metrics.jsonl")) as f:
            logs[k] = [json.loads(line) for line in f]
    keys = [k for k in logs["train"][0] if k not in ("step", "rays_per_sec")]
    log_err = max(abs(n[k] - t[k]) / max(abs(t[k]), 1e-30)
                  for t, n in zip(logs["train"], logs["nccl"]) for k in keys)
    ckpts = {k: torch.load(os.path.join(d, "checkpoints", "ckpt_000040.pth"), map_location="cpu",
                           weights_only=True) for k, d in dirs.items()}
    param_err = max(float((ckpts["nccl"][net][name] - v).abs().max())
                    / max(float(v.abs().max()), 1e-30)
                    for net, sd in ckpts["train"].items() if isinstance(sd, dict)
                    and net != "optimizer" for name, v in sd.items())
    replay = {core: (steps[core]["replay"]["ms_per_step"], rec["replay"]["ms_per_step"])
              for core, rec in nccl["steps"].items()}
    print(f"{tag} NCCL world of 1 (torchrun --nproc_per_node=1, {nccl['world']}): 40 steps in "
          f"{nccl['wall_s']:.3f} s of cli.main ({wall:.3f} s with torchrun); logged steps "
          f"{[r['step'] for r in logs['nccl']]}; logged metrics max rel diff to the train "
          f"phase's run {log_err:.3e}, ckpt_000040 parameters max rel diff {param_err:.3e} (tol "
          f"1e-6); launches {nccl['launches']} (train phase {train['launches']})")
    for core, (plain, ranked) in replay.items():
        bf16 = nccl["steps_bf16"][core]["replay"]["ms_per_step"]
        print(f"{tag} {core} replayed ms/step: train phase {[round(v, 3) for v in plain]}, NCCL "
              f"world of 1 {[round(v, 3) for v in ranked]}: the in-graph collectives and the "
              f"flat copy cost {min(ranked) - min(plain):.3f} ms/step; NCCL world of 1 in the "
              f"bf16 operand mode {[round(v, 3) for v in bf16]}")
    check_step_calls(f"{tag} NCCL world of 1", nccl["steps"], "f32", (1, 1, 1, 1))
    check_step_calls(f"{tag} NCCL world of 1, VDNERF_FUSED=1", nccl["steps_bf16"], "bf16",
                     (1, 1, 1, 1))
    print(f"{tag} eager, alone: the flat all-reduce of {nccl['n_params']} f32 gradients "
          f"{nccl['all_reduce_grads_ms']:.4f} ms, one scalar global_sum "
          f"{nccl['global_sum_ms']:.4f} ms ({card_line()})")
    if [r["step"] for r in logs["nccl"]] != [r["step"] for r in logs["train"]] \
            or not log_err <= 1e-6 or not param_err <= 1e-6:
        raise SystemExit(f"{tag} the NCCL world of 1 disagrees with the single-process run")
    if nccl["launches"] != train["launches"]:
        raise SystemExit(f"{tag} the NCCL world of 1 launched {nccl['launches']}")
    traces = sorted(os.listdir(prof_dir))
    if traces != ["train_steps_11_20.json"]:
        raise SystemExit(f"{tag} VDNERF_PROFILE_DIR holds {traces}")
    with open(os.path.join(prof_dir, traces[0])) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    in_trace = {k: sum(f"{k}(" in n or f"{k}<" in n for n in names) for k in TRACE_KERNELS}
    n_nccl = sum("nccl" in n.lower() for n in names)
    print(f"{tag} trace {traces[0]}: {len(names)} kernels; ours {in_trace}; NCCL {n_nccl}")
    if not all(in_trace.values()):
        raise SystemExit(f"{tag} the trace names no {[k for k, v in in_trace.items() if not v]}")

    out_dir = os.path.join(tmp, "gloo2")
    os.makedirs(out_dir, exist_ok=True)
    gloo_wall = _torchrun(2, ["gloo", train["conf_path"], out_dir])
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=True)
             for r in range(2)]
    loss, grads, launches = full_batch_step(train["conf_path"], torch.device("cuda:0"))
    loss_err = abs(ranks[0]["loss"] - loss) / abs(loss)
    rel = {n: _rel_l2(ranks[0]["grads"][n], g) for n, g in grads.items()}
    worst = max(rel, key=rel.get)
    same = all(torch.equal(ranks[0]["grads"][n], ranks[1]["grads"][n]) for n in grads)
    print(f"{tag} 2 gloo ranks on cuda:0, {ranks[0]['rays']} rays each ({gloo_wall:.3f} s with "
          f"torchrun), against one {BATCH}-ray step: loss {ranks[0]['loss']:.7f} vs {loss:.7f} "
          f"(rel err {loss_err:.3e}, tol 1e-5); worst gradient rel L2 {rel[worst]:.3e} ({worst},"
          f" tol 1e-4) over {len(rel)} tensors; the ranks' summed gradients equal: {same}; "
          f"launches rank 0 {ranks[0]['launches']}, rank 1 {ranks[1]['launches']}, one step "
          f"{launches}")
    if not loss_err <= 1e-5 or not rel[worst] <= 1e-4 or not same:
        raise SystemExit(f"{tag} the 2-rank step disagrees with the full-batch step")
    for r, rank in enumerate(ranks):
        check_calls(f"{tag} gloo rank {r}", rank["launches"], "f32", (1, 1, 1, 1))
    return {"nccl": {k: nccl[k] for k in ("wall_s", "world", "n_params", "all_reduce_grads_ms",
                                          "global_sum_ms", "steps", "steps_bf16")},
            "nccl_launches": nccl["launches"], "logged_max_rel_diff": log_err,
            "param_max_rel_diff": param_err, "trace_kernels": in_trace, "trace_nccl": n_nccl,
            "gloo": {"loss_rel_err": loss_err, "worst_grad_rel_l2": rel[worst], "worst": worst,
                     "wall_s": gloo_wall},
            "gloo_launches": [r["launches"] for r in ranks]}


# ---------------------------------------------------------------------------
# mesh phase
# ---------------------------------------------------------------------------


def mesh_phase(train: dict, device) -> dict:
    """validate_mesh_40 through the port's CLI (512^3, world space) on the
    trained checkpoint, timed by part, with the launch counts set to 0 just
    before and read just after; then the K1 grid against the plain grid on
    the card at 128^3, and geometry_qc against the scene's sphere."""
    import cv2 as cv
    import numpy as np
    import torch

    from vdnerf_tpu_torch import cli
    from vdnerf_tpu_torch.mesh import load_ply, marching_cubes, mesh_chamfer
    from vdnerf_tpu_torch.mesh.extract import grid_values
    from vdnerf_tpu_torch.mesh.qc import geometry_qc
    from vdnerf_tpu_torch.ops.kernels import build, sdf_fwd
    from vdnerf_tpu_torch.runner import Runner

    argv = ["--conf", train["conf_path"], "--case", train["case"], "--mode", "validate_mesh_40",
            "--mcube_threshold", "0.0"]
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    verts, tris = load_ply(out["path"])
    res = {"launches": launches, "wall_s": wall, "seconds": out["seconds"],
           "n_verts": out["n_verts"], "n_tris": out["n_tris"]}
    print(f"[mesh] validate_mesh_40 at {out['resolution']}^3, world space: {out['n_verts']} "
          f"vertices {out['n_tris']} triangles; "
          f"seconds by part {out['seconds']} (grid = 64^3 chunks through K1, synchronised), "
          f"whole cli.main {wall:.3f} s (set-up and checkpoint load included)")
    print(f"[mesh] launches: {launches}")
    if launches["sdf_fwd"] != 512 or any(v for k, v in launches.items() if k != "sdf_fwd"):
        raise SystemExit("validate_mesh_40 must launch K1 512 times and nothing else")
    if (out["resolution"], out["world_space"]) != (512, True) or not len(tris) \
            or (len(verts), len(tris)) != (out["n_verts"], out["n_tris"]) \
            or not np.isfinite(verts).all():
        raise SystemExit(f"validate_mesh_40 wrote {out}")

    # the grid through K1 against the plain version on the card, at 128^3
    runner = Runner(train["conf_path"], train["case"], mode="validate_mesh")
    runner.load_checkpoint_iter(40)
    sdf = runner.model.sdf_network_fine
    with torch.no_grad():
        ws, bs = sdf.weights()
        ws[-1], bs[-1] = ws[-1][:, :1], bs[-1][:1]
    args = (ws, bs, sdf.cfg.skip_in, sdf.cfg.multires, sdf.cfg.scale)
    b_min, b_max = runner.scene_data.object_bbox_min, runner.scene_data.object_bbox_max
    fields = {}
    for key, fn in (("kernel", sdf_fwd.sdf_value), ("plain", sdf_fwd.sdf_value_plain)):
        with torch.no_grad():
            fields[key] = -grid_values(b_min, b_max, 128, lambda p: fn(p, *args)[:, 0],
                                       device=device)
    grid_err = float((fields["kernel"] - fields["plain"]).abs().max())
    scale = (np.asarray(b_max, np.float32) - np.asarray(b_min, np.float32)) / 127.0
    m = {}
    for key, u in fields.items():
        v, t = marching_cubes(u.cpu().numpy(), 0.0)
        m[key] = (v * scale + np.asarray(b_min, np.float32), t)
    n_k, n_p = len(m["kernel"][1]), len(m["plain"][1])
    tri_gap = abs(n_k - n_p) / max(n_p, 1)
    # mesh_chamfer samples each mesh with its own seed: the plain mesh against
    # itself gives that sampling's floor, and the kernel's mesh must sit
    # within 1e-3 above it
    ch = mesh_chamfer(*m["kernel"], *m["plain"])["chamfer"]
    floor = mesh_chamfer(*m["plain"], *m["plain"])["chamfer"]
    print(f"[mesh] 128^3 grid through K1 vs the plain version on the card: max_abs_err "
          f"{grid_err:.3e} (tol {K1_TOL:.0e}); triangles {n_k} vs {n_p} (gap {tri_gap:.2e}, tol "
          f"1e-3); chamfer between the meshes {ch:.3e}, the plain mesh against itself "
          f"{floor:.3e} (difference tol 1e-3)")
    if not grid_err <= K1_TOL or not tri_gap <= 1e-3 or not ch - floor < 1e-3:
        raise SystemExit("the K1 mesh grid disagrees with the plain grid")
    res.update(grid_max_abs_err=grid_err, triangles_kernel_plain=(n_k, n_p),
               chamfer_kernel_plain=ch, chamfer_plain_plain=floor)

    # geometry QC against the analytic radius-0.5 sphere the scene shows:
    # reported, not gated (the geometric-init zero set sits near radius 0.38)
    masks = np.stack([(cv.imread(p, cv.IMREAD_UNCHANGED)[..., 3] > 127).astype(np.uint8)
                      for p in runner.scene_data.images_lis])
    t0 = time.perf_counter()
    with torch.no_grad():
        qc = geometry_qc(lambda p: -sdf.sdf_value(p)[:, 0],
                         lambda p: 0.5 - torch.linalg.norm(p, dim=-1),
                         b_min, b_max, 512, masks, np.stack(runner.scene_data.world_mats_np),
                         device=device)
    res["qc"] = qc
    print(f"[mesh] geometry_qc at 512^3 against the radius-0.5 sphere: chamfer {qc['chamfer']}, "
          f"raw {qc['raw']}, clean {qc['clean']} ({time.perf_counter() - t0:.1f} s)")
    return res


def gradient_check(conf, device, name: str = "womsk_white_tpu", step: int = 1000,
                   bf16: bool = False, mlp: str = "f32") -> dict:
    """One step's loss and gradients at full width on 128 rays (perturb 0):
    the kernels on the card against the plain versions on the CPU, each
    parameter's gradient and, on a learnable conf, the cameras' r, t and fx
    (at a seeded state off their start, the same on both sides). On a wdepth
    conf ``step`` lies past depth_start_iter + depth_ramp_iters, so the
    distillation ramp is ~1 and the depth head's and the NeRF's dpt head's
    gradients are held too.

    With ``mlp`` "f32" (JAX's default) both sides run K2-K5's f32 operand
    mode (the split kernels on the card, f32 operands on the CPU): the loss
    within 1e-4 relative and every gradient within 2e-3 relative L2, the
    ladder's amplification of f32 summation order
    (``tests/test_torch_masked.py``).

    With ``mlp`` "bf16" both sides round the fused MLPs' operands to bf16:
    loss within 1e-3 relative, every gradient within 2^-6 relative L2. They
    round in another summation order, and a relu kink or a bf16 rounding
    boundary taken the other way moves single rows by a few percent (see the
    kernel phase); the f32 SDF block sums in another order on the card than
    on the CPU.

    With ``bf16`` both sides run the SDF block under the bf16 policy
    (``models/precision.py``), and the CPU also takes the f32 step: each
    gradient is held at 2^-6, or at 1.5x the CPU bf16 step's own distance
    from the CPU f32 step where that is larger (a bf16 rounding taken the
    other way in the SDF block moves a gradient by about that much)."""
    import dataclasses

    import numpy as np
    import torch

    from vdnerf_tpu_torch.data.dataset import SceneData
    from vdnerf_tpu_torch.data.rays import RayStore
    from vdnerf_tpu_torch.train.builder import build_model, build_networks
    from vdnerf_tpu_torch.train.config import TrainConfig
    from vdnerf_tpu_torch.train.step import Trainer

    tcfg = TrainConfig.from_conf(conf)
    nets = build_networks(conf, tcfg.extract_depth)
    nets = dataclasses.replace(nets, renderer=dataclasses.replace(nets.renderer, perturb=0.0))
    scene = SceneData(conf["dataset"])
    batch = RayStore(scene.images_lis, scene.masks_lis, scene.depth_lis,
                     with_depth=tcfg.extract_depth).sample_pixels(2, 128, np.random.default_rng(5))
    res = {}
    runs = [("card", device, bf16), ("plain", torch.device("cpu"), bf16)]
    if bf16:
        runs.append(("plain_f32", torch.device("cpu"), False))
    for key, dev, on in runs:
        model = build_model(conf, nets, seed=0, matmul_dtype=torch.bfloat16 if on else None,
                            mlp_dtype=torch.float32 if mlp == "f32" else torch.bfloat16).to(dev)
        if tcfg.learnable:
            # the learned cameras at a seeded state off their start, so that
            # Rodrigues' general branch and a moved focal are on the path
            cams = initial_cameras(conf)
            rng = np.random.default_rng(3)
            with torch.no_grad():
                for p in cams.pose_params():
                    p.copy_(torch.tensor(rng.normal(scale=0.01, size=p.shape)))
                cams.fx.mul_(1.01)
            cams = cams.to(dev)
        else:
            cams = {"pose_all": torch.as_tensor(scene.pose_all, device=dev),
                    "intrin_inv_all": torch.as_tensor(scene.intrinsics_all_inv, device=dev)}
        metrics = Trainer(tcfg, model, cams, None).gradients(nets, batch, step)
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        if tcfg.learnable:
            grads.update({f"cameras.{n}": p.grad.detach().cpu()
                          for n, p in cams.named_parameters()})
        res[key] = (float(metrics["loss"]), grads)
    loss_err = abs(res["card"][0] - res["plain"][0]) / abs(res["plain"][0])

    def rel_l2(a, b):
        return {n: float((g - b[n]).norm() / b[n].norm().clamp_min(1e-30)) for n, g in a.items()}

    rel = rel_l2(res["card"][1], res["plain"][1])
    loss_tol = 1e-4 if mlp == "f32" else 1e-3
    tol = {n: 2e-3 if mlp == "f32" else 2.0**-6 for n in rel}
    if bf16:
        own = rel_l2(res["plain"][1], res["plain_f32"][1])
        tol = {n: max(2.0**-6, 1.5 * own[n]) for n in rel}
    worst = max(rel, key=lambda n: rel[n] / tol[n])
    policy = ("bf16 SDF block" if bf16 else "f32 SDF block") + f", K2-K5 {mlp} operands"
    print(f"[grad {name}] 128-ray full-width step {step} ({policy}), card vs plain on the CPU: "
          f"loss {res['card'][0]:.6f} vs {res['plain'][0]:.6f} (rel err {loss_err:.3e}, tol "
          f"{loss_tol:.0e}); worst gradient rel L2 error {rel[worst]:.3e} ({worst}, tol "
          f"{tol[worst]:.3e}) over {len(rel)} tensors")
    if bf16:
        print(f"[grad {name}] per tensor, card-vs-CPU bf16 rel L2 / the CPU bf16 step's own "
              f"distance from the CPU f32 step (tol max(2^-6, 1.5x that)): "
              + ", ".join(f"{n} {rel[n]:.3e}/{own[n]:.3e}" for n in rel))
    if not loss_err <= loss_tol or not all(rel[n] <= tol[n] for n in rel):
        raise SystemExit("the training step through the kernels disagrees with the plain step")
    out = {"loss_rel_err": loss_err, "worst_grad_rel_l2": rel[worst], "worst": worst}
    if bf16:
        out.update(own_bf16_f32_rel_l2=own, tol=tol[worst])
    if tcfg.learnable:
        cam = {n: v for n, v in rel.items() if n.startswith("cameras.")}
        print(f"[grad {name}] camera gradients (r, t, fx) rel L2 error: {cam} (tol "
              f"{tol['cameras.r']:.3e}); nonzero: "
              f"{[n for n in cam if float(res['plain'][1][n].abs().max()) > 0]}")
        if set(cam) != {"cameras.r", "cameras.t", "cameras.fx"} or not all(
                float(res["plain"][1][n].abs().max()) > 0 for n in cam):
            raise SystemExit("the learned-camera gradient check did not reach the cameras")
        out["camera_grad_rel_l2"] = cam
    if tcfg.extract_depth:
        from vdnerf_tpu_torch.train.step import depth_ramp_weight

        ramp = depth_ramp_weight(step - tcfg.depth_start_iter - 1, tcfg.depth_ramp_iters)
        heads = {n: v for n, v in rel.items()
                 if n.startswith("depth_network_fine.") or n.startswith("nerf.dpt_linear.")}
        live = all(float(res["plain"][1][n].abs().max()) > 0 for n in heads)
        print(f"[grad {name}] distillation ramp {ramp:.6f}; depth head and dpt head: worst "
              f"rel L2 {max(heads.values()):.3e} over {len(heads)} tensors, all nonzero: {live}")
        if not ramp > 0.99 or not live or not {"nerf.dpt_linear.weight",
                                                "depth_network_fine.lin4.weight_v"} <= set(heads):
            raise SystemExit("the wdepth gradient check did not reach the depth heads")
        out["depth_heads_worst_rel_l2"] = max(heads.values())
    return out


# the cycle phase: the monodepth side-car at the finetune CLI's defaults
# (DenseNet-161, the wavelet decoder, 800^2 inputs, batch 4), 2 epochs over
# the 8 views (4 steps), one validation at step 3; the card-vs-CPU check on
# one 256^2 image (taps) and a batch of 2 (one step's loss and gradients).
# The training-mode gradient is ill-conditioned in f32 (the L1 loss's
# gradient is nearly uniform, and each BatchNorm's backward subtracts its
# mean): where the CPU's own f32 gradient is farther than STEP_TOL from its
# f64 evaluation, the card's must be within 1.5x that distance of f64
CYCLE_SIZE, CYCLE_BATCH, CYCLE_EPOCHS, CYCLE_VAL_FREQ = 800, 4, 2, 3
CHECK_SIZE, TAP_TOL, STEP_TOL = 256, 1e-4, 1e-3


def cycle_phase(tmp: str, train: dict, device) -> dict:
    """The paper's cycle on the card, between its first and last stage:
    getfeats_40 from the womsk_white_tpu run's checkpoint (depth_from_sdf),
    ``wavelet.finetune`` on that export, ``wavelet.predict`` writing the
    96-channel features the wdepth phase then trains on; then the side-car
    on the card against itself on the CPU. All of it under deterministic
    cuDNN (no algorithm timing), so that the finetuned weights and the
    check's card gradient repeat from run to run: the check's gate compares
    two f32 distances from f64 that a different algorithm or weight draw
    moves by tens of percent."""
    from vdnerf_tpu_torch.tools.vdn_cycle_run import deterministic_cudnn

    with deterministic_cudnn():
        return _cycle_phase(tmp, train, device)


def _cycle_phase(tmp: str, train: dict, device) -> dict:
    import copy
    import statistics
    import warnings

    import numpy as np
    import torch

    from vdnerf_tpu_torch import cli
    from vdnerf_tpu_torch.ops.kernels import build
    from vdnerf_tpu_torch.wavelet import finetune as finetune_cli
    from vdnerf_tpu_torch.wavelet import predict as predict_cli
    from vdnerf_tpu_torch.wavelet.io import load_model_from_folder
    from vdnerf_tpu_torch.wavelet.model import WaveletOpts, create_model
    from vdnerf_tpu_torch.wavelet.train_lib import finetune_loss

    data_root = os.path.join(tmp, "depth_data")
    img_dir = os.path.join(data_root, train["case"], "image")

    # 1. the depth export of the trained NeuS
    build.reset_launches()
    t0 = time.perf_counter()
    summary = cli.main(["--conf", train["conf_path"], "--case", train["case"],
                        "--mode", "getfeats_40"])
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    print(f"[cycle] getfeats_40 from the {train['name']} run: {summary} "
          f"wall_s={time.perf_counter() - t0:.3f}; launches {launches}")
    if not all(math.isfinite(v) for v in summary.values()) or not launches["sdf_fwd"] \
            or not launches["render_fwd_f32"] or not launches["nerf_fwd_f32"] \
            or any(launches[k] for k in BF16_NAMES):
        raise SystemExit(f"getfeats_40 for the cycle: summary {summary}, launches {launches}")
    for i in range(SCENE_VIEWS):
        depth = np.load(os.path.join(img_dir, "depth_from_sdf", f"sdf_{i:03d}.npy"))
        if depth.shape != (SCENE_H, SCENE_W, 1) or not np.isfinite(depth).all():
            raise SystemExit(f"getfeats_40 wrote a depth of shape {depth.shape}")

    # 2. finetune, each step timed by CUDA events
    step_ms = []
    make_step = finetune_cli.make_finetune_step

    def timed_make_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def timed(batch, lr):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(batch, lr)
            stop.record()
            stop.synchronize()
            step_ms.append(start.elapsed_time(stop))
            return out

        return timed

    finetune_cli.make_finetune_step = timed_make_step
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logpath = finetune_cli.finetune([
            "-r", data_root, "--case", train["case"], "--image_size", str(CYCLE_SIZE),
            "-bs", str(CYCLE_BATCH), "--epochs", str(CYCLE_EPOCHS),
            "--val_freq", str(CYCLE_VAL_FREQ), "--log_every", "1",
            "--logdir", os.path.join(tmp, "wavelet_log")])
        torch.cuda.synchronize()
        finetune_wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        finetune_cli.make_finetune_step = make_step
    n_steps = CYCLE_EPOCHS * math.ceil(SCENE_VIEWS / CYCLE_BATCH)
    with open(os.path.join(logpath, "train", "metrics.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f]
    with open(os.path.join(logpath, "val", "metrics.jsonl")) as f:
        val = [json.loads(line) for line in f]
    val_images = sorted(os.listdir(os.path.join(logpath, "val", "images")))
    ckpt = os.path.join(logpath, "models", f"weights_{CYCLE_EPOCHS - 1}")
    median_ms = statistics.median(step_ms[1:])
    print(f"[cycle] finetune DenseNet-161 at {CYCLE_SIZE}^2, batch {CYCLE_BATCH}: {len(step_ms)} "
          f"steps, losses {losses}, validation at steps {[r['step'] for r in val]} "
          f"(loss {[r['loss'] for r in val]}), {len(val_images)} image tags in val/images; "
          f"wall_s={finetune_wall:.3f}")
    print(f"[cycle] finetune step ms (CUDA events) {step_ms}; median after the first "
          f"{median_ms:.3f} ms = {CYCLE_BATCH / median_ms * 1e3:.3f} images/s; peak memory "
          f"{peak} bytes ({peak / 2**30:.3f} GiB)")
    if len(step_ms) != n_steps or len(losses) != n_steps \
            or not all(math.isfinite(v) for v in losses) \
            or [r["step"] for r in val] != [CYCLE_VAL_FREQ] or "color" not in val_images \
            or not os.path.exists(os.path.join(ckpt, "model.npz")):
        raise SystemExit(f"the finetune run: {len(step_ms)} steps, losses {losses}, "
                         f"validations {val}, images {val_images}, checkpoint {ckpt}")

    # 3. predict: the encoder's first tap per view
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    paths = predict_cli.main(["-ckpt", ckpt, "-d", img_dir])
    predict_ms = (time.perf_counter() - t0) * 1e3 / max(len(paths), 1)
    shape = (1, 96, SCENE_H // 2, SCENE_W // 2)
    for path in paths:
        feat = np.load(path)
        if feat.shape != shape or feat.dtype != np.float32 or not np.isfinite(feat).all() \
                or not np.abs(feat).max() > 0:
            raise SystemExit(f"predict wrote {path}: {feat.shape} {feat.dtype}")
    print(f"[cycle] predict: {len(paths)} files of {shape} float32, finite, nonzero; "
          f"{predict_ms:.3f} ms per image (the CLI's wall clock, reading and writing included)")
    if sorted(os.path.basename(p) for p in paths) != [f"{i:03d}.npy" for i in range(SCENE_VIEWS)]:
        raise SystemExit(f"predict wrote {paths}")

    # 4. the same module and weights on the card and on the CPU (predict let
    # cuDNN time its algorithms again)
    torch.backends.cudnn.benchmark = False
    model = create_model(WaveletOpts(), device)
    load_model_from_folder(model, ckpt)
    rng = np.random.default_rng(11)
    image = torch.tensor(rng.uniform(size=(1, 3, CHECK_SIZE, CHECK_SIZE)), dtype=torch.float32)
    cpu = copy.deepcopy(model).to("cpu")
    with torch.no_grad():
        taps = [t.cpu() for t in model.encode(image.to(device))]
        want = cpu.encode(image)
    tap_err = [float((g - w).norm() / w.norm()) for g, w in zip(taps, want)]
    # the encoder alone at one view, as predict runs it
    view = torch.rand(1, 3, SCENE_H, SCENE_W, device=device)
    with torch.no_grad():
        encode_ms = time_ms(lambda: model.encode(view))
    print(f"[cycle] the encoder alone at one {SCENE_H}x{SCENE_W} view: {encode_ms:.3f} ms "
          "(CUDA events)")
    batch = {"image": torch.tensor(rng.uniform(size=(2, 3, CHECK_SIZE, CHECK_SIZE)),
                                   dtype=torch.float32),
             "depth": torch.tensor(rng.uniform(0, 200, size=(2, 1, CHECK_SIZE // 2,
                                                              CHECK_SIZE // 2)),
                                   dtype=torch.float32),
             "mask": torch.tensor(rng.uniform(size=(2, 1, CHECK_SIZE // 2, CHECK_SIZE // 2))
                                  > 0.2, dtype=torch.float32)}
    res = {}
    # torch names the ops that have no deterministic implementation (a
    # warning each), which would break the repeat
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for key, m in (("card", model), ("card_again", model), ("cpu", cpu),
                           ("f64", copy.deepcopy(cpu).double())):
                m.train()
                p0 = next(m.parameters())
                loss, _ = finetune_loss(m, {k: v.to(p0.device, p0.dtype)
                                            for k, v in batch.items()})
                grads = torch.autograd.grad(loss, list(m.encoder.parameters()))
                res[key] = (float(loss.detach()),
                            torch.cat([g.cpu().double().flatten() for g in grads]))
        finally:
            torch.use_deterministic_algorithms(False)
    nondeterministic = sorted({str(w.message).splitlines()[0][:200] for w in caught
                               if "determinis" in str(w.message)})
    print(f"[cycle] torch's nondeterminism warnings on the check's step: {nondeterministic}")

    def rel(a, b):
        return float((res[a][1] - res[b][1]).norm() / res[b][1].norm())

    loss_err = abs(res["card"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    grad_err, card64, cpu64 = rel("card", "cpu"), rel("card", "f64"), rel("cpu", "f64")
    repeats = res["card"][0] == res["card_again"][0] and torch.equal(res["card"][1],
                                                                     res["card_again"][1])
    print(f"[cycle] card vs CPU, DenseNet-161 eval taps at {CHECK_SIZE}^2: rel L2 "
          f"{[f'{e:.3e}' for e in tap_err]} (tol {TAP_TOL}); finetune step at batch 2: loss "
          f"{res['card'][0]:.6f} vs {res['cpu'][0]:.6f} (rel err {loss_err:.3e}, tol "
          f"{STEP_TOL}); the encoder's gradient (one vector), rel L2: card vs CPU "
          f"{grad_err:.3e}, card vs CPU f64 {card64:.3e}, CPU vs CPU f64 {cpu64:.3e} (tol "
          f"{STEP_TOL} against the CPU, or 1.5x the CPU's own distance from f64); the card's "
          f"step again bit for bit: {repeats}")
    if not max(tap_err) <= TAP_TOL or not loss_err <= STEP_TOL \
            or not (grad_err <= STEP_TOL or card64 <= 1.5 * cpu64) or not repeats:
        raise SystemExit("the side-car on the card disagrees with itself on the CPU")
    print(card_line())
    return {"getfeats_launches": launches, "finetune_losses": losses,
            "finetune_step_ms": step_ms, "finetune_step_ms_median": median_ms,
            "images_per_s": CYCLE_BATCH / median_ms * 1e3, "finetune_wall_s": finetune_wall,
            "peak_memory_bytes": peak, "predict_ms_per_image": predict_ms,
            "encode_ms_per_view": encode_ms,
            "tap_rel_l2": tap_err, "step_loss_rel_err": loss_err,
            "step_encoder_grad_rel_l2": grad_err, "step_encoder_grad_card_vs_f64": card64,
            "step_encoder_grad_cpu_vs_f64": cpu64, "step_repeats_bit_for_bit": repeats,
            "step_nondeterminism_warnings": nondeterministic}


def serve_wdepth(train: dict) -> dict:
    """getfeats_40 through the port's CLI from a wdepth run's checkpoint in
    the default mode, with the launch counts set to 0 just before and read
    just after: each chunk calls split K2 twice (the depth head, then the
    colour head) and split K4 once with its dpt head, and no backward and no
    bf16 K2-K5. On a learnable conf the runner
    renders through the cameras of ``pnf_000040.pth``, which moved."""
    import numpy as np
    import torch

    from vdnerf_tpu_torch import cli
    from vdnerf_tpu_torch.ops.kernels import build
    from vdnerf_tpu_torch.runner import Runner

    argv = ["--conf", train["conf_path"], "--case", train["case"], "--mode", "getfeats_40"]
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    rays = SCENE_VIEWS * SCENE_H * SCENE_W
    print(f"[serve {train['name']}] getfeats_40: {summary} rays={rays} wall_s={wall:.3f} "
          f"rays/s={rays / wall:.1f}; launches {launches}")
    if not all(math.isfinite(v) for v in summary.values()):
        raise SystemExit(f"getfeats_40: non-finite summary {summary}")
    chunks = launches["nerf_fwd_f32"] // SPLIT_PER_CALL[2]
    check_calls(f"[serve {train['name']}] getfeats_40", launches, "f32",
                (2 * chunks, 0, chunks, 0))
    if not chunks:
        raise SystemExit(f"getfeats_40 on the wdepth checkpoint launched {launches}")
    depth_dir = os.path.join(train["conf"].get_string("dataset.data_dir"), "image",
                             "depth_from_sdf")
    for i in range(SCENE_VIEWS):
        depth = np.load(os.path.join(depth_dir, f"sdf_{i:03d}.npy"))
        if depth.shape != (SCENE_H, SCENE_W, 1) or not np.isfinite(depth).all():
            raise SystemExit(f"getfeats_40 wrote a depth of shape {depth.shape}")
    if train["pnf"] is not None:
        runner = Runner(train["conf_path"], train["case"], mode="getfeats")
        runner.load_checkpoint_iter(40)
        saved = torch.load(os.path.join(runner.base_exp_dir, "pnf_checkpoints", "pnf_000040.pth"),
                           map_location="cpu", weights_only=True)
        init = initial_cameras(train["conf"]).state_dict()
        got = {k: v.cpu() for k, v in runner.cams.state_dict().items()}
        same = all(torch.equal(got[k], saved[net][k]) for net, k in (
            ("pose_param_net", "r"), ("pose_param_net", "t"), ("intrin_net", "fx")))
        moved = float((got["r"] - init["r"]).abs().max())
        print(f"[serve {train['name']}] the runner's cameras are pnf_000040's: {same}; r moved "
              f"{moved:.3e} from its start")
        if not same or not moved > 0:
            raise SystemExit("getfeats_40 did not render through the learned cameras")
    return {"launches": launches, "summary": summary, "rays_per_s": rays / wall}


# ---------------------------------------------------------------------------
# capture and novel views
# ---------------------------------------------------------------------------


def write_colmap_model(sparse_dir: str, c2ws, f: float, points) -> None:
    """A binary COLMAP sparse model: one SIMPLE_PINHOLE camera at focal ``f``
    and the scene's size, one image per c2w (named as the scene's views, no
    keypoints), and ``points`` each seen by the first two images."""
    import struct

    import numpy as np

    from vdnerf_tpu_torch.colmap.read_model import rotmat2qvec

    os.makedirs(sparse_dir)
    with open(os.path.join(sparse_dir, "cameras.bin"), "wb") as fo:
        fo.write(struct.pack("<Q", 1) + struct.pack("<iiQQ", 1, 0, SCENE_W, SCENE_H))
        fo.write(struct.pack("<3d", f, SCENE_W / 2, SCENE_H / 2))
    with open(os.path.join(sparse_dir, "images.bin"), "wb") as fo:
        fo.write(struct.pack("<Q", len(c2ws)))
        for i, c2w in enumerate(c2ws):
            w2c = np.linalg.inv(c2w)
            fo.write(struct.pack("<i", i + 1) + struct.pack("<4d", *rotmat2qvec(w2c[:3, :3])))
            fo.write(struct.pack("<3d", *w2c[:3, 3]) + struct.pack("<i", 1))
            fo.write(f"{i:03d}.png".encode() + b"\x00" + struct.pack("<Q", 0))
    with open(os.path.join(sparse_dir, "points3D.bin"), "wb") as fo:
        fo.write(struct.pack("<Q", len(points)))
        for j, p in enumerate(points):
            fo.write(struct.pack("<Q", j + 1) + struct.pack("<3d", *p))
            fo.write(struct.pack("<3B", 200, 150, 90) + struct.pack("<d", 0.5))
            fo.write(struct.pack("<Q", 2) + struct.pack("<iiii", 1, j, 2, j))


COLMAP_POINTS = 300


def colmap_phase(tmp: str, noisy_c2w) -> dict:
    """The capture preparation a learn conf starts from: a COLMAP model of
    the scene's noisy cameras (f = 350) and 300 points around the sphere,
    then ``python -m vdnerf_tpu_torch.colmap.imgs2poses`` (COLMAP skipped:
    sparse/0 is there), the crop step (every point kept) and
    ``python -m vdnerf_tpu_torch.colmap.gen_cameras_cli``. Decomposing each
    ``world_mat_<i> @ scale_mat_<i>`` must give that camera's rotation within
    1e-4 and f = 350 within 1e-4 relative."""
    import numpy as np

    from vdnerf_tpu_torch.data.dataset import load_K_Rt_from_P
    from vdnerf_tpu_torch.mesh import load_ply, save_ply

    capture = os.path.join(tmp, "capture")
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(COLMAP_POINTS, 3))
    pts *= rng.uniform(0.45, 0.55, (COLMAP_POINTS, 1)) / np.linalg.norm(pts, axis=-1, keepdims=True)
    write_colmap_model(os.path.join(capture, "sparse", "0"), noisy_c2w, 350.0, pts)
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    seconds = {}
    for module in ("imgs2poses", "gen_cameras_cli"):
        if module == "gen_cameras_cli":
            verts, _ = load_ply(os.path.join(capture, "sparse_points.ply"))
            save_ply(os.path.join(capture, "sparse_points_interest.ply"), verts,
                     np.zeros((0, 3), np.int64))
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", f"vdnerf_tpu_torch.colmap.{module}", capture],
                             cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        seconds[module] = time.perf_counter() - t0
        print(f"[colmap] {module}: rc {out.returncode}, {seconds[module]:.2f} s: "
              f"{out.stdout.strip().splitlines()}")
        if out.returncode:
            raise SystemExit(f"{module} failed:\n{out.stderr[-4000:]}")
    poses = np.load(os.path.join(capture, "poses.npy"))
    cams = np.load(os.path.join(capture, "cameras_sphere_colmap.npz"))
    rot_err = f_err = 0.0
    for i, c2w in enumerate(noisy_c2w):
        P = (cams[f"world_mat_{i:03d}"] @ cams[f"scale_mat_{i:03d}"])[:3, :4]
        K, pose = load_K_Rt_from_P(None, P)
        rot_err = max(rot_err, float(np.abs(pose[:3, :3] - c2w[:3, :3]).max()))
        f_err = max(f_err, abs(K[0, 0] / 350.0 - 1), abs(K[1, 1] / 350.0 - 1))
    print(f"[colmap] poses.npy {poses.shape}; {len(cams.files)} arrays in the npz;"
          f" rotation max abs err {rot_err:.3e} (tol 1e-4), focal rel err {f_err:.3e} (tol 1e-4)")
    if poses.shape != (SCENE_VIEWS, 3, 5) or not rot_err <= 1e-4 or not f_err <= 1e-4:
        raise SystemExit("the COLMAP preparation did not recover the cameras")
    return {"poses_shape": list(poses.shape), "rotation_max_abs_err": rot_err,
            "focal_rel_err": f_err, "seconds": seconds}


def showcam_phase(tmp: str, learn: dict) -> dict:
    """``showcam_40 -c`` through the port's CLI on the learn run, with
    ``dataset.gt_cameras_name`` pointed at the clean cameras: the npz holds
    init, learned and GT c2w [8, 4, 4] and the learned K [4, 4]; the learned
    poses moved away from the initial ones; the PNG is a 3-channel image with
    something drawn. Prints each set's largest rotation error against GT."""
    import cv2 as cv
    import numpy as np

    from vdnerf_tpu_torch import cli

    with open(learn["conf_path"]) as f:
        text = f.read()
    line = "    object_cameras_name = IMG_DIR/cameras_sphere_colmap.npz"
    if text.count(line) != 1:
        raise SystemExit(f"{learn['name']}.conf: expected one {line!r}")
    conf_path = learn["conf_path"].replace(".conf", "_gt.conf")
    with open(conf_path, "w") as f:
        f.write(text.replace(line, line + "\n    gt_cameras_name = IMG_DIR/cameras_sphere.npz"))
    t0 = time.perf_counter()
    path = cli.main(["--conf", conf_path, "--case", learn["case"], "--mode", "showcam_40", "-c"])
    wall = time.perf_counter() - t0
    with np.load(path) as f:
        dump = dict(f)
    shapes = {k: v.shape for k, v in dump.items()}
    want = {"init_c2w": (SCENE_VIEWS, 4, 4), "learned_c2w": (SCENE_VIEWS, 4, 4),
            "gt_c2w": (SCENE_VIEWS, 4, 4), "learned_K": (4, 4)}
    if shapes != want:
        raise SystemExit(f"showcam_40 dumped {shapes}")
    moved = float(np.abs(dump["learned_c2w"] - dump["init_c2w"]).max())
    rot_err = {k: float(np.abs(dump[k][:, :3, :3] - dump["gt_c2w"][:, :3, :3]).max())
               for k in ("init_c2w", "learned_c2w")}
    png = cv.imread(path.replace(".npz", ".png"))
    print(f"[showcam] {path}: {shapes}, wall_s={wall:.3f}; learned moved {moved:.3e} from init; "
          f"rotation max abs err against GT {rot_err}; learned f {dump['learned_K'][0, 0]:.4f}; "
          f"png {None if png is None else png.shape}")
    if not moved > 0:
        raise SystemExit(f"showcam_40: the learned poses did not move ({moved})")
    if png is None or png.ndim != 3 or png.shape[2] != 3 or not (png < 250).any():
        raise SystemExit("showcam_40 wrote no frustum image")
    return {"shapes": {k: list(v) for k, v in shapes.items()}, "learned_moved": moved,
            "rotation_err_vs_gt": rot_err, "wall_s": wall}


INTERP_FRAMES, INTERP_LEVEL = 60, 4
# the sweeps' frames/s in the bf16 operand mode (this script's runs on an
# H100 80GB HBM3 at 700 W before the default mode), printed beside the
# default mode's
BF16_FRAMES_S = {"womsk_white_tpu": "5.83", "womsk_learn_white_colmap": "4.66"}
# every 16th ray of a 100x75 frame: 469 rays, about reference_check's 512
REF_STRIDE = 16


def interpolate_phase(run: dict, tag: str) -> dict:
    """``interpolate_0_1 -c`` through the port's CLI on a training run's
    latest checkpoint in the default mode, with the launch counts set to 0
    just before and read just after: K1, split K2 and split K4 launch, K2 and
    K4 called once per 4096-ray chunk (two a frame of 100x75, 120 in all), no
    backward kernel and no bf16 K2-K5; the .mp4 decodes to
    120 frames of 100x74 (the codec's even size). Then the sweep's middle
    frame (ratio 0.5) through the kernels on the card, every 16th of its rays
    against the plain versions on the CPU (colour 5e-3, as
    ``reference_check``)."""
    import cv2 as cv
    import numpy as np
    import torch

    from vdnerf_tpu_torch import cli
    from vdnerf_tpu_torch.data.cameras import rays_between
    from vdnerf_tpu_torch.ops.kernels import build
    from vdnerf_tpu_torch.runner import Runner

    h, w = SCENE_H // INTERP_LEVEL, SCENE_W // INTERP_LEVEL
    chunks = INTERP_FRAMES * math.ceil(h * w / CHUNK)
    base = ["--conf", run["conf_path"], "--case", run["case"]]
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = cli.main(base + ["--mode", "interpolate_0_1", "-c"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    rays = INTERP_FRAMES * h * w
    print(f"[{tag}] interpolate_0_1 (split f32 mode): {path} wall_s={wall:.3f} frames/s="
          f"{INTERP_FRAMES / wall:.2f} rays/s={rays / wall:.1f} (bf16 mode: "
          f"{BF16_FRAMES_S[run['name']]} frames/s); launches {launches}")
    check_calls(f"[{tag}] interpolate_0_1", launches, "f32", (chunks, 0, chunks, 0))
    cap = cv.VideoCapture(path)
    shapes = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        shapes.append(frame.shape)
    cap.release()
    # mp4v stores 4:2:0 chroma, so the encoder keeps even sizes: 75 rows
    # decode as 74, as the JAX writer's do
    print(f"[{tag}] the video decodes to {len(shapes)} frames of {set(shapes)}")
    if len(shapes) != 2 * INTERP_FRAMES or set(shapes) != {(h - h % 2, w - w % 2, 3)}:
        raise SystemExit(f"[{tag}] the video holds {len(shapes)} frames of {set(shapes)}")

    # the middle frame whole on the card, every REF_STRIDE-th of its rays on
    # the CPU (a full frame through the plain versions takes ~85 s there)
    colors = {}
    for dev in (None, "cpu"):
        runner = Runner(run["conf_path"], run["case"], device=dev, mode="interpolate",
                        is_continue=True)
        poses, intrin_inv = runner.resolved_cams()
        if dev is None:
            frame = runner.renderer.render_between(runner.model, poses, intrin_inv, 0, 1, 0.5,
                                                   INTERP_LEVEL, runner.iter_step)
            colors["cuda"] = frame.reshape(-1, 3)[::REF_STRIDE]
            continue
        rays_o, rays_d = rays_between(*(torch.as_tensor(a) for a in (poses[0], poses[1],
                                                                     intrin_inv[0])),
                                      0.5, SCENE_H, SCENE_W, INTERP_LEVEL)
        colors["cpu"] = runner.renderer.render_rays(
            runner.model, rays_o.reshape(-1, 3)[::REF_STRIDE], rays_d.reshape(-1, 3)[::REF_STRIDE],
            runner.iter_step)["color"]
    err = float(np.abs(colors["cuda"] - colors["cpu"]).max())
    print(f"[{tag}] the middle frame ({frame.shape}), {len(colors['cpu'])} of its rays, split "
          f"kernels vs plain f32 on the CPU: colour max_abs_err {err:.3e} (tol 5e-3, set for "
          f"bf16 operands)")
    if frame.shape != (h, w, 3) or not err <= 5e-3:
        raise SystemExit(f"[{tag}] the interpolated frame disagrees with the plain render")
    return {"launches": launches, "wall_s": wall, "frames_per_s": INTERP_FRAMES / wall,
            "rays_per_s": rays / wall, "video_frames": len(shapes), "frame_hw": [h, w],
            "chunks": chunks, "middle_frame_max_abs_err": err}


# the flagship phase: the convergence tool at full width on its 24 views of
# 256^2, bf16, at its defaults otherwise (the faithful 128-sample core, the
# background NeRF over all 160 samples), 300 steps in windows of 10
FLAGSHIP_ARGS = ["--iters", "300", "--val-every", "100", "--resolution", "256"]


def flagship_raw_chamfer(out: str, resolution: int) -> dict:
    """Chamfer of the tool's extracted mesh (``flagship_mesh.ply``, before the
    visual-hull cleaning) against the compound surface extracted at the same
    resolution over the same bbox, on the card."""
    import numpy as np

    from vdnerf_tpu_torch.data.synthetic import compound_sdf_torch
    from vdnerf_tpu_torch.mesh.extract import extract_geometry, load_ply
    from vdnerf_tpu_torch.mesh.metrics import mesh_chamfer

    verts, tris = load_ply(os.path.join(out, "flagship_mesh.ply"))
    gt_verts, gt_tris = extract_geometry(np.full(3, -1.01), np.full(3, 1.01), resolution, 0.0,
                                         lambda p: -compound_sdf_torch(p), device="cuda")
    return mesh_chamfer(verts, tris, gt_verts, gt_tris)


def flagship_phase(tmp: str) -> dict:
    """``vdnerf_tpu_torch.tools.flagship_run`` on the card (bf16, 300 steps,
    a 256^3 mesh), launch counts set to 0 before and read after: fails
    unless every kernel and the contraction ran,
    the masked PSNR at step 300 is above that at step 100, and the extracted
    mesh is non-empty with a finite Chamfer distance to the analytic surface.
    That Chamfer is the uncleaned mesh's: 300 steps leave the surface a
    smooth blob around the object, which the visual-hull cleaning culls
    whole (the report's cleaned Chamfer is then null)."""
    import torch

    from vdnerf_tpu_torch.ops.kernels import build
    from vdnerf_tpu_torch.tools import flagship_run

    out = os.path.join(tmp, "flagship")
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = flagship_run.main(FLAGSHIP_ARGS + ["--out", out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    curve = [(c["iter"], c["masked_psnr_res2"]) for c in report["psnr_curve"]]
    print(f"[flagship] {' '.join(FLAGSHIP_ARGS)} (bf16 {report['config']['bf16']}): wall "
          f"{wall:.1f} s, train {report['train_wall_s']} s, steady rays/s "
          f"{report['steady_rays_per_sec']}, masked PSNR curve {curve}, final full-res "
          f"{report['final_masked_psnr_fullres']} dB, mesh {report['mesh']['n_verts']} verts, "
          f"cleaned {report['mesh_clean']}, chamfer {report['chamfer']}; launches {launches}")
    if not report["mesh"]["n_verts"]:
        raise SystemExit("flagship: the extracted mesh is empty")
    raw = flagship_raw_chamfer(out, report["config"]["mesh_res"])
    print(f"[flagship] the extracted (uncleaned) mesh against the analytic surface: {raw}")
    missing = [k for k in ("sdf_fwd",) + BF16_NAMES if launches[k] == 0]
    if missing:
        raise SystemExit(f"flagship: not launched: {missing}")
    if not report["config"]["bf16"]:
        raise SystemExit("flagship: the run was not bf16")
    if not curve[-1][1] > curve[0][1]:
        raise SystemExit(f"flagship: the masked PSNR did not rise: {curve}")
    if not math.isfinite(raw["chamfer"]):
        raise SystemExit(f"flagship: non-finite Chamfer: {raw}")
    return {"launches": launches, "wall_s": wall, "psnr_curve": curve, "raw_chamfer": raw,
            **{k: report[k] for k in ("train_wall_s", "startup_warmup_capture_s",
                                      "resample_onset_warmup_capture_s", "val_wall_s",
                                      "rays_per_sec", "steady_rays_per_sec",
                                      "final_masked_psnr_fullres", "final_eikonal", "chamfer",
                                      "mesh", "mesh_clean")}}


# the tool at full width, cut in depth: 8 views of 64^2, 100 steps a leg,
# one side-car epoch, 128^3 QC meshes
VDN_CYCLE_ARGS = ["--iters", "100", "--views", "8", "--img-res", "64", "--wavelet-epochs", "1",
                  "--mesh-res", "128", "--shading", "camlight", "--depth-weight-scale", "10"]
VDN_CYCLE_KERNELS = ("sdf_fwd", "render_fwd", "render_bwd", "nerf_fwd", "nerf_bwd",
                     "dw_contract")


def vdn_cycle_phase(tmp: str) -> dict:
    """``vdnerf_tpu_torch.tools.vdn_cycle_run`` on the card: the full cycle,
    then ``--skip-to-wdepth`` on its ``--out``, launch counts set to 0 before
    and read after. Prints each stage's wall time, peak memory and launches;
    fails unless every kernel ran in both wdepth legs and the values the CPU
    tests hold are present and finite."""
    import torch

    from vdnerf_tpu_torch.ops.kernels import build
    from vdnerf_tpu_torch.tools import vdn_cycle_run

    out = os.path.join(tmp, "vdn_cycle")
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = vdn_cycle_run.main(VDN_CYCLE_ARGS + ["--out", out])
    leg = vdn_cycle_run.main(VDN_CYCLE_ARGS + ["--out", out, "--skip-to-wdepth"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    stages = {}
    for name in ("vdn_cycle_report", f"vdn_cycle_report_wdepth{leg['config']['iters']}"):
        with open(os.path.join(out, f"{name}_card.json")) as f:
            card = json.load(f)
        for stage, rec in card["stages"].items():
            print(f"[vdn_cycle] {name} {stage}: {rec['wall_s']} s, peak memory "
                  f"{rec['peak_memory_bytes']} bytes ({rec['peak_memory_bytes'] / 2**30:.2f} "
                  f"GiB), launches {rec['launches']}")
        stages[name] = card["stages"]
        leg_launches = card["stages"]["train_wdepth"]["launches"]
        missing = [k for k in VDN_CYCLE_KERNELS if not leg_launches[k]]
        if missing:
            raise SystemExit(f"vdn_cycle {name}: not launched in the wdepth leg: {missing}")
    values = {"base_psnr": full.get("base_object_masked_psnr_res2"),
              "base_eikonal": full.get("base_eikonal"),
              "wdepth_psnr": full.get("wdepth_object_masked_psnr_res2"),
              "wdepth_eikonal": full.get("wdepth_eikonal"),
              "depth_loss_first": full.get("distillation", {}).get("depth_loss_first"),
              "depth_loss_last": full.get("distillation", {}).get("depth_loss_last"),
              "depth_mean": full.get("depth_export", {}).get("depth_mean"),
              "leg_wdepth_psnr": leg.get("wdepth_object_masked_psnr_res2"),
              "leg_wdepth_eikonal": leg.get("wdepth_eikonal"),
              "leg_depth_loss_first": leg.get("distillation", {}).get("depth_loss_first")}
    bad = {k: v for k, v in values.items() if not isinstance(v, float) or not math.isfinite(v)}
    flags = (full.get("distillation", {}).get("all_losses_finite"),
             leg.get("distillation", {}).get("all_losses_finite"),
             full.get("depth_export", {}).get("depth_finite"),
             full.get("vdn_features", {}).get("finite"))
    if bad or flags != (True, True, True, True) \
            or full.get("vdn_features", {}).get("shape") != [1, 96, 32, 32] \
            or not all(r.get(f"{p}_geometry", {}).get("mesh_res") == 128
                       for r, p in ((full, "base"), (full, "wdepth"), (leg, "wdepth"))):
        raise SystemExit(f"vdn_cycle: report values {values}, flags {flags}, features "
                         f"{full.get('vdn_features')}")
    print(f"[vdn_cycle] {' '.join(VDN_CYCLE_ARGS)}: wall {wall:.1f} s (both runs); base "
          f"Chamfer {full['base_geometry'].get('chamfer')}, wdepth "
          f"{full['wdepth_geometry'].get('chamfer')}, skip-to-wdepth "
          f"{leg['wdepth_geometry'].get('chamfer')}; launches {launches}; {card_line()}")
    return {"launches": launches, "wall_s": wall, "stages": stages, "values": values}


# ---------------------------------------------------------------------------
# the split-operand f32 mode of K2-K5 (JAX's default precision)
# ---------------------------------------------------------------------------

# the split kernels against the plain versions with f32 operands (torch's
# f32 matmul on the card, TF32 off): forwards within SPLIT_FWD_TOL * max(1,
# max|plain|), every backward output within SPLIT_BWD_TOL relative L2 (3xTF32
# products summed in another order than cuBLAS's f32 ones). A relu whose
# pre-activation lies within that summation noise of zero can take its mask
# the other way, and the row's delta then differs wholly: over 65,536 rows x
# 1,024 relus a few dozen do (measured 5e-4-2.7e-3 relative L2 on the K3/K5
# outputs past the first relu, 1e-6 before it). So a backward is held at
# SPLIT_BWD_TOL on the rows with no pre-activation within KINK_EPS of the
# layer's RMS of zero (an f64 forward finds them: 99% of the rows), and on
# every row at SPLIT_BWD_ALL_TOL.
SPLIT_FWD_TOL, SPLIT_BWD_TOL, SPLIT_BWD_ALL_TOL, KINK_EPS = 1e-4, 1e-4, 1e-2, 1e-5
SPLIT_NAMES = ("render_fwd_f32", "render_bwd_f32", "nerf_fwd_f32", "nerf_bwd_f32",
               "dw_contract_f32")
BF16_NAMES = ("render_fwd", "render_bwd", "nerf_fwd", "nerf_bwd", "dw_contract")
# launches a call of K2, K3, K4 and K5 in the split mode (PERF.md section 6):
# one split launch a layer plus the call's weight images, the embeddings and
# their VJPs (K2 with the idr head); the dpt head adds one to K5's; the
# contraction launches twice a backward. In the bf16 mode each wrapper
# launches once a call, the contraction once a backward.
SPLIT_PER_CALL = (10, 19, 15, 30)


def per_call(mode: str, dpt: bool) -> dict:
    """{kernel name: launches a call} of K2-K5 and the contraction (a
    backward) in ``mode`` ("f32": the split kernels, or "bf16")."""
    if mode == "bf16":
        return dict.fromkeys(BF16_NAMES, 1)
    k2, k3, k4, k5 = SPLIT_PER_CALL
    return dict(zip(SPLIT_NAMES, (k2, k3, k4, k5 + dpt, 2)))


def check_calls(tag: str, launches: dict, mode: str, calls, dpt: bool = False) -> None:
    """``launches`` (a path's counts) are K2, K3, K4 and K5 called ``calls``
    times in ``mode``, the contraction once a backward, K1 launched, and no
    K2-K5 launch in the other mode."""
    pc = per_call(mode, dpt)
    k2, k3, k4, k5 = calls
    want = {k: c * pc[k] for k, c in zip(pc, (k2, k3, k4, k5, k3 + k5))}
    got = {k: launches[k] for k in pc}
    stray = [k for k in BF16_NAMES + SPLIT_NAMES if k not in pc and launches[k]]
    if got != want or stray or not launches["sdf_fwd"]:
        raise SystemExit(f"{tag}: launches {got}, expected {want} ({mode} operands) with K1 "
                         f"launched and no {stray}")


def check_step_calls(tag: str, timed: dict, mode: str, calls, dpt: bool = False) -> None:
    """check_calls on each timed window's launches a step (time_train_steps)."""
    for core, rec in timed.items():
        for m in ("replay", "eager"):
            if m in rec:
                check_calls(f"{tag} {core} {m}, a step", rec[m]["launches_per_step"], mode, calls,
                            dpt)


def timed_launches(timed: dict) -> dict:
    """The launches of a time_train_steps run's timed windows."""
    total: dict = {}
    for rec in timed.values():
        for m in ("replay", "eager"):
            if m in rec:
                for k, v in rec[m]["launches_per_step"].items():
                    total[k] = total.get(k, 0) + round(v * TIMED_STEPS * len(rec[m]["ms_per_step"]))
    return total
F32_PRODUCTS = "products only: one f32 torch.matmul per layer, TF32 off"


def _split_fwd_check(name, run, plain) -> float:
    """Two launches bit for bit equal, each output within SPLIT_FWD_TOL of
    its plain version -> the largest abs error."""
    import torch

    got, again, want = run(), run(), plain()
    torch.cuda.synchronize()
    pairs = [(g, a, w) for g, a, w in zip(got, again, want) if w is not None]
    if not all(torch.equal(g, a) and bool(torch.isfinite(g).all()) for g, a, _ in pairs):
        raise SystemExit(f"{name}: not finite, or two launches differ")
    err = max(float((g - w).abs().max()) for g, _, w in pairs)
    tol = SPLIT_FWD_TOL * max(1.0, max(float(w.abs().max()) for _, _, w in pairs))
    print(f"[split] {name}: max_abs_err={err:.3e} tol={tol:.3e}; two launches bit-identical")
    if not err <= tol:
        raise SystemExit(f"{name}: the split kernel disagrees with its plain version")
    return err


def _kink_free(zs, rows: int):
    """Rows none of whose pre-activations ``zs`` ([rows, width] each, f64)
    lies within KINK_EPS of its layer's RMS of zero."""
    import torch

    near = torch.zeros(rows, dtype=torch.bool, device=zs[0].device)
    for z in zs:
        near |= (z.abs() < KINK_EPS * z.square().mean().sqrt()).any(1)
    return ~near


def _render_relu_inputs(plan, pts, nrm, dirs, feat, ws, bs):
    """The colour head's relu inputs in f64, layer by layer."""
    from vdnerf_tpu_torch.models.embedder import embed
    from vdnerf_tpu_torch.ops.kernels import fused_mlp

    x = fused_mlp._render_concat(pts, embed(dirs, plan[1]), nrm, feat, plan[0]).double()
    zs = []
    for w, b in zip(ws[:-1], bs[:-1]):
        zs.append(x @ w.double() + b.double())
        x = zs[-1].clamp_min(0.0)
    return zs


def _nerf_relu_inputs(nplan, pts, views, tw, tb, hw, hb):
    """The background NeRF's relu inputs (trunk, views0) in f64."""
    import torch

    from vdnerf_tpu_torch.models.embedder import embed

    multires, multires_view, skips = nplan[:3]
    emb = embed(pts, multires).double()
    h, zs = emb, []
    for i, (w, b) in enumerate(zip(tw, tb)):
        zs.append(h @ w.double() + b.double())
        h = zs[-1].clamp_min(0.0)
        if i in skips:
            h = torch.cat([emb, h], -1)
    feature = h @ hw[1].double() + hb[1].double()
    zs.append(torch.cat([feature, embed(views, multires_view).double()], -1) @ hw[2].double()
              + hb[2].double())
    return zs


def _split_bwd_check(name, run, plain, keep=None) -> float:
    """Two launches bit for bit equal; every output within SPLIT_BWD_ALL_TOL
    relative L2 of its plain version and, run again on the ``keep`` rows (a
    function of the inputs' row subset), within SPLIT_BWD_TOL -> the largest
    abs error."""
    if keep is None:
        return _split_bwd_compare(name, run, plain, SPLIT_BWD_TOL)
    err = _split_bwd_compare(f"{name} all rows", run, plain, SPLIT_BWD_ALL_TOL)
    mask, run_k, plain_k = keep
    print(f"[split] {name}: {int(mask.sum())} of {mask.numel()} rows free of near-kink relus")
    return max(err, _split_bwd_compare(f"{name} kink-free rows", run_k, plain_k, SPLIT_BWD_TOL))


def _split_bwd_compare(name, run, plain, tol) -> float:
    import torch

    got, again, want = run(), run(), plain()
    torch.cuda.synchronize()
    worst, errs = (0.0, ""), []
    for i, (g, a, w) in enumerate(zip(got, again, want)):
        if not bool(torch.isfinite(g).all()) or not torch.equal(g, a):
            raise SystemExit(f"{name} #{i}: not finite, or two launches differ")
        errs.append(float((g - w).abs().max()))
        if float(w.abs().max()) > 0:
            worst = max(worst, (_rel_l2(g, w), f"#{i} {tuple(w.shape)}"))
    print(f"[split] {name}: tensors={len(errs)} max_abs_err={max(errs):.3e} worst rel L2 "
          f"{worst[0]:.3e} at {worst[1]} (tol {tol:.0e}); two launches bit-identical")
    if not worst[0] <= tol:
        raise SystemExit(f"{name}: the split kernel disagrees with its plain version")
    return max(errs)


def split_kernel_phase(device) -> dict:
    """The split-operand f32 mode of K2-K5 and of the dW contraction at full
    width, each against its plain version with f32 operands, at the rows the
    main paths give it plus a ragged tail -> {name: record}. Timed by CUDA
    events: ``ms`` through the wrapper, ``bf16_ms`` the bf16 mode's wrapper on
    the same inputs, ``plain_ms``, and ``library_ms`` the yardstick, f32
    ``torch.matmul`` of the same products with TF32 off (never called by the
    port). The bound: three TF32 products per f32 product over the TF32 peak,
    against each input read and each output written once."""
    import torch

    from vdnerf_tpu_torch.ops.kernels import fused_mlp

    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator().manual_seed(1)
    rec = {}
    r_dims = [(289, 256), (256, 256), (256, 256), (256, 256), (256, 3)]
    ws, bs = _weights(gen, r_dims, device)
    w96, b96 = _weights(gen, [(256, 96)], device)
    heads = {3: (ws, bs), 96: (ws[:4] + w96, bs[:4] + b96)}
    plan = ("idr", 4, True)

    def r_inputs(rows):
        t = [torch.randn(rows, 3, generator=gen) for _ in range(3)]
        t[2] = t[2] / t[2].norm(dim=-1, keepdim=True)
        return [x.to(device) for x in (*t, torch.randn(rows, 256, generator=gen) * 0.5)]

    def dims_of(d_out):
        return r_dims[:4] + [(256, d_out)]

    # K2: a serving chunk's rows, then a step's faithful core with 3 and 96 outputs
    errs, shapes = [], []
    for rows, d_out in ((K2_ROWS, 3), (CORE_ROWS[0], 3), (CORE_ROWS[0], 96)):
        w_, b_ = heads[d_out]
        inp = r_inputs(rows + RAGGED)
        errs.append(_split_fwd_check(
            f"render_fwd_f32(rows={rows + RAGGED}, d_out={d_out})",
            lambda: [fused_mlp._render_launch_f32(plan, *inp, w_, b_)[0]],
            lambda: [fused_mlp.render_net_plain(plan, *inp, w_, b_, mm=f32)]))
        inp = [x[:rows].contiguous() for x in inp]
        flops_row = 2 * sum(k * n for k, n in dims_of(d_out))
        wbytes = sum(w.numel() + b.numel() for w, b in zip(w_, b_)) * 4
        b_ms, b_by = bound(rows, 3 * flops_row, (3 * 3 + 256 + d_out) * 4, wbytes, PEAK_TF32_S)
        shapes.append({
            "rows": rows, "d_out": d_out, "flops_row": flops_row,
            "ms": time_ms(lambda: fused_mlp._render_launch_f32(plan, *inp, w_, b_), 5),
            "bf16_ms": time_ms(lambda: fused_mlp._render_launch(plan, *inp, w_, b_), 5),
            "plain_ms": time_ms(lambda: fused_mlp.render_net_plain(plan, *inp, w_, b_, mm=f32), 5),
            "library_ms": _time_products(dims_of(d_out), rows, f32, device),
            "library": F32_PRODUCTS, "bound_ms": b_ms, "bound_by": b_by,
        })
    rec["render_fwd_f32"] = {"max_abs_err": max(errs), "flops_row": shapes[0]["flops_row"],
                             "shapes": shapes}

    # K3: each core width of a training step, the colour head and the depth head
    def flat(o):
        return [t for x in o for t in (x if isinstance(x, list) else [x])]

    errs, shapes = [], []
    for rows, d_out in ((CORE_ROWS[0], 3), (CORE_ROWS[0], 96), (CORE_ROWS[1], 3),
                        (CORE_ROWS[1], 96), (CORE_ROWS[2], 3), (CORE_ROWS[2], 96)):
        w_, b_ = heads[d_out]
        inp = r_inputs(rows + RAGGED)
        g = torch.randn(rows + RAGGED, d_out, generator=gen).to(device)
        keep = _kink_free(_render_relu_inputs(plan, *inp, w_, b_), rows + RAGGED)
        inp_k, g_k = [x[keep].contiguous() for x in inp], g[keep].contiguous()
        errs.append(_split_bwd_check(
            f"render_bwd_f32(rows={rows + RAGGED}, d_out={d_out})",
            lambda: flat(fused_mlp._render_bwd_launch_f32(plan, *inp, w_, b_, g)),
            lambda: flat(fused_mlp.render_net_bwd_plain(plan, *inp, w_, b_, g, mm=f32)),
            (keep, lambda: flat(fused_mlp._render_bwd_launch_f32(plan, *inp_k, w_, b_, g_k)),
             lambda: flat(fused_mlp.render_net_bwd_plain(plan, *inp_k, w_, b_, g_k, mm=f32)))))
        if rows != CORE_ROWS[0]:
            continue
        inp, g = [x[:rows].contiguous() for x in inp], g[:rows].contiguous()
        flops_row = 3 * 2 * sum(k * n for k, n in dims_of(d_out))
        wbytes = sum(w.numel() + b.numel() for w, b in zip(w_, b_)) * 8
        b_ms, b_by = bound(rows, 3 * flops_row, (2 * (3 * 3 + 256) + d_out) * 4, wbytes,
                           PEAK_TF32_S)
        shapes.append({
            "rows": rows, "d_out": d_out, "flops_row": flops_row,
            "ms": time_ms(lambda: fused_mlp._render_bwd_launch_f32(plan, *inp, w_, b_, g), 3),
            "bf16_ms": time_ms(lambda: fused_mlp._render_bwd_launch(plan, *inp, w_, b_, g), 3),
            "plain_ms": time_ms(lambda: fused_mlp.render_net_bwd_plain(plan, *inp, w_, b_, g,
                                                                       mm=f32), 3),
            "library_ms": _time_products(dims_of(d_out), rows, f32, device, backward=True),
            "library": F32_PRODUCTS + ", with each layer's dX and dW products",
            "bound_ms": b_ms, "bound_by": b_by,
        })
    rec["render_bwd_f32"] = {"max_abs_err": max(errs), "flops_row": shapes[0]["flops_row"],
                             "shapes": shapes}

    # K4 / K5: a training step's outside rows and the learn confs' 81,920,
    # with and without the dpt head; K4 also at a learn serving chunk's rows
    t_dims = [(84, 256)] + [(256, 256)] * 4 + [(340, 256)] + [(256, 256)] * 2
    tw, tb = _weights(gen, t_dims, device)
    h_dims = [(256, 1), (256, 256), (283, 128), (128, 3), (128, 96)]
    hw, hb = _weights(gen, h_dims, device)

    def n_inputs(rows):
        p = torch.randn(rows, 3, generator=gen)
        p = p / p.norm(dim=-1, keepdim=True)
        v = torch.randn(rows, 3, generator=gen)
        return (torch.cat([p, torch.rand(rows, 1, generator=gen)], -1).to(device),
                (v / v.norm(dim=-1, keepdim=True)).to(device))

    def nerf_args(has_dpt):
        return ((10, 4, (4,), 8, has_dpt), tw, tb, hw if has_dpt else hw[:4],
                hb if has_dpt else hb[:4])

    errs, shapes = [], []
    for rows, has_dpt in ((K5_ROWS, False), (K5_ROWS, True), (LEARN_ROWS, False),
                          (LEARN_ROWS, True), (LEARN_K4_ROWS, False)):
        nplan, tw_, tb_, hw_, hb_ = nerf_args(has_dpt)
        pts4, views = n_inputs(rows + RAGGED)
        errs.append(_split_fwd_check(
            f"nerf_fwd_f32(rows={rows + RAGGED}, has_dpt={has_dpt})",
            lambda: list(fused_mlp._nerf_launch_f32(nplan, pts4, views, tw_, tb_, hw_, hb_)[0]),
            lambda: list(fused_mlp.nerf_plain(nplan, pts4, views, tw_, tb_, hw_, hb_, mm=f32))))
        if has_dpt:
            continue
        pts4, views = (x[:rows].contiguous() for x in (pts4, views))
        dims = t_dims + h_dims[:4]
        flops_row = 2 * sum(k * n for k, n in dims)
        wbytes = sum(w.numel() + b.numel() for w, b in zip(tw + hw_, tb + hb_)) * 4
        b_ms, b_by = bound(rows, 3 * flops_row, (4 + 3 + 1 + 3) * 4, wbytes, PEAK_TF32_S)
        shapes.append({
            "rows": rows, "flops_row": flops_row,
            "ms": time_ms(lambda: fused_mlp._nerf_launch_f32(nplan, pts4, views, tw_, tb_, hw_,
                                                             hb_), 3),
            "bf16_ms": time_ms(lambda: fused_mlp._nerf_launch(nplan, pts4, views, tw_, tb_, hw_,
                                                              hb_), 3),
            "plain_ms": time_ms(lambda: fused_mlp.nerf_plain(nplan, pts4, views, tw_, tb_, hw_,
                                                             hb_, mm=f32), 3),
            "library_ms": _time_products(dims, rows, f32, device),
            "library": F32_PRODUCTS, "bound_ms": b_ms, "bound_by": b_by,
        })
    rec["nerf_fwd_f32"] = {"max_abs_err": max(errs), "flops_row": shapes[0]["flops_row"],
                           "shapes": shapes}

    errs, shapes = [], []
    for rows, has_dpt in ((K5_ROWS, False), (K5_ROWS, True), (LEARN_ROWS, False),
                          (LEARN_ROWS, True)):
        nplan, tw_, tb_, hw_, hb_ = nerf_args(has_dpt)
        pts4, views = n_inputs(rows + RAGGED)
        gs = [torch.randn(rows + RAGGED, k, generator=gen).to(device)
              for k in ((1, 3, 96) if has_dpt else (1, 3))]
        args = (nplan, pts4, views, tw_, tb_, hw_, hb_, *gs)
        keep = _kink_free(_nerf_relu_inputs(nplan, pts4, views, tw_, tb_, hw_, hb_),
                          rows + RAGGED)
        args_k = (nplan, pts4[keep].contiguous(), views[keep].contiguous(), tw_, tb_, hw_, hb_,
                  *(x[keep].contiguous() for x in gs))
        errs.append(_split_bwd_check(
            f"nerf_bwd_f32(rows={rows + RAGGED}, has_dpt={has_dpt})",
            lambda: flat(fused_mlp._nerf_bwd_launch_f32(*args)),
            lambda: flat(fused_mlp.nerf_bwd_plain(*args, mm=f32)),
            (keep, lambda: flat(fused_mlp._nerf_bwd_launch_f32(*args_k)),
             lambda: flat(fused_mlp.nerf_bwd_plain(*args_k, mm=f32)))))
        pts4, views = (x[:rows].contiguous() for x in (pts4, views))
        gs = [x[:rows].contiguous() for x in gs]
        args = (nplan, pts4, views, tw_, tb_, hw_, hb_, *gs)
        dims = t_dims + (h_dims if has_dpt else h_dims[:4])
        flops_row = 3 * 2 * sum(k * n for k, n in dims)
        wbytes = sum(w.numel() + b.numel() for w, b in zip(tw + hw_, tb + hb_)) * 8
        b_ms, b_by = bound(rows, 3 * flops_row,
                           (4 + 3 + 1 + 3 + (96 if has_dpt else 0) + 4 + 3) * 4, wbytes,
                           PEAK_TF32_S)
        shapes.append({
            "rows": rows, "has_dpt": has_dpt, "flops_row": flops_row,
            "ms": time_ms(lambda: fused_mlp._nerf_bwd_launch_f32(*args), 3),
            "bf16_ms": time_ms(lambda: fused_mlp._nerf_bwd_launch(*args), 3),
            "plain_ms": time_ms(lambda: fused_mlp.nerf_bwd_plain(*args, mm=f32), 3),
            "library_ms": _time_products(dims, rows, f32, device, backward=True),
            "library": F32_PRODUCTS + ", with each layer's dX and dW products",
            "bound_ms": b_ms, "bound_by": b_by,
        })
    rec["nerf_bwd_f32"] = {"max_abs_err": max(errs), "flops_row": shapes[0]["flops_row"],
                           "shapes": shapes}

    # the dW contraction alone: every layer of the colour head (K3) and of the
    # NeRF with dpt (K5) on seeded f32 layer inputs and deltas
    errs, shapes = [], []
    ops = fused_mlp._SplitOps(device, "dw_contract_f32")
    for rows, meta in ((CORE_ROWS[0], fused_mlp._render_meta(plan, r_inputs(1)[3], ws, bs,
                                                             device, f32)[2]),
                       (K5_ROWS, fused_mlp._nerf_meta(nerf_args(True)[0], 4, tw, tb, hw, hb,
                                                      device, f32)[2])):
        layers = fused_mlp._layers_of(meta)
        pairs = [(torch.relu(torch.randn(rows, Kp, generator=gen)).to(device),
                  torch.randn(rows, Np, generator=gen).to(device))
                 for _, _, Kp, Np, _, _ in layers]

        def plain():
            return [torch.cat([(x.t() @ d).reshape(-1) for x, d in pairs]),
                    torch.cat([d.sum(0) for _, d in pairs])]

        errs.append(_split_bwd_check(f"dw_contract_f32(rows={rows}, layers={len(layers)})",
                                     lambda: list(ops.dw(pairs, layers)), plain))
        macs = sum(Kp * Np for _, _, Kp, Np, _, _ in layers)
        io = rows * sum(Kp + Np for _, _, Kp, Np, _, _ in layers) * 4 + macs * 4
        b_ms, b_by = bound(rows, 3 * 2 * macs, 0, io, PEAK_TF32_S)
        shapes.append({
            "rows": rows, "layers": len(layers), "flops_row": 2 * macs,
            "ms": time_ms(lambda: ops.dw(pairs, layers), 5),
            "plain_ms": time_ms(plain, 5),
            "library_ms": time_ms(lambda: [torch.matmul(x.t(), d) for x, d in pairs], 5),
            "library": "one f32 torch.matmul per layer, TF32 off",
            "bound_ms": b_ms, "bound_by": b_by,
        })
    rec["dw_contract_f32"] = {"max_abs_err": max(errs), "flops_row": shapes[0]["flops_row"],
                              "shapes": shapes}
    for name, r in rec.items():
        for s in r["shapes"]:
            print(f"[split] {name} rows={s['rows']}: ms {s['ms']:.3f}, bf16 mode "
                  f"{s.get('bf16_ms', float('nan')):.3f}, plain {s['plain_ms']:.3f}, f32 "
                  f"matmul yardstick {s['library_ms']:.3f}, bound {s['bound_ms']:.3f} "
                  f"({s['bound_by']})")
    return rec


# the SDF block's shapes at full width: a hidden layer, the layer before the
# skip (256 - 39), the 6-band embedding; rows per launch at a womsk step's
# resampled core (512 rays x 96 samples) and at a views chunk
SDFB_C, SDFB_SKIP_W, SDFB_D0, SDFB_L = 256, 217, 39, 6
SDFB_ROWS = (CORE_ROWS[1], K2_ROWS)
SDFB_LIBRARY = ("torch's own softplus / sigmoid ops where the stage has one (act, tangent, up, "
                "down); the plain formula for the embedding's stages")


def _sdfb_stages(n: int, gen, device) -> list:
    """The seven stages of ops/sdf_block.py at ``n`` rows, each as (name,
    args, which of the args it writes, returns column sums, f32 words read
    and written a row, torch's library version or None)."""
    import torch
    import torch.nn.functional as F

    from vdnerf_tpu_torch.ops import sdf_block as sb

    def rand(*shape, s=1.0):
        return (s * torch.randn(*shape, generator=gen)).to(device)

    C, D0, c = SDFB_C, SDFB_D0, sb._C
    z = rand(n, C, s=0.05)  # 100 z around +-5: the softplus's bend
    z[::7] *= 20.0  # and far into both tails
    e, q, rbar, abar, s2 = rand(n, D0), rand(n, C), rand(n, C), rand(n, C), rand(n, C)
    tail, E, gbar = rand(n, C)[:, -D0:], rand(n, D0), rand(n, 3)
    out, qbar = torch.empty(n, C, device=device), torch.empty(n, C, device=device)
    s2o, eo = torch.empty(n, C, device=device), torch.empty(n, D0, device=device)
    E_out = torch.empty(n, D0, device=device)

    def lib_up(*a):
        sg = torch.sigmoid(100.0 * z)
        torch.mul(rbar, sg, out=qbar)
        torch.mul(rbar * q, 100.0 * sg * (1 - sg), out=s2o)

    def lib_down(*a):
        torch.addcmul(s2, abar, torch.sigmoid(100.0 * z), out=out)
        return out.sum(0)

    return [
        ("act", (z, out), (1,), False, 2 * C, lambda *a: out.copy_(F.softplus(z, beta=100.0))),
        ("tangent", (q, None, 1.0, z, out), (4,), False, 3 * C,
         lambda *a: torch.mul(q, torch.sigmoid(100.0 * z), out=out)),
        ("up", (rbar, q, None, 1.0, z, qbar, s2o), (5, 6), False, 5 * C, lib_up),
        ("down", (abar, 1.0, z, s2, out), (4,), True, 4 * C, lib_down),
        ("embed_grad", (q[:, :D0], [tail], c, e, SDFB_L, 1.0, E_out), (6,), False,
         4 * D0 + 3, None),
        ("embed_cot", (gbar, e, SDFB_L, 1.0, eo), (4,), False, 2 * D0 + 3, None),
        ("embed_vjp", (abar[:, :D0], [tail], c, gbar, E, e, SDFB_L, 1.0), (), False,
         4 * D0 + 6, None),
    ]


def sdf_block_phase(device) -> dict:
    """The SDF block's Function (``ops/sdf_block.py``) at full width -> {name:
    record}. Each of its seven elementwise stages through its wrapper on card
    tensors against its plain formula (``<stage>_plain``) on the same tensors,
    at a training step's 49,152 rows and a views chunk's 393,216: every
    output within 1e-5 relative and 1e-6 of its scale (ulps of expf /
    log1pf), the column sums within 1e-4 of the largest (the kernel sums per
    CTA of 8 rows). Timed by CUDA events: ``ms`` the wrapper, ``plain_ms``
    the plain formula, ``library_ms`` torch's own ops for the stage
    (SDFB_LIBRARY), ``bound_ms`` each tensor of the stage read or written
    once at the HBM3 rate. Then the whole block (8x256, the skip at 4, 6
    bands): a step's forward and backward at 49,152 points and a views
    chunk's forward at 393,216, through the Function and through autograd's
    route, each output and gradient within 1e-4 of its largest entry, with
    both routes' ms and peak memory."""
    import torch

    from vdnerf_tpu_torch.models.fields import SDFConfig, SDFNetwork
    from vdnerf_tpu_torch.ops import sdf_block as sb
    from vdnerf_tpu_torch.ops.kernels import build

    gen = torch.Generator().manual_seed(3)
    errs, shapes = [], []
    for rows in SDFB_ROWS:
        for name, args, writes, colsum, words, library in _sdfb_stages(rows, gen, device):
            kernel, plain = getattr(sb, name), getattr(sb, f"{name}_plain")
            before = build.LAUNCHES["sdf_block"]
            got = kernel(*args)
            got = [args[i].clone() for i in writes] + ([] if got is None else [got])
            if build.LAUNCHES["sdf_block"] != before + 1:
                raise SystemExit(f"sdf_block {name}: the wrapper did not launch once")
            want = plain(*args)
            want = [args[i] for i in writes] + ([] if want is None else [want])
            torch.cuda.synchronize()
            for i, (g, w) in enumerate(zip(got, want)):
                scale = float(w.abs().max())
                sums = colsum and i == len(got) - 1
                tol = (0.0, 1e-4 * scale) if sums else (1e-5, 1e-6 * max(1.0, scale))
                err = float((g - w).abs().max())
                if not bool(((g - w).abs() <= tol[1] + tol[0] * w.abs()).all()):
                    raise SystemExit(f"sdf_block {name} (rows={rows}): output {i} off its plain "
                                     f"formula by {err:.3e}")
                errs.append(err)
            b_ms, b_by = bound(rows, 0, words * 4, 0, PEAK_F32_S)
            shapes.append({
                "stage": name, "rows": rows, "ms": time_ms(lambda: kernel(*args)),
                "plain_ms": time_ms(lambda: plain(*args)),
                "library_ms": time_ms(lambda: (library or plain)(*args)),
                "bound_ms": b_ms, "bound_by": b_by,
            })
    for s in shapes:
        print(f"[sdf_block] {s['stage']} rows={s['rows']}: ms {s['ms']:.4f}, plain "
              f"{s['plain_ms']:.4f}, library {s['library_ms']:.4f}, bound {s['bound_ms']:.4f} "
              f"({s['bound_by']})")

    net = SDFNetwork(SDFConfig(), torch.Generator().manual_seed(0)).to(device)
    params = list(net.parameters())
    block = {}
    for rows, train in ((SDFB_ROWS[0], True), (SDFB_ROWS[1], False)):
        pts = (0.8 * (2 * torch.rand(rows, 3, generator=gen) - 1)).to(device)
        w_feat, w_grad = torch.randn(rows, 256, generator=gen).to(device), \
            torch.randn(rows, 3, generator=gen).to(device)

        def call(fn):
            if not train:
                with torch.no_grad():
                    return [t.clone() for t in fn(pts)]
            sdf, grad, feat = fn(pts)
            loss = ((sdf ** 2).sum() + ((grad.norm(dim=-1) - 1) ** 2).sum()
                    + (feat * w_feat).sum() + (grad * w_grad).sum())
            return [sdf.detach(), grad.detach(), feat.detach()] + list(
                torch.autograd.grad(loss, params))

        res, rec = {}, {}
        for route, fn in (("fused", net.sdf_value_grad_feat),
                          ("autograd", net._value_grad_feat_autograd)):
            before = build.LAUNCHES["sdf_block"]
            res[route] = call(fn)
            torch.cuda.synchronize()
            launches = build.LAUNCHES["sdf_block"] - before
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            rec[route] = {"ms": time_ms(lambda: call(fn), 5), "stage_launches": launches,
                          "peak_bytes": torch.cuda.max_memory_allocated() - base}
        gaps = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(res["fused"], res["autograd"])]
        key = "train_step" if train else "views_chunk"
        block[key] = {"rows": rows, **rec, "max_rel_gap": max(gaps)}
        print(f"[sdf_block] the block, {key} ({rows} points): Function {rec['fused']['ms']:.3f} "
              f"ms, peak {rec['fused']['peak_bytes'] / 1e9:.3f} GB, {rec['fused']['stage_launches']}"
              f" stage launches; autograd's route {rec['autograd']['ms']:.3f} ms, peak "
              f"{rec['autograd']['peak_bytes'] / 1e9:.3f} GB; worst gap {max(gaps):.3e} (tol 1e-4)")
        if not max(gaps) <= 1e-4 or rec["autograd"]["stage_launches"] \
                or rec["fused"]["stage_launches"] != (34 if train else 17):
            raise SystemExit(f"sdf_block: the block {key} disagrees with autograd's route: {block}")
    return {"sdf_block": {"max_abs_err": max(errs), "flops_row": 0, "shapes": shapes,
                          "library": SDFB_LIBRARY, "block": block}}


def fused_phase(tmp: str, device, runs: dict) -> dict:
    """JAX's fused path, the opt-in: ``VDNERF_FUSED=1`` under the f32
    policy, so K2-K5 run their bf16 operand mode. ``--mode train`` of
    womsk_white_tpu through the CLI (the training phase's checks, bf16 K2-K5
    counted, no split launch); the replayed steps of womsk and of each
    default-mode recipe in ``runs`` ({name: (conf path, K2-K5 calls a step,
    dpt)}) timed beside the default mode's (bf16 K2-K5 once a call, no split
    launch); one full-width step's gradients against the CPU with bf16
    operands (loss 1e-3 relative, every gradient 2^-6 relative L2)."""
    os.environ["VDNERF_FUSED"] = "1"
    try:
        train = train_phase(tmp, "womsk_white_tpu", TRAIN_KEYS, exp="exp_fused", mode="bf16")
        steps = {"womsk_white_tpu": time_train_steps(train["conf_path"], modes=("replay",),
                                                     profile=False)}
        check_step_calls("[fused] womsk_white_tpu", steps["womsk_white_tpu"], "bf16", (1, 1, 1, 1))
        for name, (conf_path, calls, dpt) in runs.items():
            steps[name] = time_train_steps(conf_path, modes=("replay",), profile=False)
            check_step_calls(f"[fused] {name}", steps[name], "bf16", calls, dpt)
        grad = gradient_check(train["conf"], device, mlp="bf16")
    finally:
        os.environ.pop("VDNERF_FUSED")
    return {"train": train, "steps": steps, "gradient_check": grad}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from vdnerf_tpu_torch.ops.kernels import build
    from vdnerf_tpu_torch.train.config import TrainConfig
    from vdnerf_tpu_torch.utils.device import configure_numerics

    device = torch.device("cuda:0")
    configure_numerics()
    print(card_line())
    # JAX's default precision in every phase but the fused one, which sets
    # VDNERF_FUSED=1 for its length
    os.environ.pop("VDNERF_FUSED", None)

    marks, phase_s = [time.perf_counter()], {}

    def mark(name):  # the wall seconds since the previous mark
        marks.append(time.perf_counter())
        phase_s[name] = round(marks[-1] - marks[-2], 1)

    build.build_all()
    mark("build")
    print(f"[build] kernels built in {phase_s['build']} s")

    kern = kernel_phase(device)
    mark("kernel")
    split_kern = split_kernel_phase(device)
    mark("split_kernel")
    sdfb = sdf_block_phase(device)
    mark("sdf_block")
    with tempfile.TemporaryDirectory() as tmp:
        res = slice_phase(tmp)
        ref = reference_check(res["conf"], device)
        mark("slice")
        train = train_phase(tmp)
        dispatch = dispatch_check(tmp, train)
        steps = time_train_steps(train["conf_path"])
        check_step_calls("[train womsk_white_tpu]", steps, "f32", (1, 1, 1, 1))
        mark("train")
        par = parallel_phase(tmp, train, steps)
        mark("parallel")
        grads = {"womsk_white_tpu": gradient_check(train["conf"], device)}
        mark("grad_womsk")
        mesh = mesh_phase(train, device)
        mark("mesh")
        masked = train_phase(tmp, "wmask_tpu")
        # one replayed and one eager window a core, unprofiled, here and on
        # wdepth (the idle shares of both, PR 17's first chip run, are in
        # PERF.md section 5): the smoke's host work is cut to its time limit
        masked_steps = time_train_steps(masked["conf_path"], modes=("replay", "eager"),
                                        profile=False)
        check_step_calls("[train wmask_tpu]", masked_steps, "f32", (1, 1, 0, 0))
        grads["wmask_tpu"] = gradient_check(masked["conf"], device, "wmask_tpu")
        mark("wmask")
        # the side-car writes image/wavelet_feats/0, which the wdepth confs read
        cycle = cycle_phase(tmp, train, device)
        mark("cycle")
        wdepth = train_phase(tmp, WDEPTH, WDEPTH_KEYS)
        wdepth_steps = time_train_steps(wdepth["conf_path"], modes=("replay", "eager"),
                                        profile=False)
        check_step_calls(f"[train {WDEPTH}]", wdepth_steps, "f32", (2, 2, 1, 1), True)
        wdepth_tcfg = TrainConfig.from_conf(wdepth["conf"])
        past_ramp = wdepth_tcfg.depth_start_iter + wdepth_tcfg.depth_ramp_iters + 1000
        grads[WDEPTH] = gradient_check(wdepth["conf"], device, WDEPTH, step=past_ramp)
        wdepth_serve = serve_wdepth(wdepth)
        mark("wdepth")
        # depth_before_color: the colour head reads the depth features (400
        # padded inputs in the split K2's first layer)
        dbc_conf = write_conf(tmp, "exp_dbc", {**WDEPTH_KEYS, "depth_before_color": "true"},
                              WDEPTH)
        with open(dbc_conf) as f:
            text = f.read()
        with open(dbc_conf, "w") as f:  # the colour head's features widened by the 96
            f.write(text.replace("rendering_network {\n        d_feature = 256",
                                 "rendering_network {\n        d_feature = 352", 1))
        dbc_steps = time_train_steps(dbc_conf, modes=("replay",), profile=False)
        check_step_calls("[train depth_before_color]", dbc_steps, "f32", (2, 2, 1, 1), True)
        if not all(math.isfinite(v) for rec in dbc_steps.values()
                   for v in rec["replay"]["ms_per_step"]):
            raise SystemExit(f"depth_before_color: steps {dbc_steps}")
        mark("depth_before_color")
        # the learned cameras, mask-free and with distillation, on the
        # perturbed cameras of write_scene
        learn = train_phase(tmp, LEARN, LEARN_KEYS)
        learn_dispatch = dispatch_check(tmp, learn)
        grads[LEARN] = gradient_check(learn["conf"], device, LEARN)
        learn_steps = time_train_steps(learn["conf_path"])
        check_step_calls(f"[train {LEARN}]", learn_steps, "f32", (1, 1, 1, 1))
        learn_wdepth = train_phase(tmp, LEARN_WDEPTH, LEARN_WDEPTH_KEYS)
        learn_wdepth_steps = time_train_steps(learn_wdepth["conf_path"])
        check_step_calls(f"[train {LEARN_WDEPTH}]", learn_wdepth_steps, "f32", (2, 2, 1, 1),
                         True)
        lw_tcfg = TrainConfig.from_conf(learn_wdepth["conf"])
        grads[LEARN_WDEPTH] = gradient_check(
            learn_wdepth["conf"], device, LEARN_WDEPTH,
            step=lw_tcfg.depth_start_iter + lw_tcfg.depth_ramp_iters + 1000)
        learn_wdepth_serve = serve_wdepth(learn_wdepth)
        mark("learn")
        # JAX's fused path (VDNERF_FUSED=1): K2-K5 in the bf16 operand mode
        fused = fused_phase(tmp, device, {
            "wmask_tpu": (masked["conf_path"], (1, 1, 0, 0), False),
            WDEPTH: (wdepth["conf_path"], (2, 2, 1, 1), True),
            "depth_before_color": (dbc_conf, (2, 2, 1, 1), True),
            LEARN: (learn["conf_path"], (1, 1, 1, 1), False),
            LEARN_WDEPTH: (learn_wdepth["conf_path"], (2, 2, 1, 1), True)})
        mark("fused")
        # the capture workflow around the learn recipes: COLMAP preparation,
        # the learned poses against the initial and GT ones, the novel views
        novel = {"colmap": colmap_phase(tmp, res["noisy_c2w"]),
                 "showcam": showcam_phase(tmp, learn)}
        t_nv = time.perf_counter()
        novel["interpolate"] = interpolate_phase(train, "interpolate womsk_white_tpu")
        novel["interpolate_learn"] = interpolate_phase(learn, f"interpolate {LEARN}")
        novel["interpolate_s"] = time.perf_counter() - t_nv
        novel["card"] = card_line()
        mark("novel_views")
        # the bf16 SDF block (train.bf16): the steps timed, one step's
        # gradients against the CPU, then the flagship tool
        # (one replayed and one eager window a core, unprofiled: PR 11 and
        # PR 16 recorded this path's idle share)
        bf16_steps = time_train_steps(write_conf(tmp, "exp_bf16", {**TRAIN_KEYS, "bf16": "true"}),
                                      modes=("replay", "eager"), profile=False)
        check_step_calls("[train.bf16]", bf16_steps, "bf16", (1, 1, 1, 1))
        bf16_grad = gradient_check(train["conf"], device, bf16=True, mlp="bf16")
        mark("bf16")
        flagship = flagship_phase(tmp)
        mark("flagship")
        vdn_cycle = vdn_cycle_phase(tmp)
        mark("vdn_cycle")
    phase_s["total"] = round(marks[-1] - marks[0], 1)
    print(f"[phases] wall seconds: {phase_s}")

    # every path's launches, from its own run with the counts set to 0 just
    # before; a timed-steps path counts its timed windows
    paths = {"serve": res["launches"], "train": train["launches"],
             "train_dispatch_eager": dispatch["launches_eager"],
             "mesh": mesh["launches"], "train_wmask": masked["launches"],
             "cycle_getfeats": cycle["getfeats_launches"],
             "train_wdepth": wdepth["launches"], "serve_wdepth": wdepth_serve["launches"],
             "steps_depth_before_color": timed_launches(dbc_steps),
             "train_learn": learn["launches"], "train_learn_wdepth": learn_wdepth["launches"],
             "serve_learn_wdepth": learn_wdepth_serve["launches"],
             "interpolate": novel["interpolate"]["launches"],
             "interpolate_learn": novel["interpolate_learn"]["launches"],
             "train_nccl_world_of_1": par["nccl_launches"],
             "step_gloo_rank_0": par["gloo_launches"][0],
             "step_gloo_rank_1": par["gloo_launches"][1],
             "fused_train": fused["train"]["launches"],
             "fused_steps": timed_launches({f"{n} {c}": r for n, t in fused["steps"].items()
                                            for c, r in t.items()}),
             "steps_train_bf16": timed_launches(bf16_steps),
             "flagship": flagship["launches"], "vdn_cycle": vdn_cycle["launches"]}
    # the bf16 policy keeps the SDF block on autograd's route
    sdfb_bf16 = {p: paths[p].get("sdf_block", 0)
                 for p in ("steps_train_bf16", "flagship", "vdn_cycle")}
    if any(sdfb_bf16.values()):
        raise SystemExit(f"the bf16 policy launched the SDF block's stages: {sdfb_bf16}")
    kernels = []
    for name, r in list(kern.items()) + list(split_kern.items()) + list(sdfb.items()):
        main_shape = r["shapes"][0]
        by_path = {p: launches.get(name, 0) for p, launches in paths.items()}
        if not sum(by_path.values()):
            raise SystemExit(f"{name} was launched on no path")
        base = name[:-4] if name.endswith("_f32") else name
        rec = {
            "name": name, "route": "cuda", "source": SOURCE[base],
            "replaces": REPLACES[base], "launches": sum(by_path.values()),
            "max_abs_err": r["max_abs_err"], "ms": main_shape["ms"],
            "plain_ms": main_shape["plain_ms"], "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"], "library_ms": main_shape.get("library_ms"),
            "launches_by_path": by_path,
            "rows": main_shape["rows"], "flops_row": r["flops_row"], "shapes": r["shapes"],
        }
        if "block" in r:  # the SDF block's stages: rec's ms and bounds are the first's
            rec.update(library=r["library"], block=r["block"])
        elif base == name:
            rec["kernel_ms"] = main_shape.get("kernel_ms")
        else:
            rec.update(bf16_ms=main_shape.get("bf16_ms"), operands="f32 (3xTF32 split)")
        kernels.append(rec)
    print(json.dumps({"phase_s": phase_s, "rays_per_s": res["rays_per_s"],
                      "summary": res["summary"], "reference_check": ref,
                      "train": {"steps": steps, "summary": train["summary"],
                                "wall_s": train["wall_s"], "dispatch_check": dispatch},
                      "parallel": {k: v for k, v in par.items()
                                   if k not in ("nccl_launches", "gloo_launches")},
                      "gradient_checks": grads,
                      "train_wmask": {"steps": masked_steps, "summary": masked["summary"],
                                      "wall_s": masked["wall_s"]},
                      "train_wdepth": {"steps": wdepth_steps, "summary": wdepth["summary"],
                                       "wall_s": wdepth["wall_s"],
                                       "depth_losses": wdepth["depth_losses"]},
                      "serve_wdepth": {k: v for k, v in wdepth_serve.items() if k != "launches"},
                      "train_learn": {"steps": learn_steps, "summary": learn["summary"],
                                      "wall_s": learn["wall_s"], "pnf": learn["pnf"],
                                      "dispatch_check": learn_dispatch},
                      "train_learn_wdepth": {"steps": learn_wdepth_steps,
                                             "summary": learn_wdepth["summary"],
                                             "wall_s": learn_wdepth["wall_s"],
                                             "pnf": learn_wdepth["pnf"],
                                             "depth_losses": learn_wdepth["depth_losses"]},
                      "serve_learn_wdepth": {k: v for k, v in learn_wdepth_serve.items()
                                             if k != "launches"},
                      "train_wdepth_depth_before_color": {"steps": dbc_steps},
                      "fused": {"steps": fused["steps"], "summary": fused["train"]["summary"],
                                "wall_s": fused["train"]["wall_s"],
                                "gradient_check": fused["gradient_check"]},
                      "novel_views": {k: ({kk: vv for kk, vv in v.items() if kk != "launches"}
                                          if isinstance(v, dict) else v)
                                      for k, v in novel.items()},
                      "train_bf16": {"steps": bf16_steps, "gradient_check": bf16_grad},
                      "flagship": {k: v for k, v in flagship.items() if k != "launches"},
                      "vdn_cycle": {k: v for k, v in vdn_cycle.items() if k != "launches"},
                      "mesh": {k: v for k, v in mesh.items() if k != "launches"},
                      "cycle": cycle}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-child"]:
        sys.exit(rank_child(*sys.argv[2:]))
    sys.exit(main())
