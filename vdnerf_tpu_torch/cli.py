"""Command-line interface, flag- and mode-compatible with ``vdnerf_tpu.cli``.

Usage:
    python -m vdnerf_tpu_torch.cli --conf confs/womsk_white_tpu.conf \
        --case <case> --mode train [-c]

Modes: ``train`` (``-c`` resumes from the latest checkpoint),
``valimg_<iter>``, ``getfeats_<iter>``, ``validate_mesh_<iter>`` (or
``validate_mesh`` with ``-c``, on the latest checkpoint: a 512^3 world-space
mesh at ``--mcube_threshold``), ``interpolate_<i>_<j>`` (the novel-view
video between cameras i and j, from the checkpoint ``-c`` resumed) and
``showcam`` / ``showcam_<iter>`` (the camera-pose dump; ``showcam_<iter>``
loads that checkpoint with its learned cameras, bare ``showcam`` uses what
``-c`` resumed). Any other mode exits with ``unknown mode``.
``--gpu`` picks the CUDA device; the CLI runs on the card unless a caller of
:func:`main` passes ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--conf", type=str, default="./confs/base.conf")
    parser.add_argument("-m", "--mode", type=str, default="train")
    parser.add_argument("--mcube_threshold", type=float, default=0.0)
    parser.add_argument("-c", "--is_continue", default=False, action="store_true")
    parser.add_argument("--gpu", type=int, default=0, help="CUDA device index")
    parser.add_argument("--case", type=str, default="")
    parser.add_argument("-d", "--img_dir", type=str, default="image")
    parser.add_argument("-psfx", "--npz_postfix", type=str, default="")
    parser.add_argument("--seed", type=int, default=0)
    return parser


def main(argv=None, device=None) -> dict | str | None:
    """Run one mode; returns the validation summary (None after a training
    run stopped by SIGTERM), for ``validate_mesh`` the mesh's path, counts
    and seconds by part, for ``interpolate`` the video's path and for
    ``showcam`` the pose dump's."""
    logging.basicConfig(
        level=logging.INFO,
        format="[%(filename)s:%(lineno)s - %(funcName)20s() ] %(message)s",
    )
    args = build_parser().parse_args(argv)
    mode = args.mode
    name, _, suffix = mode.rpartition("_")
    if not suffix.isdigit():
        name, suffix = mode, ""
    if mode.startswith("interpolate"):
        # interpolate_<i>_<j>, split as the JAX CLI splits it
        name, *pair = mode.split("_")
        if len(pair) != 2 or not all(p.isdigit() for p in pair):
            raise SystemExit(f"unknown mode: {mode}")
    elif mode != "train" and not (name in ("valimg", "getfeats") and suffix) \
            and name not in ("validate_mesh", "showcam"):
        raise SystemExit(f"unknown mode: {mode}")
    if name == "validate_mesh" and not suffix and not args.is_continue:
        # as the JAX CLI: the bare mode needs the resumed latest checkpoint
        raise SystemExit("validate_mesh needs an iteration suffix or --is_continue")

    from vdnerf_tpu_torch.runner import Runner

    runner = Runner(
        args.conf, args.case, img_dir=args.img_dir,
        npz_postfix=args.npz_postfix, seed=args.seed, device=device, gpu=args.gpu,
        mode=name, is_continue=args.is_continue,
    )
    if mode == "train":
        return runner.train()
    if name == "interpolate":
        return runner.interpolate_view(int(pair[0]), int(pair[1]))
    if suffix:
        runner.load_checkpoint_iter(int(suffix))
    if name == "showcam":
        return runner.show_cam_pose()
    if name == "validate_mesh":
        return runner.validate_mesh(world_space=True, resolution=512,
                                    threshold=args.mcube_threshold)
    if name == "getfeats":
        return runner.val_all_imgs(
            resolution_level=1, gen_depth_for_finetune=True, both_mask=False
        )
    return runner.val_all_imgs(
        resolution_level=2, gen_depth_for_finetune=False, both_mask=True
    )


if __name__ == "__main__":
    main()
