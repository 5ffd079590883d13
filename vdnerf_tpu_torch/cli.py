"""Command-line interface, flag-compatible with ``vdnerf_tpu.cli``.

Usage:
    python -m vdnerf_tpu_torch.cli --conf confs/womsk_white_tpu.conf \
        --case <case> --mode train [-c]
    # or valimg_<iter>, getfeats_<iter>, validate_mesh_<iter>, validate_mesh -c

Ported modes: ``train`` (``-c`` resumes from the latest checkpoint),
``valimg_<iter>``, ``getfeats_<iter>`` and ``validate_mesh_<iter>`` (or
``validate_mesh`` with ``-c``, on the latest checkpoint): a 512^3 world-space
mesh at ``--mcube_threshold``. Every other mode exits with a message.
``--gpu`` picks the CUDA device; the CLI runs on the card unless a caller of
:func:`main` passes ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import logging

PORTED_MODES = ("valimg", "getfeats", "validate_mesh")  # with an _<iter> suffix, beside train


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


def main(argv=None, device=None) -> dict | None:
    """Run one mode; returns the validation summary (None after a training
    run stopped by SIGTERM), or for ``validate_mesh`` the mesh's path,
    counts and seconds by part."""
    logging.basicConfig(
        level=logging.INFO,
        format="[%(filename)s:%(lineno)s - %(funcName)20s() ] %(message)s",
    )
    args = build_parser().parse_args(argv)
    name, _, suffix = args.mode.rpartition("_")
    if not suffix.isdigit():
        name, suffix = args.mode, ""
    if args.mode != "train" and not (name in PORTED_MODES and (suffix or name == "validate_mesh")):
        raise SystemExit(
            f"mode {args.mode!r} is not yet ported to vdnerf_tpu_torch "
            "(ported: train, valimg_<iter>, getfeats_<iter>, validate_mesh[_<iter>])"
        )
    if name == "validate_mesh" and not suffix and not args.is_continue:
        # as the JAX CLI: the bare mode needs the resumed latest checkpoint
        raise SystemExit("validate_mesh needs an iteration suffix or --is_continue")

    from vdnerf_tpu_torch.runner import Runner

    runner = Runner(
        args.conf, args.case, img_dir=args.img_dir,
        npz_postfix=args.npz_postfix, seed=args.seed, device=device, gpu=args.gpu,
        mode=name, is_continue=args.is_continue,
    )
    if args.mode == "train":
        return runner.train()
    if suffix:
        runner.load_checkpoint_iter(int(suffix))
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
