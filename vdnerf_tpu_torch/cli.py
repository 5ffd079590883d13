"""Command-line interface, flag-compatible with ``vdnerf_tpu.cli``.

Usage:
    python -m vdnerf_tpu_torch.cli --conf confs/womsk_white_tpu.conf \
        --case <case> --mode train [-c]         # or valimg_<iter>, getfeats_<iter>

Ported modes: ``train`` (``-c`` resumes from the latest checkpoint),
``valimg_<iter>`` and ``getfeats_<iter>``. Every other mode exits with a
message. ``--gpu`` picks the CUDA device; the CLI runs on the card unless a
caller of :func:`main` passes ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import logging

PORTED_MODES = ("valimg", "getfeats")  # with an _<iter> suffix, beside train


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
    run stopped by SIGTERM)."""
    logging.basicConfig(
        level=logging.INFO,
        format="[%(filename)s:%(lineno)s - %(funcName)20s() ] %(message)s",
    )
    args = build_parser().parse_args(argv)
    name, _, suffix = args.mode.partition("_")
    if args.mode != "train" and (name not in PORTED_MODES or not suffix.isdigit()):
        raise SystemExit(
            f"mode {args.mode!r} is not yet ported to vdnerf_tpu_torch "
            "(ported: train, valimg_<iter>, getfeats_<iter>)"
        )

    from vdnerf_tpu_torch.runner import Runner

    runner = Runner(
        args.conf, args.case, img_dir=args.img_dir,
        npz_postfix=args.npz_postfix, seed=args.seed, device=device, gpu=args.gpu,
        mode=name, is_continue=args.is_continue,
    )
    if args.mode == "train":
        return runner.train()
    runner.load_checkpoint_iter(int(suffix))
    if name == "getfeats":
        return runner.val_all_imgs(
            resolution_level=1, gen_depth_for_finetune=True, both_mask=False
        )
    return runner.val_all_imgs(
        resolution_level=2, gen_depth_for_finetune=False, both_mask=True
    )


if __name__ == "__main__":
    main()
