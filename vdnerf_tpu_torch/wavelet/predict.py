"""Feature-extraction CLI: export the 96-channel encoder features per image.

Counterpart of ``vdnerf_tpu/wavelet/predict.py`` (the same flags): for each
``.png`` in ``-d``, optionally mask-composite (``--type msk``) or 2x upscale
(``-full``), flatten RGBA to white, run the encoder, and save its first tap
(96 channels at H/2 for DenseNet-161) as
``wavelet_feats[_msk][_full]/0/<stem>.npy``, float32 [1, C, H/2, W/2], the
file the wdepth confs' ``depth_dir`` reads.

Only the encoder runs, so any image size works. The JAX CLI builds the whole
model at each image's size, and its decoder's skip concatenations need H and
W to be multiples of 32; where both run, the files agree.

Usage:
    python -m vdnerf_tpu_torch.wavelet.predict -ckpt <folder> -d <image folder>
"""

from __future__ import annotations

import argparse
import os

import cv2 as cv
import numpy as np
import torch

from vdnerf_tpu_torch.utils.device import configure_numerics, resolve_device
from vdnerf_tpu_torch.wavelet.io import load_model_from_folder
from vdnerf_tpu_torch.wavelet.model import WaveletOpts, create_model


def feat_to_img(featmap: np.ndarray, max_value=None) -> np.ndarray:
    """[C, H, W] features -> [H, W, 3] PCA-projected RGB in [0, 1]
    (reference predict.py:68-93)."""
    c, h, w = featmap.shape
    vecs = featmap.reshape(c, -1)
    cov = np.cov(vecs)
    _, vect = np.linalg.eigh(cov)
    proj = vect[:, -3:].T @ vecs  # top-3 principal components
    fm = proj.reshape(3, h, w)
    if max_value is None:
        lo, hi = fm.min(), fm.max()
        rgb = 0.5 + (fm - lo) / max(hi - lo, 1e-9) * 0.5
    else:
        rgb = (fm / max_value).clip(-1, 1) * 0.5 + 0.5
    return np.transpose(rgb, (1, 2, 0))


def build_parser():
    p = argparse.ArgumentParser(description="96-ch feature extraction")
    p.add_argument("--gpu", type=int, default=0)
    p.add_argument("--logdir", type=str, default="log")
    p.add_argument("--model_name", type=str, default="DenseNetWaveLet")
    p.add_argument("-ckpt", "--ckpt_folder", type=str, required=True)
    p.add_argument("--ckpt_name", type=str, default="model.npz")
    p.add_argument("--normalize_input", action="store_true")
    p.add_argument("--encoder_type", type=str, default="densenet")
    p.add_argument("--use_wavelets", action="store_true", default=True)
    p.add_argument("--no_pretrained", action="store_true", default=False)
    p.add_argument("--dw_waveconv", action="store_true")
    p.add_argument("--dw_upconv", action="store_true")
    p.add_argument("-full", "--is_full", action="store_true")
    p.add_argument("--use_224", action="store_true", default=False)
    p.add_argument("-d", "--pic_routine", default="./predict_data/")
    p.add_argument("--type", type=str, default="")
    p.add_argument("--save_vis", action="store_true",
                   help="also save the PCA-RGB visualization PNG")
    return p


def main(argv=None, device=None) -> list[str]:
    """Export the features; returns the paths written."""
    args = build_parser().parse_args(argv)
    device = resolve_device(device, args.gpu)
    configure_numerics()
    # shapes are fixed within a run: let cuDNN time its f32 algorithms once,
    # unless the caller asked for deterministic ones (then the features
    # repeat bit for bit)
    torch.backends.cudnn.benchmark = not torch.backends.cudnn.deterministic

    opts = WaveletOpts(
        encoder_type=args.encoder_type,
        normalize_input=args.normalize_input,
        use_wavelets=args.use_wavelets,
        use_224=args.use_224,
    )

    depth_folder = os.path.join(args.pic_routine, "wavelet_feats")
    if args.type == "msk":
        depth_folder += "_msk"
    if args.is_full:
        depth_folder += "_full"
    out_dir = os.path.join(depth_folder, "0")
    os.makedirs(out_dir, exist_ok=True)

    files = sorted(f for f in os.listdir(args.pic_routine) if f.endswith(".png"))
    print(f"[Info] {len(files)} images in {args.pic_routine}")

    model = create_model(opts, device)
    load_model_from_folder(model, args.ckpt_folder, args.ckpt_name)
    written = []
    for fname in files:
        pic = cv.imread(os.path.join(args.pic_routine, fname), -1)
        if args.type == "msk":
            mask = cv.imread(os.path.join(args.pic_routine, "mask", fname)) / 255
            pic = pic * mask + (1 - mask) * 255
        if args.is_full:
            pic = cv.resize(pic, (0, 0), fx=2, fy=2)
        if pic.shape[-1] == 4:
            rgb, a = pic[..., :3], pic[..., 3:] / 255.0
            pic = rgb * a + (1.0 - a) * 255
        x = (pic.astype(np.float32) / 255.0).transpose(2, 0, 1)[None]  # [1, 3, H, W]
        with torch.no_grad():
            feat = model.encode(torch.from_numpy(np.ascontiguousarray(x)).to(device))[0]
        feat_nchw = feat.cpu().numpy()  # [1, C, H/2, W/2]
        path = os.path.join(out_dir, fname[:-4] + ".npy")
        np.save(path, feat_nchw)
        written.append(path)
        if args.save_vis:
            vis = feat_to_img(feat_nchw[0], max_value=8)
            cv.imwrite(os.path.join(depth_folder, fname[:-4] + "_vis.png"), np.uint8(vis * 255))
        print(f"{fname} Saved")
    return written


if __name__ == "__main__":
    main()
