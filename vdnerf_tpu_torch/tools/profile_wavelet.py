"""Where a monodepth finetune step's time goes on the card.

    python -m vdnerf_tpu_torch.tools.profile_wavelet [--iters 5] [--trace trace.json]

The finetune CLI's model and batch at their defaults: DenseNet-161 and the
wavelet decoder (flax's initialisation from seed 0), 800^2 inputs and 400^2
targets, batch 4, encoder-only Adam. On a seeded batch it reports:

- the first step's time (host clock: cuDNN times its algorithms for each
  convolution shape, ``cudnn.benchmark``, as the side-car's CLIs run), the
  steady-state step time after it (CUDA events over ``--iters`` steps) with
  f32 convolutions (TF32 off), and the peak device memory of those steps;
- one profiled step: the device time by group (convolution, batchnorm,
  concatenation, pooling, resize and padding, elementwise, reduction,
  optimizer, other), the top kernels and the device's idle share;
- for comparison only, the same steps with TF32 allowed (the port has no
  such setting; this says what f32 convolutions cost);
- the encoder alone at one 300x400 image, as predict runs it (ms per image).

``--heuristic`` runs all of it on cuDNN's heuristic choice of algorithm
(``cudnn.benchmark`` off, torch's default) for comparison. It is a flag and
not a second measurement in the same process because cuDNN's per-shape
choice is cached for the process, whichever way it was made.

Prints one JSON line, with the card's name and power limit. Needs a CUDA
device; with none it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from vdnerf_tpu_torch.tools.profile_render import _event_ms, profile_window
from vdnerf_tpu_torch.utils.device import configure_numerics
from vdnerf_tpu_torch.wavelet.model import WaveletOpts, create_model
from vdnerf_tpu_torch.wavelet.train_lib import make_finetune_step

SIZE, BATCH, LR = 800, 4, 1e-5

# kernel-name fragments (lower case) per group, tried in this order
GROUPS = (
    ("batchnorm", ("batch_norm", "bn_fw", "bn_bw", "welford")),
    ("concatenation", ("catarray",)),
    ("convolution", ("conv", "gemm", "xmma", "cutlass", "cudnn", "dgrad", "wgrad", "fprop",
                     "winograd", "fft")),
    ("pooling", ("pool",)),
    ("resize_pad", ("upsample", "pad", "interp")),
    ("optimizer", ("multi_tensor", "adam")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise",)),
)


def wavelet_group(name: str) -> str:
    low = name.lower()
    for group, frags in GROUPS:
        if any(f in low for f in frags):
            return group
    return "other"


def seeded_batch(device, n: int = BATCH, size: int = SIZE, seed: int = 0) -> dict:
    """Image in [0, 1], depth in [0, 200), a mask of ~80% ones."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    return {"image": t(rng.uniform(size=(n, 3, size, size))),
            "depth": t(rng.uniform(0, 200, size=(n, 1, size // 2, size // 2))),
            "mask": t(rng.uniform(size=(n, 1, size // 2, size // 2)) > 0.2)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--trace", default="")
    parser.add_argument("--heuristic", action="store_true",
                        help="cuDNN's heuristic algorithms (torch's default) instead of timed ones")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_wavelet: CUDA is not available", file=sys.stderr)
        return 1
    configure_numerics()
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    model = create_model(WaveletOpts(), dev)
    step = make_finetune_step(model, LR, encoder_only=True)
    batch = seeded_batch(dev)

    def one_step():
        return step(batch, LR)

    # as the CLIs run: the first step times cuDNN's algorithms per shape
    torch.backends.cudnn.benchmark = not args.heuristic
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_step()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    f32_ms = _event_ms(one_step, args.iters)
    peak = torch.cuda.max_memory_allocated()
    prof = profile_window(one_step, args.trace, group=wavelet_group)
    model.eval()
    x = seeded_batch(dev, n=1)["image"][..., :300, :400].contiguous()
    with torch.no_grad():
        encode_ms = _event_ms(lambda: model.encode(x), args.iters)
    model.train()
    # for comparison only: TF32 allowed (a new cuDNN cache key, so searched anew)
    torch.backends.cudnn.allow_tf32 = True
    tf32_ms = _event_ms(one_step, args.iters)
    configure_numerics()

    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "card": card,
        "model": "densenet161 + DecoderWave", "image_size": SIZE, "batch": BATCH,
        "first_step_s": first_s, "step_ms_f32": f32_ms, "images_per_s": BATCH / f32_ms * 1e3,
        "cudnn": "heuristic" if args.heuristic else "benchmark", "peak_memory_bytes": peak,
        "step_ms_cudnn_tf32": tf32_ms, "encode_ms_300x400": encode_ms, "profiled_step": prof,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
