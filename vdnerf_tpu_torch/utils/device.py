"""Device resolution for the port's entry points.

The entry points run on the card: ``None`` resolves to ``cuda:<gpu>``, and
that raises when CUDA is missing. Only an explicit ``"cpu"`` (the tests)
runs on the CPU, where every kernel wrapper takes its plain version.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None, gpu: int = 0) -> torch.device:
    dev = torch.device(f"cuda:{gpu}" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' explicitly to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def configure_numerics() -> None:
    """Keep f32 matmuls in full f32 (no TF32), like the JAX default policy."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
