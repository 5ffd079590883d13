"""Matmul precision policy of the SDF value+gradient+feature block.

Counterpart of ``vdnerf_tpu/models/precision.py``. The policy is the matmul
dtype: ``None`` (full f32) or ``torch.bfloat16``. Under bf16 each linear of
the SDF network casts its input and its f32 effective weight to bf16, takes
the product with f32 accumulation, adds the f32 bias and returns bf16
activations; parameters stay f32 master copies and all non-matmul math
(embedder, compositing, losses) stays f32 (``models/layers.py`` ``linear``).

The policy is a value, not a global: it is given to
:class:`~vdnerf_tpu_torch.models.fields.SDFNetwork` (``matmul_dtype``), which
is the only network it changes. The runner sets it from ``train.bf16`` for a
training run (its validation renders included), as the JAX runner switches
the policy on in ``train()``; the flagship tool sets it from ``--fp32``.
``VDNERF_BF16`` is read once, by the entry points (:func:`env_matmul_dtype`),
as the JAX module reads it at import.

The up-sample ladder and the mesh grid query the SDF through K1, in f32,
under either policy (the JAX package runs them through ``linear`` and so in
bf16 under the policy): their sample positions are not differentiated, and
f32 is the more accurate of the two.

The JAX module's ``VDNERF_FUSED`` / ``set_fused_mlp`` switch has no
counterpart: on the card the port always runs the colour head, the depth
head and the background NeRF through K2-K5, whose matmul operands are bf16
with f32 accumulation under either policy.
"""

from __future__ import annotations

import os

import torch


def matmul_dtype(bf16: bool) -> torch.dtype | None:
    """The policy value: ``torch.bfloat16`` when ``bf16``, else None (f32)."""
    return torch.bfloat16 if bf16 else None


def env_matmul_dtype() -> torch.dtype | None:
    """The policy ``VDNERF_BF16`` asks for (``1``/``true``/``True``)."""
    return matmul_dtype(os.environ.get("VDNERF_BF16", "") in ("1", "true", "True"))
