"""Matmul precision policy of the SDF value+gradient+feature block, and the
operand mode of K2-K5.

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

The colour head, the depth head and the background NeRF run through K2-K5
in an operand mode (:func:`mlp_operand_dtype`), as the JAX package runs them
through ``linear`` or, with ``VDNERF_FUSED`` (``set_fused_mlp``), through
its Pallas kernels:

- f32 policy, ``VDNERF_FUSED`` unset (JAX's default, and every shipped
  conf's): f32 operands, the split-operand mode of K2-K5 on the card;
- f32 policy, ``VDNERF_FUSED=1``: bf16 operands with f32 accumulation, as the
  Pallas kernels' ``_mm``;
- bf16 policy: bf16 operands (JAX casts every ``linear`` to bf16 there).

The mode is a value too: :class:`~vdnerf_tpu_torch.ops.renderer.NeuSModel`
takes it (``mlp_dtype``) and hands it to those three networks. The entry
points read ``VDNERF_FUSED`` once (:func:`env_fused`), beside ``VDNERF_BF16``.
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


def env_fused() -> bool:
    """Whether ``VDNERF_FUSED`` asks for JAX's fused path
    (``1``/``true``/``True``)."""
    return os.environ.get("VDNERF_FUSED", "") in ("1", "true", "True")


def mlp_operand_dtype(policy: torch.dtype | None, fused: bool) -> torch.dtype:
    """K2-K5's operand mode under the SDF policy ``policy`` (None: f32) and
    ``VDNERF_FUSED`` (``fused``): ``torch.float32`` under the f32 policy
    without it, else ``torch.bfloat16``."""
    return torch.bfloat16 if policy is not None or fused else torch.float32
