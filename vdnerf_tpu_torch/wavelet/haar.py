"""Orthonormal 2-D Haar DWT / IDWT, NCHW.

Counterpart of ``vdnerf_tpu/wavelet/haar.py`` (which is NHWC): the same 2x2
butterflies, the same 1/2 scaling per level (so dwt -> idwt is the identity),
and the same detail order as pytorch_wavelets' 'haar':

- one level: x[N, C, H, W] -> (LL [N, C, H/2, W/2], (LH, HL, HH) same shape)
- LH = horizontal detail (vertical lowpass, horizontal highpass), HL =
  vertical detail, HH = diagonal.
"""

from __future__ import annotations

import torch


def haar_dwt2(x: torch.Tensor):
    """One-level 2D Haar DWT of NCHW ``x`` (H, W must be even)."""
    h, w = x.shape[-2:]
    if h % 2 or w % 2:
        raise ValueError(f"haar_dwt2 needs even sizes, got {(h, w)}")
    a = x[..., 0::2, 0::2]
    b = x[..., 0::2, 1::2]
    c = x[..., 1::2, 0::2]
    d = x[..., 1::2, 1::2]
    ll = (a + b + c + d) * 0.5
    lh = (a - b + c - d) * 0.5  # horizontal highpass
    hl = (a + b - c - d) * 0.5  # vertical highpass
    hh = (a - b - c + d) * 0.5
    return ll, (lh, hl, hh)


def haar_idwt2(ll: torch.Tensor, highs) -> torch.Tensor:
    """Inverse of :func:`haar_dwt2`."""
    lh, hl, hh = highs
    a = (ll + lh + hl + hh) * 0.5
    b = (ll - lh + hl - hh) * 0.5
    c = (ll + lh - hl - hh) * 0.5
    d = (ll - lh - hl + hh) * 0.5
    # [N, C, h, 2, w, 2]: row 2i + p, column 2j + q
    out = torch.stack([torch.stack([a, b], -1), torch.stack([c, d], -1)], -3)
    n, ch, h2, w2 = ll.shape
    return out.reshape(n, ch, 2 * h2, 2 * w2)


def haar_dwt2_multi(x: torch.Tensor, levels: int):
    """J-level decomposition -> (yl, [level-0 highs, level-1 highs, ...]);
    level 0 is the finest scale, each entry an (LH, HL, HH) triple."""
    highs = []
    ll = x
    for _ in range(levels):
        ll, h = haar_dwt2(ll)
        highs.append(h)
    return ll, highs


def haar_idwt2_multi(yl: torch.Tensor, highs) -> torch.Tensor:
    ll = yl
    for h in reversed(highs):
        ll = haar_idwt2(ll, h)
    return ll
