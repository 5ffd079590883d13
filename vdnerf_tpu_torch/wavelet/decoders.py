"""Depth decoders: wavelet-coefficient prediction + Haar reconstruction (NCHW).

Counterpart of ``vdnerf_tpu/wavelet/decoders.py``, with the same module names
(``conv2``, ``up1`` ... ``up4``, ``wave1_ll``, ``wave1`` ... ``wave4``,
``conv3``, ``conv5``; the sparse decoder's dense ladder under ``dense``) and
the same output keys: ``("disp", s)`` [N, 1, h, w], ``("wavelets", s, b)``
for b in LL/LH/HL/HH, and for :class:`SparseDecoderWave` ``("wavelet_mask",
s)`` and ``"sparsity"``.

- :class:`DecoderWave`: the DenseDepth-style decoder predicting the coarsest
  LL and per-scale (LH, HL, HH) details, reconstructing ``("disp", s)`` for
  s = 3..0 by inverse Haar transforms.
- :class:`DecoderWave224`: the 224-input variant with a fourth up block.
- :class:`PlainDecoder` / :class:`PlainDecoder224`: direct upsampling.
- :class:`SparseDecoderWave`: the dense ladder, then the reference's
  parent-threshold masks applied to the scale-1/0 details.

Each decoder's width is ``int(enc_features[-1] * decoder_width)``, from the
encoder's ``num_ch_enc``; its convolutions read the taps' actual channels
(``tap_channels``), which flax infers from the input. The two differ for
mobilenet_light only: ``num_ch_enc`` ends in 160, its last tap has 320.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vdnerf_tpu_torch.wavelet.haar import haar_idwt2

def _pad1(x: torch.Tensor, padding: str) -> torch.Tensor:
    """x padded by 1 on both spatial axes, "reflection" or "replicate", from
    slices: torch's reflect and replicate pads accumulate their backward
    with atomics on the card, a concatenation of slices does not."""
    for dim in (-2, -1):
        n = x.shape[dim]
        lo, hi = (1, n - 2) if padding == "reflection" else (0, n - 1)
        x = torch.cat([x.narrow(dim, lo, 1), x, x.narrow(dim, hi, 1)], dim)
    return x


class Conv3x3(nn.Conv2d):
    """Pad by 1 (reflect / replicate / zero) + 3x3 conv with bias
    (reference layers.py:11-32)."""

    def __init__(self, c_in: int, c_out: int, padding: str = "zero"):
        if padding not in ("reflection", "replicate", "zero"):
            raise ValueError(f"conv3x3: padding {padding!r}")
        super().__init__(c_in, c_out, 3, padding=1 if padding == "zero" else 0)
        self.pad = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x if self.pad == "zero" else _pad1(x, self.pad))


def conv3x3(c_in: int, c_out: int, padding: str = "zero") -> nn.Conv2d:
    return Conv3x3(c_in, c_out, padding)


def upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class UpSampleBlock(nn.Module):
    """nearest 2x upsample -> concat skip -> conv -> LeakyReLU(0.2)
    (reference layers.py:57-67)."""

    def __init__(self, c_in: int, c_out: int, padding: str = "zero"):
        super().__init__()
        self.conv = conv3x3(c_in, c_out, padding)

    def forward(self, x, skip):
        h = torch.cat([upsample_nearest(x), skip], 1)
        return F.leaky_relu(self.conv(h), 0.2)


def _details(outputs: dict, scale: int, h: torch.Tensor):
    """Record a [N, 3, h, w] detail stack as ("wavelets", scale, LH|HL|HH)
    and return the (LH, HL, HH) triple."""
    triple = (h[:, 0:1], h[:, 1:2], h[:, 2:3])
    for b, t in zip(("LH", "HL", "HH"), triple):
        outputs[("wavelets", scale, b)] = t
    return triple


class DecoderWave(nn.Module):
    def __init__(self, enc_features: Sequence[int] = (96, 96, 192, 384, 2208),
                 decoder_width: float = 0.5, tap_channels: Sequence[int] | None = None):
        super().__init__()
        e = tap_channels or enc_features
        f = int(enc_features[-1] * decoder_width)
        self.conv2 = conv3x3(e[-1], f, "replicate")
        self.up1 = UpSampleBlock(f + e[-2], f // 2, "reflection")
        self.wave1_ll = conv3x3(f // 2, 1, "replicate")
        self.wave1 = conv3x3(f // 2, 3)
        self.up2 = UpSampleBlock(f // 2 + e[-3], f // 4, "reflection")
        self.wave2 = conv3x3(f // 4, 3)
        self.up3 = UpSampleBlock(f // 4 + e[-4], f // 8, "reflection")
        self.wave3 = conv3x3(f // 8, 3)

    def forward(self, x_blocks):
        outputs = {}
        x_d0 = self.conv2(x_blocks[-1])
        x_d1 = self.up1(x_d0, x_blocks[-2])
        ll = (2**3) * self.wave1_ll(x_d1)
        outputs[("disp", 3)] = ll / (2**3)
        outputs[("wavelets", 2, "LL")] = ll
        ll = haar_idwt2(ll, _details(outputs, 2, (2**2) * self.wave1(x_d1)))
        outputs[("disp", 2)] = ll / (2**2)

        x_d2 = self.up2(x_d1, x_blocks[-3])
        ll = haar_idwt2(ll, _details(outputs, 1, (2**1) * self.wave2(x_d2)))
        outputs[("disp", 1)] = ll / (2**1)

        x_d3 = self.up3(x_d2, x_blocks[-4])
        ll = haar_idwt2(ll, _details(outputs, 0, self.wave3(x_d3)))
        outputs[("disp", 0)] = ll
        return outputs


class DecoderWave224(nn.Module):
    """224-input wavelet decoder (reference :151-221). As in the JAX package,
    ``("disp", 1)`` uses true division where the reference has ``ll // 2``."""

    def __init__(self, enc_features: Sequence[int] = (96, 96, 192, 384, 2208),
                 decoder_width: float = 0.5, tap_channels: Sequence[int] | None = None):
        super().__init__()
        e = tap_channels or enc_features
        f = int(enc_features[-1] * decoder_width)
        self.conv2 = conv3x3(e[-1], f, "replicate")
        self.up1 = UpSampleBlock(f + e[-2], f // 2, "reflection")
        self.wave1_ll = conv3x3(f // 2, 1, "replicate")
        self.wave1 = conv3x3(f // 2, 3)
        self.up2 = UpSampleBlock(f // 2 + e[-3], f // 4, "reflection")
        self.wave2 = conv3x3(f // 4, 3)
        self.up3 = UpSampleBlock(f // 4 + e[-4], f // 8, "reflection")
        self.wave3 = conv3x3(f // 8, 3)
        self.up4 = UpSampleBlock(f // 8 + e[-5], f // 16, "reflection")
        self.wave4 = conv3x3(f // 16, 3)

    def forward(self, x_blocks):
        outputs = {}
        x_d0 = self.conv2(x_blocks[-1])
        x_d1 = self.up1(x_d0, x_blocks[-2])
        ll = (2**4) * self.wave1_ll(x_d1)
        outputs[("wavelets", 3, "LL")] = ll
        ll = haar_idwt2(ll, _details(outputs, 3, (2**3) * self.wave1(x_d1)))
        outputs[("disp", 3)] = ll / (2**3)

        x_d2 = self.up2(x_d1, x_blocks[-3])
        ll = haar_idwt2(ll, _details(outputs, 2, (2**2) * self.wave2(x_d2)))
        outputs[("disp", 2)] = ll / (2**2)

        x_d3 = self.up3(x_d2, x_blocks[-4])
        ll = haar_idwt2(ll, _details(outputs, 1, (2**1) * self.wave3(x_d3)))
        outputs[("disp", 1)] = ll / (2**1)

        x_d4 = self.up4(x_d3, x_blocks[-5])
        ll = haar_idwt2(ll, _details(outputs, 0, self.wave4(x_d4)))
        outputs[("disp", 0)] = ll
        return outputs


class PlainDecoder(nn.Module):
    """Non-wavelet DenseDepth decoder (reference :15-47)."""

    head_div = 16  # conv3 reads f // head_div channels

    def __init__(self, enc_features: Sequence[int] = (96, 96, 192, 384, 2208),
                 decoder_width: float = 0.5, tap_channels: Sequence[int] | None = None):
        super().__init__()
        e = tap_channels or enc_features
        f = int(enc_features[-1] * decoder_width)
        self.conv2 = conv3x3(e[-1], f)
        c = f
        for i, div in enumerate((2, 4, 8, 16)):
            self.add_module(f"up{i + 1}", UpSampleBlock(c + e[-2 - i], f // div))
            c = f // div
        self.conv3 = conv3x3(f // self.head_div, 1)

    def trunk(self, x_blocks):
        x = self.conv2(x_blocks[-1])
        for i in range(4):
            x = getattr(self, f"up{i + 1}")(x, x_blocks[-2 - i])
        return x

    def forward(self, x_blocks):
        return {("disp", 0): self.conv3(self.trunk(x_blocks))}


class PlainDecoder224(PlainDecoder):
    """Non-wavelet decoder with an extra upsample head (reference :50-89)."""

    head_div = 32

    def __init__(self, enc_features: Sequence[int] = (96, 96, 192, 384, 2208),
                 decoder_width: float = 0.5, tap_channels: Sequence[int] | None = None):
        super().__init__(enc_features, decoder_width, tap_channels)
        f = int(enc_features[-1] * decoder_width)
        self.conv5 = conv3x3(f // 16, f // 32)

    def forward(self, x_blocks):
        x = upsample_nearest(self.trunk(x_blocks))
        x = F.leaky_relu(self.conv5(x), 0.2)
        return {("disp", 0): self.conv3(x)}


class SparseDecoderWave(nn.Module):
    """Threshold-sparsified wavelet decoder (reference :224-409).

    The dense ladder runs first; with ``thresh_ratio >= 0`` the scale-1 and
    scale-0 details are then masked as the reference's sparse convolutions
    leave them: a position is kept where the parent scale's largest |detail|
    exceeds ``(max(ll) - min(ll)) * thresh_ratio`` (the mask nearest-upsampled
    to the child scale), the details are zeroed outside the mask's 3x3
    dilation, and the inverse transform uses the undilated mask. Scale 2 is
    dense. ``"sparsity"`` holds each scale's mask occupancy.
    """

    def __init__(self, enc_features: Sequence[int] = (96, 96, 192, 384, 2208),
                 decoder_width: float = 0.5, tap_channels: Sequence[int] | None = None):
        super().__init__()
        self.dense = DecoderWave(enc_features, decoder_width, tap_channels)

    def forward(self, x_blocks, thresh_ratio: float = -1.0):
        outputs = self.dense(x_blocks)
        if thresh_ratio < 0:
            outputs["sparsity"] = {}
            return outputs

        def stack_h(scale):
            return torch.cat([outputs[("wavelets", scale, b)] for b in ("LH", "HL", "HH")], 1)

        ll = outputs[("wavelets", 2, "LL")]
        h = stack_h(2)
        outputs[("wavelet_mask", 2)] = torch.ones_like(h[:, :1])
        ll = haar_idwt2(ll, (h[:, 0:1], h[:, 1:2], h[:, 2:3]))
        sparsity = {2: torch.ones((), dtype=ll.dtype, device=ll.device)}

        parent_h = h
        for scale in (1, 0):
            thresh = (ll.max() - ll.min()) * thresh_ratio
            mask = (parent_h.abs().amax(1, keepdim=True) > thresh).to(ll.dtype)
            wavelet_mask = upsample_nearest(mask)
            wave_mask = F.max_pool2d(wavelet_mask, 3, 1, padding=1)  # flax SAME
            h = stack_h(scale) * wave_mask
            _details(outputs, scale, h)
            outputs[("wavelet_mask", scale)] = wavelet_mask
            hm = h * wavelet_mask  # the IDWT uses wavelet_mask * h (:359, :404)
            ll = haar_idwt2(ll, (hm[:, 0:1], hm[:, 1:2], hm[:, 2:3]))
            outputs[("disp", scale)] = ll / (2**scale)
            sparsity[scale] = wavelet_mask.mean()
            parent_h = h
        outputs["sparsity"] = sparsity
        return outputs
