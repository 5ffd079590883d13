"""Monodepth model: encoder + decoder selection.

Counterpart of ``vdnerf_tpu/wavelet/model.py``: encoder_type in {densenet,
resnet, mobilenet, mobilenet_light} and the wavelet / plain / 224 / sparse
decoders, chosen by :class:`WaveletOpts` (the reference CLIs' model flags).
Inputs are NCHW; ``model.train()`` / ``model.eval()`` play the role of the
JAX ``train`` argument (batch or running BatchNorm statistics).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from vdnerf_tpu_torch.wavelet.decoders import (
    DecoderWave,
    DecoderWave224,
    PlainDecoder,
    PlainDecoder224,
    SparseDecoderWave,
)
from vdnerf_tpu_torch.wavelet.encoders import DenseEncoder, MobileNetV2Encoder, ResnetEncoder


@dataclasses.dataclass(frozen=True)
class WaveletOpts:
    """Mirror of the reference CLIs' model flags (finetune_for_vdn.py:22-59)."""

    encoder_type: str = "densenet"
    num_layers: int = 161  # densenet variant (or resnet depth)
    normalize_input: bool = False
    use_wavelets: bool = True
    use_224: bool = False
    use_sparse: bool = False
    dw_waveconv: bool = False
    dw_upconv: bool = False
    decoder_width: float = 0.5


class MonodepthModel(nn.Module):
    def __init__(self, opts: WaveletOpts = WaveletOpts()):
        super().__init__()
        self.opts = o = opts
        if o.encoder_type == "densenet":
            self.encoder = DenseEncoder(o.num_layers, o.normalize_input)
        elif o.encoder_type == "resnet":
            self.encoder = ResnetEncoder(o.num_layers if o.num_layers in (18, 34, 50) else 18,
                                         o.normalize_input)
        elif o.encoder_type in ("mobilenet", "mobilenet_light"):
            self.encoder = MobileNetV2Encoder(o.normalize_input,
                                              use_last_layer=o.encoder_type == "mobilenet")
        else:
            raise NotImplementedError(o.encoder_type)

        enc_ch = tuple(self.encoder.num_ch_enc)
        if o.use_wavelets:
            cls = SparseDecoderWave if o.use_sparse else DecoderWave224 if o.use_224 else DecoderWave
        else:
            cls = PlainDecoder224 if o.use_224 else PlainDecoder
        self.decoder = cls(enc_ch, o.decoder_width, tuple(self.encoder.tap_channels))

    def forward(self, x: torch.Tensor, thresh_ratio: float = -1.0) -> dict:
        feats = self.encoder(x)
        if self.opts.use_sparse:
            return self.decoder(feats, thresh_ratio)
        return self.decoder(feats)

    def encode(self, x: torch.Tensor) -> tuple:
        """Encoder features only; feats[0] is the exported 96-channel VDN map."""
        return self.encoder(x)


@torch.no_grad()
def init_flax_(model: nn.Module, generator: torch.Generator) -> None:
    """flax's default initialisers, drawn from ``generator``: every conv
    kernel lecun-normal (a normal truncated at two standard deviations,
    scaled so that its variance is 1 / fan_in, fan_in = in/groups x kh x kw),
    conv biases zero; BatchNorm scale 1, bias 0, running mean 0, var 1."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            w = m.weight
            std = math.sqrt(1.0 / (w[0].numel())) / 0.87962566103423978
            t = torch.empty(w.shape)
            nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
            w.copy_(t * std)
            if m.bias is not None:
                m.bias.zero_()


def create_model(opts: WaveletOpts, device: torch.device | str,
                 generator: torch.Generator | None = None) -> MonodepthModel:
    """The model with flax's initialisation from ``generator`` (seed 0 when
    omitted), in eval mode, on ``device``."""
    model = MonodepthModel(opts)
    init_flax_(model, generator if generator is not None else torch.Generator().manual_seed(0))
    return model.to(device).eval()
