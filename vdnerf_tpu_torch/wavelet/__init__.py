"""The wavelet monodepth side-car (counterpart of ``vdnerf_tpu/wavelet``).

The CLIs: ``python -m vdnerf_tpu_torch.wavelet.finetune`` (encoder-only
finetuning on a NeuS ``getfeats`` export), ``...wavelet.predict`` (the
96-channel encoder features the wdepth confs read) and ``...wavelet.pretrain``
(NYU pretraining). Each runs on ``cuda:<--gpu>`` unless a caller passes
``device="cpu"``.
"""

from vdnerf_tpu_torch.wavelet.haar import (
    haar_dwt2,
    haar_dwt2_multi,
    haar_idwt2,
    haar_idwt2_multi,
)
from vdnerf_tpu_torch.wavelet.model import MonodepthModel, WaveletOpts, create_model

__all__ = [
    "haar_dwt2",
    "haar_dwt2_multi",
    "haar_idwt2",
    "haar_idwt2_multi",
    "MonodepthModel",
    "WaveletOpts",
    "create_model",
]
