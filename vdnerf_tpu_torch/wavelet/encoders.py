"""CNN encoders of the monodepth side-car (NCHW).

Counterpart of ``vdnerf_tpu/wavelet/encoders.py``: the same trunks and the
same five feature taps at /2, /4, /8, /16 and /32.

- :class:`DenseEncoder`: DenseNet-121/161/169/201 (default 161: growth 48,
  init 96, blocks (6, 12, 36, 24)), tapped after relu0 (/2, the 96-channel
  VDN feature map that predict exports), pool0, transition1, transition2 and
  denseblock4 (pre-norm5). Its modules carry torchvision's names under
  ``features`` (``conv0``, ``norm0``,
  ``denseblock{i}.denselayer{j}.{norm1,conv1,norm2,conv2}``,
  ``transition{i}.{norm,conv}``), so a torchvision ``densenet161``
  state_dict loads into it with ``strict=False`` (its ``norm5``,
  ``classifier`` and ``num_batches_tracked`` entries are not used).
- :class:`ResnetEncoder` (18/34/50) and :class:`MobileNetV2Encoder` (with
  and without its last 1x1 layer): their modules are registered under the
  flax scope names (``Conv_0``, ``BatchNorm_0``, ``BasicResBlock_3``,
  ``InvertedResidual_5``), so their checkpoint keys are the JAX package's.

Every BatchNorm is :class:`BatchNorm`, with flax's running-statistics rule.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

DENSENET_CONFIGS = {
    121: dict(growth=32, init_features=64, blocks=(6, 12, 24, 16)),
    161: dict(growth=48, init_features=96, blocks=(6, 12, 36, 24)),
    169: dict(growth=32, init_features=64, blocks=(6, 12, 32, 32)),
    201: dict(growth=32, init_features=64, blocks=(6, 12, 48, 32)),
}


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)[:, None, None]
    return (x - mean) / std


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm`` in NCHW: epsilon 1e-5, momentum 0.99.

    In training mode it normalises with the batch's mean and biased variance
    and updates ``running = 0.99 * running + 0.01 * batch`` with that same
    biased variance. ``nn.BatchNorm2d`` would put the unbiased variance into
    ``running_var``, n/(n-1) larger (8/7 for the /32 tap of a 64^2 batch of
    2). In eval mode it normalises with the running statistics.
    """

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.99):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
            self.running_var.mul_(self.momentum).add_(var, alpha=1 - self.momentum)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


def conv(c_in: int, c_out: int, k: int, stride: int = 1, padding: int = 0,
         groups: int = 1) -> nn.Conv2d:
    """A bias-free conv, as the encoders' flax ``nn.Conv(use_bias=False)``."""
    return nn.Conv2d(c_in, c_out, k, stride, padding, groups=groups, bias=False)


def _stem_pool(x: torch.Tensor) -> torch.Tensor:
    # flax: pad with -inf by 1, then a VALID 3x3 / 2 max pool
    return F.max_pool2d(x, 3, 2, padding=1)


class DenseLayer(nn.Module):
    def __init__(self, c_in: int, growth: int, bn_size: int = 4):
        super().__init__()
        self.norm1 = BatchNorm(c_in)
        self.conv1 = conv(c_in, bn_size * growth, 1)
        self.norm2 = BatchNorm(bn_size * growth)
        self.conv2 = conv(bn_size * growth, growth, 3, padding=1)

    def forward(self, x):
        h = self.conv1(F.relu(self.norm1(x)))
        h = self.conv2(F.relu(self.norm2(h)))
        return torch.cat([x, h], 1)


class DenseBlock(nn.Module):
    def __init__(self, c_in: int, n_layers: int, growth: int):
        super().__init__()
        for j in range(n_layers):
            self.add_module(f"denselayer{j + 1}", DenseLayer(c_in + j * growth, growth))

    def forward(self, x):
        for layer in self.children():
            x = layer(x)
        return x


class Transition(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.norm = BatchNorm(c_in)
        self.conv = conv(c_in, c_out, 1)

    def forward(self, x):
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2)  # VALID: floors odd sizes


class DenseEncoder(nn.Module):
    """DenseNet trunk with the five monodepth feature taps."""

    def __init__(self, num_layers: int = 161, normalize_input: bool = False):
        super().__init__()
        cfg = DENSENET_CONFIGS[num_layers]
        self.normalize_input = normalize_input
        self.n_blocks = len(cfg["blocks"])
        ch = cfg["init_features"]
        f = nn.ModuleDict()
        f["conv0"] = conv(3, ch, 7, stride=2, padding=3)
        f["norm0"] = BatchNorm(ch)
        n_ch = [ch, ch]
        for i, n_layers in enumerate(cfg["blocks"]):
            f[f"denseblock{i + 1}"] = DenseBlock(ch, n_layers, cfg["growth"])
            ch += n_layers * cfg["growth"]
            if i < len(cfg["blocks"]) - 1:
                f[f"transition{i + 1}"] = Transition(ch, ch // 2)
                ch //= 2
                if i < 2:
                    n_ch.append(ch)
        self.features = f
        self.num_ch_enc = self.tap_channels = n_ch + [ch]

    def forward(self, x):
        f = self.features
        if self.normalize_input:
            x = normalize_imagenet(x)
        x = F.relu(f["norm0"](f["conv0"](x)))
        taps = [x]  # relu0: [N, 96, H/2, W/2], the VDN feature map
        x = _stem_pool(x)
        taps.append(x)  # pool0: /4
        for i in range(1, self.n_blocks + 1):
            x = f[f"denseblock{i}"](x)
            if i < self.n_blocks:
                x = f[f"transition{i}"](x)
                if i <= 2:
                    taps.append(x)  # transition1 /8, transition2 /16
        taps.append(x)  # denseblock4's output (pre-norm5): /32
        return tuple(taps)


class BasicResBlock(nn.Module):
    expansion = 1

    def __init__(self, c_in: int, channels: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = conv(c_in, channels, 3, stride, 1)
        self.BatchNorm_0 = BatchNorm(channels)
        self.Conv_1 = conv(channels, channels, 3, 1, 1)
        self.BatchNorm_1 = BatchNorm(channels)
        self.project = stride != 1 or c_in != channels
        if self.project:
            self.Conv_2 = conv(c_in, channels, 1, stride)
            self.BatchNorm_2 = BatchNorm(channels)

    def forward(self, x):
        h = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        h = self.BatchNorm_1(self.Conv_1(h))
        identity = self.BatchNorm_2(self.Conv_2(x)) if self.project else x
        return F.relu(h + identity)


class BottleneckResBlock(nn.Module):
    expansion = 4

    def __init__(self, c_in: int, channels: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = conv(c_in, channels, 1)
        self.BatchNorm_0 = BatchNorm(channels)
        self.Conv_1 = conv(channels, channels, 3, stride, 1)
        self.BatchNorm_1 = BatchNorm(channels)
        self.Conv_2 = conv(channels, channels * 4, 1)
        self.BatchNorm_2 = BatchNorm(channels * 4)
        self.project = stride != 1 or c_in != channels * 4
        if self.project:
            self.Conv_3 = conv(c_in, channels * 4, 1, stride)
            self.BatchNorm_3 = BatchNorm(channels * 4)

    def forward(self, x):
        h = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        h = F.relu(self.BatchNorm_1(self.Conv_1(h)))
        h = self.BatchNorm_2(self.Conv_2(h))
        identity = self.BatchNorm_3(self.Conv_3(x)) if self.project else x
        return F.relu(h + identity)


RESNET_CONFIGS = {
    18: (BasicResBlock, (2, 2, 2, 2)),
    34: (BasicResBlock, (3, 4, 6, 3)),
    50: (BottleneckResBlock, (3, 4, 6, 3)),
}


class ResnetEncoder(nn.Module):
    """ResNet tap stack (reference resnet_encoder.py:17-106)."""

    def __init__(self, num_layers: int = 18, normalize_input: bool = False):
        super().__init__()
        block, layers = RESNET_CONFIGS[num_layers]
        self.normalize_input = normalize_input
        exp = block.expansion
        self.num_ch_enc = self.tap_channels = [64, 64 * exp, 128 * exp, 256 * exp, 512 * exp]
        self.Conv_0 = conv(3, 64, 7, 2, 3)
        self.BatchNorm_0 = BatchNorm(64)
        self.stages: list[list[str]] = []
        c_in, k = 64, 0
        for i, (n, ch) in enumerate(zip(layers, (64, 128, 256, 512))):
            names = []
            for j in range(n):
                name = f"{block.__name__}_{k}"
                self.add_module(name, block(c_in, ch, 2 if (i > 0 and j == 0) else 1))
                c_in, k = ch * exp, k + 1
                names.append(name)
            self.stages.append(names)

    def forward(self, x):
        if self.normalize_input:
            x = normalize_imagenet(x)
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        taps = [x]  # /2
        x = _stem_pool(x)
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            taps.append(x)
        return tuple(taps)


class InvertedResidual(nn.Module):
    """[1x1 expand ->] 3x3 depthwise -> 1x1 project, each conv followed by its
    BatchNorm (``Conv_i``, ``BatchNorm_i``) and all but the last by relu6."""

    def __init__(self, c_in: int, c_out: int, stride: int, expand: int):
        super().__init__()
        hidden = c_in * expand
        self.residual = stride == 1 and c_in == c_out
        convs = [conv(c_in, hidden, 1)] if expand != 1 else []
        convs += [conv(hidden, hidden, 3, stride, 1, groups=hidden), conv(hidden, c_out, 1)]
        self.n_convs = len(convs)
        for i, c in enumerate(convs):
            self.add_module(f"Conv_{i}", c)
            self.add_module(f"BatchNorm_{i}", BatchNorm(c.out_channels))

    def forward(self, x):
        h = x
        for i in range(self.n_convs):
            h = getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(h))
            if i < self.n_convs - 1:
                h = F.relu6(h)
        return h + x if self.residual else h


# t, c, n, s: the standard MobileNetV2 schedule
MOBILENET_V2 = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


class MobileNetV2Encoder(nn.Module):
    """MobileNetV2 tap stack (reference mobilenetv2_encoder.py:12-181)."""

    def __init__(self, normalize_input: bool = False, use_last_layer: bool = True):
        super().__init__()
        self.normalize_input = normalize_input
        self.use_last_layer = use_last_layer
        # the JAX package's nominal widths; without the last layer the /32
        # tap is the 320-channel block's output
        self.num_ch_enc = [32, 24, 32, 64, 1280 if use_last_layer else 160]
        self.tap_channels = [32, 24, 32, 64, 1280 if use_last_layer else 320]
        self.Conv_0 = conv(3, 32, 3, 2, 1)
        self.BatchNorm_0 = BatchNorm(32)
        self.stages: list[tuple[int, list[str]]] = []
        c_in, k = 32, 0
        for t, c, n, s in MOBILENET_V2:
            names = []
            for j in range(n):
                name = f"InvertedResidual_{k}"
                self.add_module(name, InvertedResidual(c_in, c, s if j == 0 else 1, t))
                c_in, k = c, k + 1
                names.append(name)
            self.stages.append((c, names))
        if use_last_layer:
            self.Conv_1 = conv(c_in, 1280, 1)
            self.BatchNorm_1 = BatchNorm(1280)

    def forward(self, x):
        if self.normalize_input:
            x = normalize_imagenet(x)
        x = F.relu6(self.BatchNorm_0(self.Conv_0(x)))
        taps = [x]  # /2: 32
        for c, names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            if c in (24, 32, 64):
                taps.append(x)
        if self.use_last_layer:
            x = F.relu6(self.BatchNorm_1(self.Conv_1(x)))
        taps.append(x)
        return tuple(taps[:5])
