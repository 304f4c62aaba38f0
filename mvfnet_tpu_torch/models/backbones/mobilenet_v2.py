"""MobileNetV2 backbone (counterpart of ``mvfnet_tpu/models/backbones/mobilenet_v2.py``).

Module names are d-li14's ``mobilenetv2.pytorch``, the reference's
pretrained source, so its checkpoints load as they are: the stem
``features.0.{0,1}``, inverted residual ``K`` as ``features.K.conv.I``
(pointwise conv, norm, relu6, depthwise conv, norm, relu6, linear conv,
norm; without the expansion, from the depthwise conv on) and the head
``conv.{0,1}``. The temporal module (``temporal_cfg``: MVF, or 'tsm' for
the temporal shift) runs before the first pointwise conv of every block
that expands and keeps its shape, as the reference's surgery places it:
MVF wraps the conv (``features.K.conv.0.net.weight``), the shift is a
``ShiftConv2d`` that keeps the conv's name. ``width_mult`` scales
the channels by ``_make_divisible``'s rule; ``norm_eval`` keeps every
BatchNorm in eval mode while training. ``n_class``, ``input_size`` and
``pretrained`` are accepted for config compatibility.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..builder import BACKBONES
from ..common import Conv2d, conv2d, lecun_normal_, make_norm
from ..modules.mvf import MVF
from ..modules.tsm import ShiftConv2d


def _make_divisible(v, divisor, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class _ReLU6(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.hardtanh(x, 0.0, 6.0)


def _depthwise(channels: int, stride: int) -> Conv2d:
    return Conv2d(channels, channels, 3, stride=stride, padding=1,
                  groups=channels, bias=False)


def _expand_conv(inp: int, hidden: int,
                 temporal_cfg: Optional[Dict]) -> nn.Module:
    """The expanding 1x1 conv, in MVF or shifting first with TSM."""
    if not temporal_cfg:
        return conv2d(inp, hidden, 1)
    cfg = dict(temporal_cfg)
    kind = cfg.pop('type')
    if kind == 'MVF':
        cfg.pop('n_div', None)
        return MVF(conv2d(inp, hidden, 1), in_channels=inp, **cfg)
    if kind == 'tsm':
        return ShiftConv2d(inp, hidden, 1, bias=False,
                           n_segment=cfg['n_segment'],
                           n_div=cfg.get('n_div', 8))
    raise KeyError(kind)


class InvertedResidual(nn.Module):
    """1x1 expand (when ``expand_ratio`` > 1), 3x3 depthwise (stride), 1x1
    linear, each with a norm, relu6 after the first two; the input added
    when the shape is kept. ``temporal_cfg`` wraps the expanding conv of an
    identity block."""

    def __init__(self, inp: int, oup: int, stride: int, expand_ratio: int,
                 norm_cfg: Optional[Dict] = None,
                 temporal_cfg: Optional[Dict] = None):
        super().__init__()
        hidden = round(inp * expand_ratio)
        self.identity = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            pw = _expand_conv(inp, hidden,
                              temporal_cfg if self.identity else None)
            layers += [pw, make_norm(norm_cfg, hidden), _ReLU6()]
        layers += [_depthwise(hidden, stride), make_norm(norm_cfg, hidden),
                   _ReLU6(), conv2d(hidden, oup, 1),
                   make_norm(norm_cfg, oup)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv(x)
        return x + out if self.identity else out


@BACKBONES.register_module
class MobileNetV2(nn.Module):
    cfgs = (
        # t, c, n, s
        (1, 16, 1, 1),
        (6, 24, 2, 2),
        (6, 32, 3, 2),
        (6, 64, 4, 2),
        (6, 96, 3, 1),
        (6, 160, 3, 2),
        (6, 320, 1, 1),
    )

    def __init__(self, pretrained: Optional[str] = None, n_class: int = 1000,
                 input_size: int = 224, width_mult: float = 1.0,
                 norm_cfg: Optional[Dict] = None, norm_eval: bool = False,
                 temporal_cfg: Optional[Dict] = None, in_channels: int = 3):
        super().__init__()
        self.norm_eval = norm_eval
        div = 4 if width_mult == 0.1 else 8
        ch = _make_divisible(32 * width_mult, div)
        layers = [nn.Sequential(conv2d(in_channels, ch, 3, stride=2,
                                       padding=1),
                                make_norm(norm_cfg, ch), _ReLU6())]
        for t, c, n, s in self.cfgs:
            out_ch = _make_divisible(c * width_mult, div)
            for i in range(n):
                layers.append(InvertedResidual(
                    ch, out_ch, s if i == 0 else 1, t, norm_cfg=norm_cfg,
                    temporal_cfg=temporal_cfg))
                ch = out_ch
        self.features = nn.Sequential(*layers)
        out_ch = (_make_divisible(1280 * width_mult, div)
                  if width_mult > 1.0 else 1280)
        self.conv = nn.Sequential(conv2d(ch, out_ch, 1),
                                  make_norm(norm_cfg, out_ch), _ReLU6())

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's init: lecun-normal convs, norm gamma 1 beta 0,
        MVF taps N(0, sqrt(2/(3*cs)))."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, MVF):
                m.reset_taps(generator)

    def train(self, mode: bool = True):
        super().train(mode)
        if mode and self.norm_eval:
            for m in self.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.eval()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, C, H, W), any memory format; returns a channels_last
        map."""
        x = x.contiguous(memory_format=torch.channels_last)
        return self.conv(self.features(x))
