"""2-D ResNet backbone (counterpart of ``mvfnet_tpu/models/backbones/resnet.py``).

Module names follow the reference torch ResNet, so its checkpoints load as
they are: ``conv1``, ``bn1``, ``layer{i}.{j}.{conv1,bn1,conv2,bn2,conv3,bn3,
downsample.{0,1}}``, and an MVF-wrapped ``conv1`` as ``conv1.{net,
shift_conv,h_conv,w_conv,bn}``. The JAX package's TPU re-layouts of conv1
(``_SplitPointwiseConv``) and of the stem (``_SpaceToDepthStem``) are plain
convs here; the same parameters load.

In ``eval()`` with no gradient recorded, each stride-1 bottleneck without a
downsample or temporal module folds its three BatchNorms into the conv
weights and runs as one fused call, ``ops.fused_block.bottleneck_eval``:
the hand-written CUDA kernel on the card, its plain version on the CPU.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ...ops import fused_block as fb
from ..builder import BACKBONES
from ..common import (conv2d, lecun_normal_, make_norm,
                      max_pool_same_as_torch, to_nchw, to_nhwc)
from ..modules.mvf import MVF


class Bottleneck(nn.Module):
    """ResNet Bottleneck; ``temporal_cfg`` wraps conv1 in a temporal module
    (MVF), the reference's ``blocks[i].conv1 = MVF(b.conv1, ...)``."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, with_downsample: bool = False,
                 style: str = 'pytorch', norm_cfg: Optional[Dict] = None,
                 temporal_cfg: Optional[Dict] = None):
        super().__init__()
        if style not in ('pytorch', 'caffe'):
            raise ValueError(f'style {style!r}')
        self.stride = stride
        self.dilation = dilation
        self.style = style
        conv1_stride, conv2_stride = ((1, stride) if style == 'pytorch'
                                      else (stride, 1))
        conv1 = conv2d(inplanes, planes, 1, stride=conv1_stride)
        self.has_temporal = temporal_cfg is not None
        if temporal_cfg is not None:
            cfg = dict(temporal_cfg)
            kind = cfg.pop('type')
            if kind != 'MVF':
                raise NotImplementedError(
                    f'temporal module {kind} is not ported yet')
            conv1 = MVF(conv1, in_channels=inplanes, **cfg)
        self.conv1 = conv1
        self.bn1 = make_norm(norm_cfg, planes)
        self.conv2 = conv2d(planes, planes, 3, stride=conv2_stride,
                            padding=dilation, dilation=dilation)
        self.bn2 = make_norm(norm_cfg, planes)
        self.conv3 = conv2d(planes, planes * self.expansion, 1)
        self.bn3 = make_norm(norm_cfg, planes * self.expansion)
        self._fused = None      # (key, folded weights), see _fused_weights
        self.downsample = None
        if with_downsample:
            self.downsample = nn.Sequential(
                conv2d(inplanes, planes * self.expansion, 1, stride=stride),
                make_norm(norm_cfg, planes * self.expansion))

    @property
    def fusable(self) -> bool:
        """Shapes the fused eval kernel computes: stride 1, no downsample,
        no temporal module, pytorch style, dilation 1."""
        return (self.stride == 1 and self.downsample is None
                and not self.has_temporal and self.style == 'pytorch'
                and self.dilation == 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (self.fusable and not self.training
                and not torch.is_grad_enabled()):
            return self._forward_fused(x)
        identity = x
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return torch.relu(out + identity)

    def train(self, mode: bool = True):
        # BN statistics updated in training bump no version counter
        self._fused = None
        return super().train(mode)

    def _apply(self, fn, *args, **kwargs):
        self._fused = None
        return super()._apply(fn, *args, **kwargs)

    def _fused_weights(self, dtype: torch.dtype):
        """The three BNs folded into the weights (in fp32, then cast), stored
        output-channel-major for the kernel. Made once after ``eval()``, a
        move or a load, and again only when a parameter or BN statistic is
        changed in place (its version counter moves)."""
        pairs = ((self.conv1, self.bn1), (self.conv2, self.bn2),
                 (self.conv3, self.bn3))
        tensors = [t for conv, bn in pairs for t in (
            conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var)]
        key = (dtype,) + tuple((t.data_ptr(), t._version) for t in tensors)
        if self._fused is not None and self._fused[0] == key:
            return self._fused[1]
        # kernels with the output channel last, as fold_bn expects
        kernels = (self.conv1.weight[:, :, 0, 0].t(),        # (Cin, Cm)
                   self.conv2.weight.permute(2, 3, 1, 0),    # HWIO
                   self.conv3.weight[:, :, 0, 0].t())        # (Cm, Cin)
        folded = []
        with torch.no_grad():
            for k, (_, bn) in zip(kernels, pairs):
                w, b = fb.fold_bn(k, bn.weight, bn.bias, bn.running_mean,
                                  bn.running_var, bn.eps)
                folded += [fb.out_major(w.to(dtype)), b.reshape(1, -1)]
        self._fused = (key, folded)
        return folded

    def _forward_fused(self, x: torch.Tensor) -> torch.Tensor:
        folded = self._fused_weights(x.dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        return to_nchw(fb.bottleneck_eval(to_nhwc(x), *folded))


@BACKBONES.register_module
class ResNet(nn.Module):
    """ResNet-50/101/152 with Bottleneck blocks, torch state-dict names.

    ``temporal_cfg``: e.g. ``dict(type='MVF', n_segment=8, alpha=0.125,
    mode='THW')``; ``temporal_freq``: per-stage 0/1 mask (the reference's
    ``mvf_freq``), every block of a selected stage gets the module.
    ``stem_s2d`` and ``pretrained`` are accepted for config compatibility:
    the stem is always the plain 7x7/s2/p3 conv, and weights come from the
    checkpoint loader. ``frozen_stages`` and ``norm_frozen`` freeze
    parameters in the optimizer, not here
    (``engine.optim.frozen_prefixes_from_backbone``); ``frozen_stages`` also
    picks the stages that ``partial_norm`` keeps in eval mode.
    """
    arch_settings = {
        50: (Bottleneck, (3, 4, 6, 3)),
        101: (Bottleneck, (3, 4, 23, 3)),
        152: (Bottleneck, (3, 8, 36, 3)),
    }

    def __init__(self, depth: int, in_channels: int = 3, num_stages: int = 4,
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 style: str = 'pytorch', frozen_stages: int = -1,
                 norm_cfg: Optional[Dict] = None, norm_eval: bool = True,
                 norm_frozen: bool = False,
                 partial_norm: bool = False, stem_s2d: bool = True,
                 temporal_cfg: Optional[Dict] = None,
                 temporal_freq: Sequence[int] = (0, 0, 0, 0),
                 pretrained: Optional[str] = None):
        super().__init__()
        if depth not in self.arch_settings:
            raise KeyError(f'invalid depth {depth} for resnet (ported: '
                           f'{sorted(self.arch_settings)})')
        block_cls, stage_blocks = self.arch_settings[depth]
        self.out_indices = tuple(out_indices)
        self.norm_eval = norm_eval
        self.partial_norm = partial_norm
        self.frozen_stages = frozen_stages
        self.conv1 = conv2d(in_channels, 64, 7, stride=2, padding=3)
        self.bn1 = make_norm(norm_cfg, 64)
        self.maxpool = max_pool_same_as_torch(3, 2, 1)
        inplanes = 64
        self.num_stages = num_stages
        for i, num_blocks in enumerate(stage_blocks[:num_stages]):
            planes = 64 * 2 ** i
            stage_temporal = (temporal_cfg
                              if temporal_cfg and temporal_freq[i] else None)
            blocks = []
            for j in range(num_blocks):
                stride = strides[i] if j == 0 else 1
                with_ds = j == 0 and (strides[i] != 1 or
                                      inplanes != planes * block_cls.expansion)
                blocks.append(block_cls(
                    inplanes, planes, stride=stride, dilation=dilations[i],
                    with_downsample=with_ds, style=style, norm_cfg=norm_cfg,
                    temporal_cfg=stage_temporal))
                inplanes = planes * block_cls.expansion
            self.add_module(f'layer{i + 1}', nn.Sequential(*blocks))

    def init_weights(self, generator: torch.Generator) -> None:
        """JAX-package init: lecun-normal convs, BN gamma 1 beta 0, MVF taps
        N(0, sqrt(2/(3*cs)))."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, MVF):
                m.reset_taps(generator)

    def train(self, mode: bool = True):
        """``norm_eval`` keeps every BatchNorm (MVF's too) in eval mode while
        training; ``partial_norm`` does so for stages 1..frozen_stages."""
        super().train(mode)
        if mode:
            for i in range(self.num_stages):
                if self.norm_eval or (self.partial_norm
                                      and i + 1 <= self.frozen_stages):
                    for m in getattr(self, f'layer{i + 1}').modules():
                        if isinstance(m, nn.BatchNorm2d):
                            m.eval()
            if self.norm_eval:
                self.bn1.eval()
        return self

    def forward(self, x: torch.Tensor):
        """x: (N, C, H, W), any memory format; returns channels_last maps."""
        x = x.contiguous(memory_format=torch.channels_last)
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f'layer{i + 1}')(x)
            if i in self.out_indices:
                outs.append(x)
        if len(outs) == 1:
            return outs[0]
        return tuple(outs)
