"""I3D GoogLeNet (counterpart of ``mvfnet_tpu/models/backbones/inception_v1_i3d.py``).

The original I3D inflation of InceptionV1, built from one description
per inception block (GoogLeNet's channel table), with the reference's
quirks:

- the stem pads (2, 4) on each of T, H and W, TF's asymmetric 'SAME' for
  its 7x7x7 stride-2 conv
- the stem's two pools are spatial (1, 3, 3)/(1, 2, 2), the reduction
  pools after 3b (3, 3, 3)/(2, 2, 2) and after 4e (2, 2, 2)/(2, 2, 2), all
  ``_ceil_max_pool3d``: the JAX package's ceil-mode pool, which pads the
  end of an axis larger than the window up to a whole last stride and
  leaves a smaller axis alone, so that it gives no output there (torch's
  ``ceil_mode`` gives one)
- every branch 3x3 is a full 3x3x3; convs have no bias; BatchNorm eps 1e-5
- ``modality='Flow'`` makes the stem take 2 channels

Module names are the reference's flat ones, so its checkpoints load as
they are: ``conv1_7x7_s2``, ``conv1_7x7_s2_bn``, ``conv2_3x3_reduce`` (and
``_bn``), ``conv2_3x3`` (and ``_bn``), ``inception_3a_1x1``,
``..._branch1_3x3_reduce``, ``..._branch1_3x3``, ``..._branch2_3x3_reduce``,
``..._branch2_3x3``, ``..._pool_proj``, each with its ``_bn``. ``bn_eval``
keeps every BatchNorm in eval mode while training; ``bn_frozen``,
``partial_bn`` and ``pretrained`` are accepted and change nothing here, as
in the JAX module. Returns ``(N, 1024, T/8, H/32, W/32)``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..builder import BACKBONES
from ..common import BatchNorm, conv3d, make_norm
from .resnet_i3d import init_weights_3d

# (name, 1x1, b1_reduce, b1_3x3, b2_reduce, b2_3x3, pool_proj)
_BLOCKS = (
    (('3a', 64, 96, 128, 16, 32, 32),
     ('3b', 128, 128, 192, 32, 96, 64)),
    (('4a', 192, 96, 208, 16, 48, 64),
     ('4b', 160, 112, 224, 24, 64, 64),
     ('4c', 128, 128, 256, 24, 64, 64),
     ('4d', 112, 144, 288, 32, 64, 64),
     ('4e', 256, 160, 320, 32, 128, 128)),
    (('5a', 256, 160, 320, 32, 128, 128),
     ('5b', 384, 192, 384, 48, 128, 128)),
)
# the pool after each group of blocks but the last: (kernel, stride)
_REDUCTIONS = (((3, 3, 3), (2, 2, 2)), ((2, 2, 2), (2, 2, 2)))


def _ceil_max_pool3d(x: torch.Tensor, kernel: Sequence[int],
                     stride: Sequence[int]) -> torch.Tensor:
    """The JAX package's ``_ceil_max_pool3d`` on NCTHW x: -inf padding at
    the end of each of T, H and W larger than the window, up to a whole
    last stride, then a valid max pool."""
    extra = [(-(d - k)) % s if d > k else 0
             for d, k, s in zip(x.shape[2:], kernel, stride)]
    if any(extra):
        x = F.pad(x, (0, extra[2], 0, extra[1], 0, extra[0]),
                  value=float('-inf'))
    return F.max_pool3d(x, tuple(kernel), tuple(stride))


class _ConvBN:
    """conv (no bias) -> BatchNorm -> relu, registered on ``owner`` as
    ``name`` and ``name + '_bn'``."""

    def __init__(self, owner: nn.Module, name: str, cin: int, cout: int,
                 kernel=(1, 1, 1), padding=(0, 0, 0), stride=(1, 1, 1)):
        self.conv = conv3d(cin, cout, kernel, stride=stride,
                           padding=padding)
        self.bn = make_norm({'type': 'BN3d'}, cout)
        owner.add_module(name, self.conv)
        owner.add_module(name + '_bn', self.bn)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class _InceptionBlock3D:
    """Four branches concatenated: 1x1; 1x1 -> 3x3x3; 1x1 -> 3x3x3; a
    3x3x3/s1 max pool -> 1x1."""

    def __init__(self, owner: nn.Module, cin: int, name: str, c1x1: int,
                 b1r: int, b1: int, b2r: int, b2: int, proj: int):
        pre = f'inception_{name}_'
        full = dict(kernel=(3, 3, 3), padding=(1, 1, 1))
        self.b1x1 = _ConvBN(owner, pre + '1x1', cin, c1x1)
        self.b1 = (_ConvBN(owner, pre + 'branch1_3x3_reduce', cin, b1r),
                   _ConvBN(owner, pre + 'branch1_3x3', b1r, b1, **full))
        self.b2 = (_ConvBN(owner, pre + 'branch2_3x3_reduce', cin, b2r),
                   _ConvBN(owner, pre + 'branch2_3x3', b2r, b2, **full))
        self.proj = _ConvBN(owner, pre + 'pool_proj', cin, proj)
        self.out_channels = c1x1 + b1 + b2 + proj

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        pooled = F.max_pool3d(x, 3, 1, 1)
        return torch.cat([self.b1x1(x), self.b1[1](self.b1[0](x)),
                          self.b2[1](self.b2[0](x)), self.proj(pooled)],
                         dim=1)


@BACKBONES.register_module
class InceptionV1_I3D(nn.Module):
    """(N, C, T, H, W) with C = 3 (RGB) or 2 (Flow) -> (N, 1024, T/8,
    H/32, W/32)."""

    def __init__(self, pretrained: Optional[str] = None, bn_eval: bool = True,
                 bn_frozen: bool = False, partial_bn: bool = False,
                 modality: str = 'RGB'):
        super().__init__()
        if modality not in ('RGB', 'Flow'):
            raise ValueError(f'modality {modality!r}')
        self.bn_eval = bn_eval
        self.stem = [
            _ConvBN(self, 'conv1_7x7_s2', 3 if modality == 'RGB' else 2, 64,
                    (7, 7, 7), stride=(2, 2, 2)),
            _ConvBN(self, 'conv2_3x3_reduce', 64, 64),
            _ConvBN(self, 'conv2_3x3', 64, 192, (3, 3, 3), (1, 1, 1))]
        cin = 192
        self.groups = []
        for group in _BLOCKS:
            blocks = []
            for name, *widths in group:
                blocks.append(_InceptionBlock3D(self, cin, name, *widths))
                cin = blocks[-1].out_channels
            self.groups.append(blocks)

    init_weights = init_weights_3d

    def train(self, mode: bool = True):
        super().train(mode)
        if mode and self.bn_eval:
            for m in self.modules():
                if isinstance(m, BatchNorm):
                    m.eval()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous(memory_format=torch.channels_last_3d)
        conv1, conv2_reduce, conv2 = self.stem
        x = conv1(F.pad(x, (2, 4, 2, 4, 2, 4)))
        x = _ceil_max_pool3d(x, (1, 3, 3), (1, 2, 2))
        x = _ceil_max_pool3d(conv2(conv2_reduce(x)), (1, 3, 3), (1, 2, 2))
        for i, blocks in enumerate(self.groups):
            for block in blocks:
                x = block(x)
            if i < len(_REDUCTIONS):
                x = _ceil_max_pool3d(x, *_REDUCTIONS[i])
        return x
