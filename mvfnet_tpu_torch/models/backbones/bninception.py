"""BN-Inception backbone (counterpart of ``mvfnet_tpu/models/backbones/bninception.py``).

The classic TSN 2-D backbone, built from one inception-block description
per block (``_BLOCKS``), with the reference's caffe-converted quirks:

- every conv has a bias; BatchNorm is torch's ``momentum=0.9`` (new
  statistics weigh 0.9), eps 1e-5
- the branches are concatenated after their relu, in the order 1x1, 3x3,
  double 3x3, pool
- the reduction blocks 3c and 4e have no 1x1 branch, stride 2 in their
  3x3 and second double-3x3 convs, and an unprojected 3x3/s2 max pool
- the other blocks pool 3x3/s1 with padding 1 and project: 5b's pool is a
  max pool, the others average with the padding counted
- the stem and reduction max pools are ``_ceil_max_pool``: the JAX
  package's form of ``MaxPool2d(3, 2, ceil_mode=True)``, which pads the
  end only when the map is larger than the window

Module names are the reference's flat ones, so its checkpoints load as
they are: ``conv1_7x7_s2`` and ``conv1_7x7_s2_bn``, ``inception_3a_1x1``
and ``inception_3a_1x1_bn``, ``..._3x3_reduce``, ``..._3x3``,
``..._double_3x3_reduce``, ``..._double_3x3_1``, ``..._double_3x3_2``,
``..._pool_proj`` (each with its ``_bn``). ``bn_eval`` keeps every
BatchNorm in eval mode while training, as the JAX module's
``use_running_average``; ``bn_frozen``, ``partial_bn`` and ``pretrained``
are accepted and change nothing, as there.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..builder import BACKBONES
from ..common import BN_EPS, BatchNorm, conv2d, lecun_normal_

# (name, 1x1, 3x3_reduce, 3x3, dbl_reduce, dbl_1, dbl_2, pool, proj, stride)
_BLOCKS = (
    ('3a', 64, 64, 64, 64, 96, 96, 'avg', 32, 1),
    ('3b', 64, 64, 96, 64, 96, 96, 'avg', 64, 1),
    ('3c', 0, 128, 160, 64, 96, 96, 'max', 0, 2),
    ('4a', 224, 64, 96, 96, 128, 128, 'avg', 128, 1),
    ('4b', 192, 96, 128, 96, 128, 128, 'avg', 128, 1),
    ('4c', 160, 128, 160, 128, 160, 160, 'avg', 128, 1),
    ('4d', 96, 128, 192, 160, 192, 192, 'avg', 128, 1),
    ('4e', 0, 128, 192, 192, 256, 256, 'max', 0, 2),
    ('5a', 352, 192, 320, 160, 224, 224, 'avg', 128, 1),
    ('5b', 352, 192, 320, 192, 224, 224, 'max', 128, 1),
)

_BN_MOMENTUM = 0.9   # torch's: the new statistics weigh 0.9


def _ceil_max_pool(x: torch.Tensor, window: int = 3,
                   stride: int = 2) -> torch.Tensor:
    """The JAX package's ``_ceil_max_pool`` on NCHW x: -inf padding at the
    end of H and W up to a whole last stride when the side is larger than
    the window, then a valid max pool. Torch's ``ceil_mode`` agrees except
    below the window, where it still gives one value (a 2x2 map gives
    1x1) and this pool, as the JAX one, none."""
    h, w = x.shape[-2:]
    pad_h = (-(h - window)) % stride if h > window else 0
    pad_w = (-(w - window)) % stride if w > window else 0
    if pad_h or pad_w:
        x = F.pad(x, (0, pad_w, 0, pad_h), value=float('-inf'))
    return F.max_pool2d(x, window, stride)


class _ConvBN:
    """conv (with bias) -> BatchNorm -> relu, registered on ``owner`` as
    ``name`` and ``name + '_bn'`` (the reference's flat names)."""

    def __init__(self, owner: nn.Module, name: str, cin: int, cout: int,
                 kernel: int = 1, stride: int = 1, padding: int = 0):
        self.conv = conv2d(cin, cout, kernel, stride=stride, padding=padding,
                           bias=True)
        self.bn = BatchNorm(cout, eps=BN_EPS, momentum=_BN_MOMENTUM)
        owner.add_module(name, self.conv)
        owner.add_module(name + '_bn', self.bn)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class _InceptionBlock:
    """One inception block of ``_BLOCKS``, its layers registered on
    ``owner`` as ``inception_{name}_{branch}``."""

    def __init__(self, owner: nn.Module, cin: int, name: str, c1x1: int,
                 reduce3: int, c3x3: int, dreduce: int, d1: int, d2: int,
                 pool: str, proj: int, stride: int):
        pre = f'inception_{name}_'
        self.pool, self.stride = pool, stride
        self.b1x1 = (_ConvBN(owner, pre + '1x1', cin, c1x1)
                     if c1x1 else None)
        self.b3 = [_ConvBN(owner, pre + '3x3_reduce', cin, reduce3),
                   _ConvBN(owner, pre + '3x3', reduce3, c3x3, 3, stride, 1)]
        self.bd = [_ConvBN(owner, pre + 'double_3x3_reduce', cin, dreduce),
                   _ConvBN(owner, pre + 'double_3x3_1', dreduce, d1, 3, 1, 1),
                   _ConvBN(owner, pre + 'double_3x3_2', d1, d2, 3, stride,
                           1)]
        self.proj = (_ConvBN(owner, pre + 'pool_proj', cin, proj)
                     if stride == 1 else None)
        self.out_channels = c1x1 + c3x3 + d2 + (proj if stride == 1
                                                 else cin)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        branches: List[torch.Tensor] = []
        if self.b1x1 is not None:
            branches.append(self.b1x1(x))
        for chain in (self.b3, self.bd):
            y = x
            for layer in chain:
                y = layer(y)
            branches.append(y)
        if self.stride == 2:
            branches.append(_ceil_max_pool(x, 3, 2))
        else:
            if self.pool == 'avg':
                y = F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)
            else:
                y = F.max_pool2d(x, 3, 1, 1)
            branches.append(self.proj(y))
        return torch.cat(branches, dim=1)


@BACKBONES.register_module
class BNInception(nn.Module):
    """(N, C, H, W) -> (N, 1024, h, w), 7x7 at 224 input."""

    def __init__(self, pretrained: Optional[str] = None, bn_eval: bool = True,
                 bn_frozen: bool = False, partial_bn: bool = False,
                 in_channels: int = 3):
        super().__init__()
        self.bn_eval = bn_eval
        self.stem = [
            _ConvBN(self, 'conv1_7x7_s2', in_channels, 64, 7, 2, 3),
            _ConvBN(self, 'conv2_3x3_reduce', 64, 64),
            _ConvBN(self, 'conv2_3x3', 64, 192, 3, 1, 1)]
        cin = 192
        self.blocks = []
        for name, *widths in _BLOCKS:
            block = _InceptionBlock(self, cin, name, *widths)
            self.blocks.append(block)
            cin = block.out_channels

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's init: lecun-normal convs with zero biases,
        norm gamma 1 beta 0."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def train(self, mode: bool = True):
        super().train(mode)
        if mode and self.bn_eval:
            for m in self.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.eval()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous(memory_format=torch.channels_last)
        conv1, conv2_reduce, conv2 = self.stem
        x = _ceil_max_pool(conv1(x))
        x = _ceil_max_pool(conv2(conv2_reduce(x)))
        for block in self.blocks:
            x = block(x)
        return x
