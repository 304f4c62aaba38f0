"""R3D / R(2+1)D plain 3-D ResNets (counterpart of ``mvfnet_tpu/models/backbones/resnet_r3d.py``).

Block types, per conv of a block (``R3DConv``): '3d' (a full 3x3x3 conv),
'2.5d' (spatial 1x3x3 -> BN -> relu -> temporal 3x1x1, with the R(2+1)D
paper's middle width ``int(3*i*o*k^2 / (i*k^2 + 3*o))``), '0.3d' (1x1x1 ->
BN -> relu -> full) and '3d-sep' (depthwise). BatchNorm eps 1e-3 (the
caffe2 conversion), torch momentum; the shallow (depth <= 34, basic
blocks) and deep (bottlenecks) filter configs times ``channel_multiplier``
(the bottleneck width also times ``bottleneck_multiplier``); the first
block of every stage after the first strides (2, 2, 2) and projects its
shortcut (``conv3``/``bn3``); ``use_pool1`` adds a (1, 3, 3)/(1, 2, 2) max
pool after the stem. The R(2+1)D stem ('2.5d' and '2.5d-sep') is a
45-channel 1x7x7/(1, 2, 2) conv -> BN -> relu -> ``conv1_kernel_t`` x 1 x 1
to 64 -> BN -> relu; the others' is one ``conv1_kernel_t`` x 7 x 7 conv.
Without ``with_bn`` there are no BatchNorms and every conv has a bias.

Module names are the reference's, so its checkpoints load as they are: the
stem's ``conv1_s``, ``bn1_s``, ``conv1_t``, ``bn1_t`` (or ``conv1``,
``bn1``), blocks named ``a``, ``b``, ... in each ``layer{i}`` (the
reference's ModuleList), a '2.5d' conv's ``conv_s``, ``bn_s``, ``conv_t``
and the bottleneck's ``conv0``/``bn0``. The other block types' children
take the JAX module's names (``conv``; ``conv_T``, ``bn_T``, ``conv_C``).
``bn_eval`` keeps every BatchNorm in eval mode while training (the JAX
module's ``use_running_average``); ``bn_frozen`` and ``pretrained`` are
accepted and change nothing here, as there. Returns the last stage's
NCTHW maps.
"""

from __future__ import annotations

import string
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..builder import BACKBONES
from ..common import BN_MOMENTUM, BatchNorm, conv3d, max_pool3d
from .resnet_i3d import init_weights_3d

BLOCK_CONFIG = {
    10: (1, 1, 1, 1), 16: (2, 2, 2, 1), 18: (2, 2, 2, 2),
    26: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
    101: (3, 4, 23, 3), 152: (3, 8, 36, 3),
}
SHALLOW_FILTER_CONFIG = ((64, 64), (128, 128), (256, 256), (512, 512))
DEEP_FILTER_CONFIG = ((256, 64), (512, 128), (1024, 256), (2048, 512))

BN_EPS = 1e-3


def _bn(channels: int, with_bn: bool) -> Optional[nn.Module]:
    return BatchNorm(channels, eps=BN_EPS, momentum=BN_MOMENTUM) \
        if with_bn else None


def _norm_relu(bn: Optional[nn.Module], x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x if bn is None else bn(x))


class R3DConv(nn.Module):
    """One conv of a block as ``block_type`` says (the reference's
    ``add_conv3d``)."""

    def __init__(self, in_filters: int, out_filters: int,
                 kernel: Tuple[int, int, int], stride: Tuple[int, int, int],
                 pad: Tuple[int, int, int], block_type: str = '3d',
                 with_bn: bool = True):
        super().__init__()
        self.block_type = block_type
        bias = not with_bn
        kt, kh, kw = kernel
        st, sh, sw = stride
        pt, ph, pw = pad
        if block_type == '2.5d':
            mid = int(3 * in_filters * out_filters * kh * kw
                      / (in_filters * kh * kw + 3 * out_filters))
            self.conv_s = conv3d(in_filters, mid, (1, kh, kw),
                                 stride=(1, sh, sw), padding=(0, ph, pw),
                                 bias=bias)
            self.bn_s = _bn(mid, with_bn)
            self.conv_t = conv3d(mid, out_filters, (kt, 1, 1),
                                 stride=(st, 1, 1), padding=(pt, 0, 0),
                                 bias=bias)
        elif block_type == '0.3d':
            self.conv_T = conv3d(in_filters, out_filters, (1, 1, 1),
                                 bias=bias)
            self.bn_T = _bn(out_filters, with_bn)
            self.conv_C = conv3d(out_filters, out_filters, kernel,
                                 stride=stride, padding=pad, bias=bias)
        elif block_type == '3d-sep':
            if in_filters != out_filters:
                raise ValueError("block_type '3d-sep' keeps the width")
            self.conv = conv3d(in_filters, out_filters, kernel,
                               stride=stride, padding=pad,
                               groups=in_filters, bias=bias)
        else:
            self.conv = conv3d(in_filters, out_filters, kernel,
                               stride=stride, padding=pad, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.block_type == '2.5d':
            return self.conv_t(_norm_relu(self.bn_s, self.conv_s(x)))
        if self.block_type == '0.3d':
            return self.conv_C(_norm_relu(self.bn_T, self.conv_T(x)))
        return self.conv(x)


def _block_stride(down_sampling: bool) -> Tuple[int, int, int]:
    # every block is real 3-D with temporal down-sampling where spatial
    return (2, 2, 2) if down_sampling else (1, 1, 1)


class R3DBasicBlock(nn.Module):
    """conv1 (``block_type``) -> BN -> relu -> conv2 -> BN, + shortcut,
    relu; a stride or width change projects the shortcut (``conv3``,
    ``bn3``)."""

    def __init__(self, input_filters: int, num_filters: int,
                 base_filters: int, down_sampling: bool = False,
                 block_type: str = '3d', with_bn: bool = True):
        super().__init__()
        stride = _block_stride(down_sampling)
        k, p = (3, 3, 3), (1, 1, 1)
        self.conv1 = R3DConv(input_filters, num_filters, k, stride, p,
                             block_type, with_bn)
        self.bn1 = _bn(num_filters, with_bn)
        self.conv2 = R3DConv(num_filters, num_filters, k, (1, 1, 1), p,
                             block_type, with_bn)
        self.bn2 = _bn(num_filters, with_bn)
        self.conv3 = self.bn3 = None
        if down_sampling or num_filters != input_filters:
            self.conv3 = conv3d(input_filters, num_filters, (1, 1, 1),
                                stride=stride, bias=not with_bn)
            self.bn3 = _bn(num_filters, with_bn)

    def _shortcut(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv3 is None:
            return x
        x = self.conv3(x)
        return x if self.bn3 is None else self.bn3(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = _norm_relu(self.bn1, self.conv1(x))
        out = self.conv2(out)
        if self.bn2 is not None:
            out = self.bn2(out)
        return torch.relu(out + self._shortcut(x))


class R3DBottleneck(R3DBasicBlock):
    """conv0 1x1x1 -> BN -> relu -> conv1 (``block_type``, the stride) ->
    BN -> relu -> conv2 1x1x1 -> BN, + shortcut, relu."""

    def __init__(self, input_filters: int, num_filters: int,
                 base_filters: int, down_sampling: bool = False,
                 block_type: str = '3d', with_bn: bool = True):
        nn.Module.__init__(self)
        stride = _block_stride(down_sampling)
        bias = not with_bn
        self.conv0 = conv3d(input_filters, base_filters, (1, 1, 1),
                            bias=bias)
        self.bn0 = _bn(base_filters, with_bn)
        self.conv1 = R3DConv(base_filters, base_filters, (3, 3, 3), stride,
                             (1, 1, 1), block_type, with_bn)
        self.bn1 = _bn(base_filters, with_bn)
        self.conv2 = conv3d(base_filters, num_filters, (1, 1, 1), bias=bias)
        self.bn2 = _bn(num_filters, with_bn)
        self.conv3 = self.bn3 = None
        if down_sampling or num_filters != input_filters:
            self.conv3 = conv3d(input_filters, num_filters, (1, 1, 1),
                                stride=stride, bias=bias)
            self.bn3 = _bn(num_filters, with_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = _norm_relu(self.bn0, self.conv0(x))
        out = _norm_relu(self.bn1, self.conv1(out))
        out = self.conv2(out)
        if self.bn2 is not None:
            out = self.bn2(out)
        return torch.relu(out + self._shortcut(x))


@BACKBONES.register_module
class ResNet_R3D(nn.Module):
    """R3D / R(2+1)D on NCTHW volumes; the module docstring lists the
    options."""

    def __init__(self, pretrained: Optional[str] = None,
                 num_input_channels: int = 3, depth: int = 34,
                 block_type: str = '2.5d', channel_multiplier: float = 1.0,
                 bottleneck_multiplier: float = 1.0,
                 conv1_kernel_t: int = 3, conv1_stride_t: int = 1,
                 use_pool1: bool = False, bn_eval: bool = True,
                 bn_frozen: bool = True, with_bn: bool = True):
        super().__init__()
        if depth not in BLOCK_CONFIG:
            raise KeyError(f'invalid depth {depth} for resnet_r3d')
        self.bn_eval = bn_eval
        self.use_pool1 = use_pool1
        self.stem_2p5d = block_type in ('2.5d', '2.5d-sep')
        bias = not with_bn
        kt, pt = conv1_kernel_t, (conv1_kernel_t - 1) // 2
        if self.stem_2p5d:
            self.conv1_s = conv3d(num_input_channels, 45, (1, 7, 7),
                                  stride=(1, 2, 2), padding=(0, 3, 3),
                                  bias=bias)
            self.bn1_s = _bn(45, with_bn)
            self.conv1_t = conv3d(45, 64, (kt, 1, 1),
                                  stride=(conv1_stride_t, 1, 1),
                                  padding=(pt, 0, 0), bias=bias)
            self.bn1_t = _bn(64, with_bn)
        else:
            self.conv1 = conv3d(num_input_channels, 64, (kt, 7, 7),
                                stride=(conv1_stride_t, 2, 2),
                                padding=(pt, 3, 3), bias=bias)
            self.bn1 = _bn(64, with_bn)
        block_cls = (R3DBasicBlock if depth <= 18 or depth == 34
                     else R3DBottleneck)
        filters = (SHALLOW_FILTER_CONFIG if depth <= 34
                   else DEEP_FILTER_CONFIG)
        filters = np.multiply(filters, channel_multiplier).astype(int)
        in_f = 64
        self.num_stages = len(BLOCK_CONFIG[depth])
        for i, num_blocks in enumerate(BLOCK_CONFIG[depth]):
            num_f = int(filters[i][0])
            base_f = int(filters[i][1] * bottleneck_multiplier)
            stage = nn.Module()
            for j in range(num_blocks):
                stage.add_module(string.ascii_lowercase[j], block_cls(
                    in_f if j == 0 else num_f, num_f, base_f,
                    down_sampling=i > 0 and j == 0, block_type=block_type,
                    with_bn=with_bn))
            self.add_module(f'layer{i + 1}', stage)
            in_f = num_f

    init_weights = init_weights_3d

    def train(self, mode: bool = True):
        super().train(mode)
        if mode and self.bn_eval:
            for m in self.modules():
                if isinstance(m, BatchNorm):
                    m.eval()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, C, T, H, W), any memory format; returns channels_last_3d
        maps."""
        x = x.contiguous(memory_format=torch.channels_last_3d)
        if self.stem_2p5d:
            x = _norm_relu(self.bn1_s, self.conv1_s(x))
            x = _norm_relu(self.bn1_t, self.conv1_t(x))
        else:
            x = _norm_relu(self.bn1, self.conv1(x))
        if self.use_pool1:
            x = max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        for i in range(self.num_stages):
            for block in getattr(self, f'layer{i + 1}').children():
                x = block(x)
        return x
