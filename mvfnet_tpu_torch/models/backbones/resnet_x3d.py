"""X3D backbone (counterpart of ``mvfnet_tpu/models/backbones/resnet_x3d.py``).

The reference's FLOPs-comparison X3D: a thin stem (``conv1``, 24 x
``ratio_width`` channels, then relu with no norm, then the depthwise
temporal ``conv1_3x1``), inverted-bottleneck stages that expand to
``24 * ratio_width * ratio_bottleneck * 2^i`` channels, run a depthwise
3x3x3 (the 'mobile' inflate style), squeeze-and-excitation and hard-swish,
and compress by ``1 / ratio_bottleneck``; then ``conv5`` (1x1x1), the mean
over (T, H, W) and ``fc1`` (1x1x1 to 2048). A (2, 1, 1) max pool follows
stage 1 unless ``no_pool2``. ``depth`` is one of the reference's depth
factors (1, 2.2, 5) or the ResNet-style 50/101 block counts.

Module names are the reference's: ``conv1``, ``conv1_3x1.{0,1}`` (conv,
norm), ``layer{i}.{j}.{conv1,bn1,conv2,bn2,se.{fc1,fc2},conv3,bn3,
downsample.{0,1}}``, ``conv5``, ``fc1``. The reference's unused stem
``bn1`` has no module, as in the JAX package. ``s2d_stages`` (the JAX
package's space-to-depth layout of thin stages at inference, the same
parameters and values) is accepted and computed plainly; ``with_cp``,
``norm_eval``, ``frozen_stages`` and ``norm_frozen`` act as in
``ResNet_I3D``. ``quant='int8'|'int8_static'`` is the eval-only int8 path
of the block convs whose type ``quant_ops`` lists (default the pointwise
ones: conv1, conv3 and the shortcut; the 'mobile' conv2 is depthwise) in
the stages ``quant_stages`` selects, except a stage the JAX package runs
in its space-to-depth layout (``s2d_stages`` where that layout applies to
the stage's input), which stays unquantized here too; training raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn as nn

from ...ops.mvf import hard_swish
from ..builder import BACKBONES
from ..common import (SEModule, check_quant_stages, conv3d, make_norm,
                      max_pool3d, quant_modules, refuse_quant_training)
from .resnet_i3d import (init_weights_3d, norm_eval_train, per_block,
                         quant_for, run_stage)


class X3DBottleneck(nn.Module):
    """conv1 -> norm -> act -> conv2 (depthwise with the 'mobile' style)
    -> norm -> SE -> act -> conv3 -> norm, + shortcut, relu; act is
    hard-swish (relu without ``with_hs``)."""

    def __init__(self, inplanes: int, planes: int, out_channels: int,
                 spatial_stride: int = 1, temporal_stride: int = 1,
                 dilation: int = 1, with_downsample: bool = False,
                 style: str = 'pytorch', if_inflate: bool = True,
                 inflate_style: str = 'mobile',
                 norm_cfg: Optional[Dict] = None, with_se: bool = True,
                 with_hs: bool = True, quant: Optional[str] = None,
                 quant_ops: Sequence[str] = ('pointwise',)):
        super().__init__()
        ss, ts, d = spatial_stride, temporal_stride, dilation
        self.with_hs = with_hs
        if style == 'pytorch':
            c1_s, c2_s, c1_t, c2_t = 1, ss, 1, ts
        else:
            c1_s, c2_s, c1_t, c2_t = ss, 1, ts, 1
        if if_inflate and inflate_style == '3x1x1':
            k1, p1, k2, p2 = (3, 1, 1), (1, 0, 0), (1, 3, 3), (0, d, d)
        elif if_inflate:                           # '3x3x3' / 'mobile'
            k1, p1, k2, p2 = (1, 1, 1), (0, 0, 0), (3, 3, 3), (1, d, d)
        else:
            k1, p1, k2, p2 = (1, 1, 1), (0, 0, 0), (1, 3, 3), (0, d, d)
            c1_t = c2_t = 1
        depthwise = inflate_style == 'mobile' and if_inflate
        self.conv1 = conv3d(inplanes, planes, k1, stride=(c1_t, c1_s, c1_s),
                            padding=p1, quant=quant_for(quant, quant_ops, k1))
        self.bn1 = make_norm(norm_cfg, planes)
        self.conv2 = conv3d(planes, planes, k2, stride=(c2_t, c2_s, c2_s),
                            padding=p2, dilation=(1, d, d),
                            groups=planes if depthwise else 1)
        self.bn2 = make_norm(norm_cfg, planes)
        self.se = SEModule(planes, 16, with_hs) if with_se else None
        pointwise = quant_for(quant, quant_ops, (1, 1, 1))
        self.conv3 = conv3d(planes, out_channels, (1, 1, 1), quant=pointwise)
        self.bn3 = make_norm(norm_cfg, out_channels)
        self.downsample = (nn.Sequential(
            conv3d(inplanes, out_channels, (1, 1, 1), stride=(ts, ss, ss),
                   quant=pointwise),
            make_norm(norm_cfg, out_channels)) if with_downsample else None)

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        return hard_swish(x) if self.with_hs else torch.relu(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self._act(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.se is not None:
            out = self.se(out)
        out = self.bn3(self.conv3(self._act(out)))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


@BACKBONES.register_module
class ResNet_X3D(nn.Module):
    arch_settings = {
        1: (1, 2, 5, 3),
        2.2: (3, 5, 11, 7),
        5: (5, 10, 25, 15),
        50: (3, 4, 6, 3),
        101: (3, 4, 23, 3),
    }

    def __init__(self, depth: Union[int, float], in_channels: int = 3,
                 num_stages: int = 4,
                 spatial_strides: Sequence[int] = (1, 2, 2, 2),
                 temporal_strides: Sequence[int] = (1, 1, 1, 1),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (3,),
                 conv1_kernel: Sequence[int] = (5, 7, 7),
                 ratio_width: float = 1, ratio_up: float = 2,
                 ratio_bottleneck: float = 2.25, ratio_depth: float = 2.2,
                 conv1_stride_t: int = 2, pool1_kernel_t: int = 1,
                 pool1_stride_t: int = 2, style: str = 'pytorch',
                 frozen_stages: int = -1,
                 inflate_freq: Union[int, Sequence] = (1, 1, 1, 1),
                 inflate_style: str = 'mobile',
                 norm_cfg: Optional[Dict] = None, no_pool2: bool = False,
                 norm_eval: bool = True, norm_frozen: bool = False,
                 partial_norm: bool = False,
                 pretrained: Optional[str] = None, pretrained2d: bool = True,
                 with_cp: bool = False, zero_init_residual: bool = True,
                 s2d_stages: Sequence[int] = (), quant: Optional[str] = None,
                 quant_stages: Sequence[int] = (1, 1, 1, 1),
                 quant_ops: Sequence[str] = ('pointwise',)):
        super().__init__()
        if depth not in self.arch_settings:
            raise KeyError(f'invalid depth {depth} for resnet_x3d')
        check_quant_stages(quant, quant_stages, num_stages)
        self.quant = quant
        stage_blocks = self.arch_settings[depth][:num_stages]
        self.num_stages = len(stage_blocks)
        inflate = per_block(inflate_freq, 4)
        # the JAX package's space-to-depth conditions but the input's size
        # (``_s2d_stage``)
        norm_type = (norm_cfg or {}).get('type', 'BN')
        self._s2d = [
            i in s2d_stages and norm_type in ('BN', 'BN3d', 'SyncBN')
            and style == 'pytorch' and inflate_style == 'mobile'
            and all(f == 1 for f in ((inflate[i],) if isinstance(
                inflate[i], int) else inflate[i]))
            and dilations[i] == 1 and temporal_strides[i] == 1
            and spatial_strides[i] in (1, 2)
            for i in range(self.num_stages)]
        self._spatial_strides = tuple(spatial_strides)
        self.out_indices = tuple(out_indices)
        self.no_pool2 = no_pool2
        self.norm_eval = norm_eval
        self.frozen_stages = frozen_stages
        self.with_cp = with_cp
        rw, ru, rb = ratio_width, ratio_up, ratio_bottleneck
        stem = int(24 * rw)
        self.conv1 = conv3d(in_channels, stem, tuple(conv1_kernel),
                            stride=(conv1_stride_t, 2, 2))
        self.conv1_3x1 = nn.Sequential(
            conv3d(stem, stem, (3, 1, 1), groups=stem),
            make_norm(norm_cfg, stem))
        for i, num_blocks in enumerate(stage_blocks):
            inplanes = int(24 * rw * ru ** (i - 1)) if i > 0 else stem
            planes = int(24 * rw * rb * 2 ** i)
            out_ch = int(planes / rb)
            stage_inflate = inflate[i]
            if isinstance(stage_inflate, int):
                stage_inflate = (stage_inflate,) * num_blocks
            blocks = []
            for j in range(num_blocks):
                ss = spatial_strides[i] if j == 0 else 1
                ts = temporal_strides[i] if j == 0 else 1
                blocks.append(X3DBottleneck(
                    inplanes, planes, out_ch, spatial_stride=ss,
                    temporal_stride=ts, dilation=dilations[i],
                    with_downsample=j == 0 and (ss != 1 or ts != 1
                                                or inplanes != out_ch),
                    style=style, if_inflate=stage_inflate[j] == 1,
                    inflate_style=inflate_style, norm_cfg=norm_cfg,
                    quant=quant if quant and quant_stages[i] else None,
                    quant_ops=tuple(quant_ops)))
                inplanes = out_ch
            self.add_module(f'layer{i + 1}', nn.Sequential(*blocks))
            if self._s2d[i]:
                # the JAX package builds such a stage unquantized, without
                # calibration state
                for m in quant_modules(self.get_submodule(f'layer{i + 1}')):
                    m.in_s2d_stage = True
        feat_dim = int(24 * rw * 2 ** (len(stage_blocks) - 1))
        self.conv5 = conv3d(feat_dim, int(feat_dim * rb), (1, 1, 1))
        self.fc1 = conv3d(int(feat_dim * rb), 2048, (1, 1, 1))

    init_weights = init_weights_3d

    def train(self, mode: bool = True):
        super().train(mode)
        norm_eval_train(self, mode)
        return self

    def _s2d_stage(self, i: int, x: torch.Tensor) -> bool:
        """Whether the JAX package runs stage ``i`` on input ``x`` in its
        space-to-depth layout (eval only, an input side divisible by twice
        the stage's stride): such a stage is not quantized there. Its int8
        convs keep no calibration state, so ``int8_static`` refuses an
        input that would quantize them."""
        if not self._s2d[i]:
            return False
        side = 2 * self._spatial_strides[i]
        if x.shape[3] % side == 0 and x.shape[4] % side == 0:
            return not self.training
        if self.quant == 'int8_static':
            raise ValueError(
                f"quant='int8_static': stage {i} is in s2d_stages and keeps "
                f'no activation scales, but a {x.shape[3]}x{x.shape[4]} '
                f'input would quantize it (its space-to-depth form needs '
                f'sides divisible by {side}); drop it from s2d_stages')
        return False

    def forward(self, x: torch.Tensor):
        """x: (N, C, T, H, W), any memory format; returns the (N, 2048, 1,
        1, 1) features, after the maps of the other ``out_indices``."""
        refuse_quant_training(self.quant, self.training)
        x = torch.relu(self.conv1(
            x.contiguous(memory_format=torch.channels_last_3d)))
        x = torch.relu(self.conv1_3x1(x))
        remat = self.with_cp and self.training and torch.is_grad_enabled()
        outs = []
        for i in range(self.num_stages):
            stage = getattr(self, f'layer{i + 1}')
            bypass = (quant_modules(stage) if self.quant
                      and self._s2d_stage(i, x) else [])
            for m in bypass:
                m.bypass = True
            try:
                x = run_stage(stage, stage, x, remat=remat)
            finally:
                for m in bypass:
                    m.bypass = False
            if i in self.out_indices and i != self.num_stages - 1:
                outs.append(x)
            if not self.no_pool2 and i == 0:
                x = max_pool3d(x, (2, 1, 1), (2, 1, 1), (0, 0, 0))
        x = self.conv5(x).mean(dim=(2, 3, 4), keepdim=True)
        x = self.fc1(x)
        return tuple(outs) + (x,) if outs else x
