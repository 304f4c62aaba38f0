"""MVF module (counterpart of ``mvfnet_tpu/models/modules/mvf.py``).

As in the reference ``MVF.py``, the module wraps a block's ``conv1``: it
holds the wrapped 1x1 conv as ``net`` beside the three depthwise taps
(``shift_conv``, ``h_conv``, ``w_conv``, shaped like the reference's
Conv3d weights) and ``bn``, so the state-dict names are the reference's.

- channel split ``[int(alpha*C) | rest]``; the untouched channels are
  concatenated back before ``net``
- three depthwise 3-taps over T / H / W, summed; ``share=True`` applies the
  T taps to every active view, and ``mode`` picks T, TH or THW
- BN + hardswish only when ``use_hs`` (without it, neither)
- train-mode BN normalizes with the biased batch variance and stores the
  unbiased one; eval folds the running statistics into one affine
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ...ops.mvf import hard_swish, mvf_conv_sum
from ...utils import tracing
from ..common import BN_EPS, make_norm, to_nchw, to_nhwc

_TAP_SHAPES = {'shift_conv': (3, 1, 1), 'h_conv': (1, 3, 1),
               'w_conv': (1, 1, 3)}


class MVF(nn.Module):
    """Multi-View Fusion over a folded-time batch, then the wrapped conv.

    ``forward`` takes and returns the block's NCHW (channels_last) tensors;
    :meth:`mvf` is the fusion alone on ``(N*T, H, W, C)`` channels-last
    tensors, the JAX ``MVF`` module's layout.
    """

    def __init__(self, net: nn.Module, n_segment: int, in_channels: int,
                 alpha: float = 0.5, use_hs: bool = True, share: bool = False,
                 mode: str = 'THW'):
        super().__init__()
        if mode not in ('T', 'TH', 'THW'):
            raise ValueError(f'MVF mode {mode!r}')
        self.net = net
        self.n_segment = n_segment
        self.in_channels = in_channels
        self.use_hs = use_hs
        self.share = share
        self.mode = mode
        self.num_shift_channel = cs = int(in_channels * alpha)
        views = {'T': ['shift_conv'], 'TH': ['shift_conv', 'h_conv'],
                 'THW': ['shift_conv', 'h_conv', 'w_conv']}[mode]
        if share:
            views = ['shift_conv']
        for name in views if cs else ():
            # weight holders in the reference's Conv3d shape; the taps run
            # channels-last through ops.mvf, not through Conv3d.forward
            setattr(self, name, nn.Conv3d(cs, cs, _TAP_SHAPES[name],
                                          groups=cs, bias=False))
        self.bn = make_norm(None, cs) if (cs and use_hs) else None
        self.reset_taps()

    def reset_taps(self, generator: torch.Generator = None) -> None:
        """Taps ~ N(0, sqrt(2 / (3*cs))), BN gamma 1 beta 0."""
        cs = self.num_shift_channel
        with torch.no_grad():
            for name in _TAP_SHAPES:
                if hasattr(self, name):
                    w = getattr(self, name).weight
                    w.copy_(torch.randn(w.shape, generator=generator)
                            * (2.0 / (3 * cs)) ** 0.5)
        if self.bn is not None:
            self.bn.reset_parameters()

    def _taps(self):
        """(3, cs) tap weights per view (``None`` for an inactive view)."""
        cs = self.num_shift_channel

        def taps(name):
            return getattr(self, name).weight.reshape(cs, 3).t()

        w_t = taps('shift_conv')
        w_h = w_w = None
        if self.mode in ('TH', 'THW'):
            w_h = w_t if self.share else taps('h_conv')
        if self.mode == 'THW':
            w_w = w_t if self.share else taps('w_conv')
        return w_t, w_h, w_w

    def mvf(self, x: torch.Tensor) -> torch.Tensor:
        """(N*T, H, W, C) -> (N*T, H, W, C), channels-last."""
        cs = self.num_shift_channel
        if cs == 0:
            return x
        nt, h, w, c = x.shape
        if c != self.in_channels:
            raise ValueError(f'MVF built for {self.in_channels} channels, '
                             f'got {c}')
        x5 = x.reshape(nt // self.n_segment, self.n_segment, h, w, c)
        xs, xu = x5[..., :cs], x5[..., cs:]
        y = mvf_conv_sum(xs, *self._taps(), mode=self.mode)
        if self.use_hs:
            bn = self.bn
            if bn.training:
                # statistics in at least f32; f64 stays f64
                stat = torch.promote_types(y.dtype, torch.float32)
                yf = bn.normalize(y.reshape(-1, cs).to(stat))
                y = hard_swish(yf).to(x.dtype).reshape(y.shape)
            else:
                scale = bn.weight / torch.sqrt(bn.running_var + BN_EPS)
                bias = bn.bias - bn.running_mean * scale
                y = hard_swish(y * scale.to(y.dtype) + bias.to(y.dtype))
        out = torch.cat([y.to(x.dtype), xu], dim=-1)
        return out.reshape(nt, h, w, c)

    def fuse(self, x: torch.Tensor) -> torch.Tensor:
        """The fusion on the block's NCHW (channels_last) tensor: the
        wrapped conv's input. The 2-D ResNet calls it alone where it folds
        the block's BatchNorm into ``net``."""
        # the fusion and its layout copies; the wrapped conv runs outside
        with tracing.span('model.mvf'):
            return to_nchw(self.mvf(to_nhwc(x))).contiguous(
                memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(self.fuse(x))
