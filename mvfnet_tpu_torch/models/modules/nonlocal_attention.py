"""Local self-attention, the non-local block (counterpart of
``mvfnet_tpu/models/modules/nonlocal_attention.py``).

For every spatial site, attention runs over the T x K x K neighbourhood
tube: query, key and value come from one 1x1x1 conv (``conv_in``), the
affinity over the T*K*K positions is a mean dot product or a softmax, the
result is folded back by overlap-add, projected (``conv_out``), normalized
(``bn``) and added to the input. Unfold and fold are K*K zero-padded
spatial shifts, as in the JAX module. ``conv_in`` and ``conv_out`` keep
the reference's ``Conv3d`` weights ``(out, in, 1, 1, 1)`` and run as
matrix products on channels-last volumes.

``NonLocal2D`` puts a block after a 2-D ResNet block, the reference's
``NL3DWrapper``: the wrapped block is ``block``, the attention ``nl``, and
the folded-time batch unfolds into clips of ``n_segment`` frames around
it. ``nonlocal_block_indices`` picks the blocks of a stage that get one.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..common import lecun_normal_, make_norm, to_nchw, to_nhwc


def _shift2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., i, j, :] = x[..., i+dy, j+dx, :], zeros outside; H and W are
    dims -3 and -2."""
    h, w = x.shape[-3], x.shape[-2]
    y = F.pad(x, (0, 0, max(-dx, 0), max(dx, 0), max(-dy, 0), max(dy, 0)))
    return y[..., max(dy, 0):max(dy, 0) + h, max(dx, 0):max(dx, 0) + w, :]


class LocalAttention(nn.Module):
    """``dim`` -> ``hidden`` query/key/value attention with a residual, on
    ``(N, T, H, W, C)`` channels-last volumes. Options as in the JAX
    module: ``instantiation`` 'dot_product' (the affinity over T*K*K) or
    'softmax' (scaled by hidden^-0.5), ``use_time_shift`` (the first half
    of each of query, key and value moved one frame later, zeros first),
    ``time_weighting_size`` (a parameter of that shape, ones at init,
    multiplying the ``(N, T*K*K, T*K*K, H*W)`` affinity)."""

    def __init__(self, dim: int, hidden: int, kernel_size: int = 3,
                 padding: int = 1, instantiation: str = 'dot_product',
                 use_time_shift: bool = False,
                 time_weighting_size: Optional[Sequence[int]] = None):
        super().__init__()
        if instantiation not in ('dot_product', 'softmax'):
            raise NotImplementedError(instantiation)
        self.dim, self.hidden = dim, hidden
        self.kernel_size, self.padding = kernel_size, padding
        self.instantiation = instantiation
        self.use_time_shift = use_time_shift
        self.conv_in = nn.Conv3d(dim, 3 * hidden, 1, bias=True)
        self.conv_out = nn.Conv3d(hidden, dim, 1, bias=True)
        self.bn = make_norm(None, dim)
        self.time_weighting = (
            nn.Parameter(torch.ones(tuple(time_weighting_size)))
            if time_weighting_size is not None else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's init: lecun-normal convs, zero biases, BN gamma
        1 beta 0, the time weighting ones."""
        for conv in (self.conv_in, self.conv_out):
            lecun_normal_(conv.weight, generator)
            nn.init.zeros_(conv.bias)
        self.bn.reset_parameters()
        if self.time_weighting is not None:
            nn.init.ones_(self.time_weighting)

    @staticmethod
    def _linear(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, conv.weight.flatten(1).to(x.dtype),
                        conv.bias.to(x.dtype))

    def _offsets(self):
        r = range(-self.padding, self.kernel_size - self.padding)
        return [(dy, dx) for dy in r for dx in r]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, h, w, c = x.shape
        if c != self.dim:
            raise ValueError(f'LocalAttention built for {self.dim} channels, '
                             f'got {c}')
        k2 = self.kernel_size ** 2
        hid = self.hidden
        theta, phi, g = self._linear(self.conv_in, x).split(hid, dim=-1)

        def unfold(v):
            # (N, T, H, W, hid) -> (N, T*K2, H*W, hid)
            if self.use_time_shift:
                half = hid // 2
                shifted = F.pad(v[..., :half],
                                (0, 0, 0, 0, 0, 0, 1, 0))[:, :t]
                v = torch.cat([shifted, v[..., half:]], dim=-1)
            u = torch.stack([_shift2d(v, dy, dx)
                             for dy, dx in self._offsets()], dim=2)
            return u.reshape(n, t * k2, h * w, hid)

        attn = torch.einsum('npsc,nqsc->npqs', unfold(theta), unfold(phi))
        if self.instantiation == 'softmax':
            attn = torch.softmax(attn * hid ** -0.5, dim=2)
        else:
            attn = attn / (t * k2)
        if self.time_weighting is not None:
            attn = attn * self.time_weighting.to(attn.dtype)
        out_u = torch.einsum('npqs,nqsc->npsc', attn, unfold(g)).reshape(
            n, t, k2, h, w, hid)
        out = torch.zeros_like(out_u[:, :, 0])
        for i, (dy, dx) in enumerate(self._offsets()):   # overlap-add
            out = out + _shift2d(out_u[:, :, i], -dy, -dx)
        out = self._linear(self.conv_out, out)
        out = self.bn(out.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        return x + out


def build_nonlocal_block(cfg: Dict) -> LocalAttention:
    """The reference's ``build_nonlocal_block``: ``in_channels`` and
    ``embed_dim`` (half the channels by default) are read, the other keys
    ignored, as in the JAX package."""
    dim = cfg['in_channels']
    return LocalAttention(dim=dim, hidden=cfg.get('embed_dim') or dim // 2)


def nonlocal_block_indices(num_blocks: int, num_nl: int) -> Tuple[int, ...]:
    """The blocks of a stage that get a non-local block: the reference's
    float-modulo rule ``i % (len/num) == len/num - 1``, odd indices when
    len/num is whole and none when it is not (R101's layer3, 23/3)."""
    stride = num_blocks / num_nl
    return tuple(i for i in range(num_blocks) if i % stride == stride - 1)


class NonLocal2D(nn.Module):
    """A 2-D block, then attention over its output's clips of
    ``n_segment`` frames: ``(N*T, C, H, W)`` channels_last in and out."""

    def __init__(self, block: nn.Module, channels: int, n_segment: int):
        super().__init__()
        self.block = block
        self.nl = LocalAttention(dim=channels, hidden=channels // 2)
        self.n_segment = n_segment

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = to_nhwc(self.block(x))
        nt, h, w, c = y.shape
        y = self.nl(y.reshape(nt // self.n_segment, self.n_segment, h, w, c))
        return to_nchw(y.reshape(nt, h, w, c)).contiguous(
            memory_format=torch.channels_last)
