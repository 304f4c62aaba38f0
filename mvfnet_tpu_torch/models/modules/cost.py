"""CoST module (counterpart of ``mvfnet_tpu/models/modules/cost.py``).

One shared 3x3 kernel convolves the clip volume over three axis pairs,
(H, W), (T, W) and (T, H); the three maps are summed, then BatchNorm and
relu. In the ResNet it replaces ``conv2`` of every non-first bottleneck of
the stages ``shift_freq`` selects, so its names are the reference's
``layer{i}.{j}.conv2.{shift_conv,bn}``: ``shift_conv`` keeps the
reference's ``Conv3d`` weight shape ``(C, C, 1, 3, 3)`` and runs as a 2-D
kernel.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..common import make_norm


class CoST(nn.Module):
    """Input and output: ``(N*T, C, H, W)`` (channels_last)."""

    def __init__(self, n_segment: int, in_channels: int):
        super().__init__()
        self.n_segment = n_segment
        c = in_channels
        self.shift_conv = nn.Conv3d(c, c, (1, 3, 3), bias=False)
        self.bn = make_norm(None, c)
        self.reset_taps()

    def reset_taps(self, generator: torch.Generator = None) -> None:
        """The kernel ~ N(0, sqrt(2 / (9 C))), BN gamma 1 beta 0."""
        w = self.shift_conv.weight
        with torch.no_grad():
            w.copy_(torch.randn(w.shape, generator=generator)
                    * (2.0 / (9 * w.shape[1])) ** 0.5)
        self.bn.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nt, c, h, w = x.shape
        t = self.n_segment
        n = nt // t
        k = self.shift_conv.weight[:, :, 0].to(x.dtype)    # (O, I, 3, 3)

        def conv(v):
            return F.conv2d(v.contiguous(memory_format=torch.channels_last),
                            k, padding=1)

        x5 = x.reshape(n, t, c, h, w)
        y = conv(x)
        # (T, W): H folds into the batch
        v = x5.permute(0, 3, 2, 1, 4).reshape(n * h, c, t, w)
        y = y + conv(v).reshape(n, h, c, t, w).permute(0, 3, 2, 1, 4) \
            .reshape(nt, c, h, w)
        # (T, H): W folds into the batch
        v = x5.permute(0, 4, 2, 1, 3).reshape(n * w, c, t, h)
        y = y + conv(v).reshape(n, w, c, t, h).permute(0, 3, 2, 4, 1) \
            .reshape(nt, c, h, w)
        return torch.relu(self.bn(y))
