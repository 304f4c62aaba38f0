"""Temporal Shift Module (counterpart of ``mvfnet_tpu/models/modules/tsm.py``).

Over a folded-time batch ``(N*T, ...)``: the first ``C // n_div`` channels
take the next frame's values (a backward shift), the next ``C // n_div``
the previous frame's (a forward shift), the rest stay; zeros enter at the
clip's ends. Parameter-free.

``temporal_shift`` is the JAX module's shift. ``ShiftConv2d`` is a conv
that shifts its input first: MobileNetV2 puts it where the reference's
surgery wraps the expanding conv, and its weight keeps the conv's name, as
the JAX package's tree keeps ``pw_conv`` (the reference never shipped the
wrapping module).
"""

from __future__ import annotations

import torch

from ..common import Conv2d, to_nchw, to_nhwc


def temporal_shift(x: torch.Tensor, n_segment: int, n_div: int = 8
                   ) -> torch.Tensor:
    """(N*T, H, W, C) channels-last -> the shifted tensor, same shape."""
    nt, h, w, c = x.shape
    fold = c // n_div
    x5 = x.reshape(nt // n_segment, n_segment, h, w, c)
    out = torch.zeros_like(x5)
    out[:, :-1, ..., :fold] = x5[:, 1:, ..., :fold]                # back
    out[:, 1:, ..., fold:2 * fold] = x5[:, :-1, ..., fold:2 * fold]  # fwd
    out[..., 2 * fold:] = x5[..., 2 * fold:]
    return out.reshape(nt, h, w, c)


class ShiftConv2d(Conv2d):
    """``Conv2d`` of the temporally shifted input (``(N*T, C, H, W)``)."""

    def __init__(self, *args, n_segment: int, n_div: int = 8, **kwargs):
        super().__init__(*args, **kwargs)
        self.n_segment = n_segment
        self.n_div = n_div

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = to_nchw(temporal_shift(to_nhwc(x), self.n_segment, self.n_div))
        return super().forward(y.contiguous(
            memory_format=torch.channels_last))
