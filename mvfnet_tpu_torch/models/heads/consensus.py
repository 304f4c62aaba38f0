"""Segmental consensus (counterpart of ``mvfnet_tpu/models/heads/consensus.py``).

Only the average is ported; TRN waits for a later slice.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..builder import SEGMENTAL_CONSENSUSES


@SEGMENTAL_CONSENSUSES.register_module
class SimpleConsensus(nn.Module):
    """Mean over ``dim`` (the segment axis), keeping the axis."""

    def __init__(self, consensus_type: str = 'avg', dim: int = 1):
        super().__init__()
        if consensus_type != 'avg':
            raise NotImplementedError(f'consensus {consensus_type!r}')
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=self.dim, keepdim=True)
