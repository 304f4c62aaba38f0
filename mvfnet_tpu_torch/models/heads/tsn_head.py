"""TSN classification head (counterpart of ``mvfnet_tpu/models/heads/tsn_head.py``).

Inputs are channels-last, as in the JAX package:

- standard path: ``(M, H, W, C)`` per-frame features, M = B*num_seg
- fcn path: ``(M', T, H, W, C)`` clip volumes, averaged over (T, H, W)
  before the FC (a 1x1x1 conv is linear per position, so the mean of the
  class map equals the FC of the mean)

The FC is ``new_fc``, the reference's name. Dropout acts only in train mode
on the standard path, with the mask drawn from the caller's generator
(``flax.linen.Dropout`` semantics: keep with probability 1-p, scale the kept
by 1/(1-p)). The loss is cross-entropy in at least f32. Only the average is
ported (``spatial_type='avg'``, avg consensus).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..builder import HEADS
from .consensus import SimpleConsensus


@HEADS.register_module
class TSNClsHead(nn.Module):

    def __init__(self, spatial_type: str = 'avg', spatial_size: int = 7,
                 consensus_cfg: Optional[Dict] = None,
                 with_avg_pool: bool = False, temporal_feature_size: int = 1,
                 spatial_feature_size: int = 1, dropout_ratio: float = 0.8,
                 in_channels: int = 1024, num_classes: int = 101,
                 init_std: float = 0.001, fcn_testing: bool = False):
        super().__init__()
        ctype = (consensus_cfg or {'type': 'avg'})['type']
        if ctype != 'avg':
            raise NotImplementedError(f'consensus {ctype!r} is not ported yet')
        if spatial_type != 'avg':
            raise NotImplementedError(
                f'spatial_type {spatial_type!r} is not ported yet')
        self.dropout_ratio = dropout_ratio
        self.init_std = init_std
        self.new_fc = nn.Linear(in_channels, num_classes)
        self.consensus = SimpleConsensus('avg', dim=1)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.new_fc.weight.copy_(torch.randn(
                self.new_fc.weight.shape, generator=generator)
                * self.init_std)
            self.new_fc.bias.zero_()

    def fc(self, feat: torch.Tensor) -> torch.Tensor:
        """The FC in the features' dtype (fp32 params cast)."""
        return F.linear(feat, self.new_fc.weight.to(feat.dtype),
                        self.new_fc.bias.to(feat.dtype))

    def dropout(self, feat: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """Zero each value with probability p, scale the rest by 1/(1-p);
        the mask comes from ``generator`` (the device's default generator
        when None). The identity in eval or with p = 0."""
        p = self.dropout_ratio
        if not (self.training and p):
            return feat
        keep = torch.rand(feat.shape, generator=generator,
                          device=feat.device) >= p
        return torch.where(keep, feat / (1 - p), torch.zeros_like(feat))

    def forward(self, x: torch.Tensor, num_seg: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x.ndim == 5:
            return self.fc(x.mean(dim=(1, 2, 3)))
        feat = self.dropout(x.mean(dim=(1, 2)), generator)
        score = self.fc(feat)
        score = score.reshape((-1, num_seg) + score.shape[1:])
        return self.consensus(score)[:, 0]

    @staticmethod
    def loss(cls_score: torch.Tensor,
             labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Mean cross-entropy in ``promote_types(float32, dtype)``: bf16
        logits promote, f64 stays f64."""
        acc = torch.promote_types(torch.float32, cls_score.dtype)
        return {'loss_cls': F.cross_entropy(cls_score.to(acc), labels)}
