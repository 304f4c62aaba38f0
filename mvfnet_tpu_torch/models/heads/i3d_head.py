"""I3D classification heads (counterpart of ``mvfnet_tpu/models/heads/i3d_head.py``).

Inputs are the 3-D backbones' NCTHW maps. ``I3DClsHead`` pools one map over
(T, H, W), by its mean or with ``spatial_type='max'`` (and without
``fcn_testing``) its maximum; ``I3DSlowFastClsHead`` concatenates the means
of the slow and the fast map. Dropout acts in train mode without
``fcn_testing``, with the mask drawn from the caller's generator as
``TSNClsHead`` draws it (``dropout_shard`` included). With ``extract_feat``
the head returns the pooled features and skips the FC. The FC is
``fc_cls``, the reference's name; the loss is ``TSNClsHead``'s
cross-entropy in at least f32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..builder import HEADS
from .tsn_head import TSNClsHead


class _PooledFCHead(nn.Module):
    """Dropout, then ``fc_cls`` (fp32 params cast to the features' dtype),
    over the features ``pool`` gives."""

    def __init__(self, dropout_ratio: float, in_channels: int,
                 num_classes: int, init_std: float, fcn_testing: bool,
                 extract_feat: bool):
        super().__init__()
        self.dropout_ratio = dropout_ratio
        self.init_std = init_std
        self.fcn_testing = fcn_testing
        self.extract_feat = extract_feat
        self.fc_cls = nn.Linear(in_channels, num_classes)

    dropout_shard = TSNClsHead.dropout_shard
    dropout = TSNClsHead.dropout
    loss = staticmethod(TSNClsHead.loss)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.fc_cls.weight.copy_(torch.randn(
                self.fc_cls.weight.shape, generator=generator)
                * self.init_std)
            self.fc_cls.bias.zero_()

    def fc(self, feat: torch.Tensor) -> torch.Tensor:
        return F.linear(feat, self.fc_cls.weight.to(feat.dtype),
                        self.fc_cls.bias.to(feat.dtype))

    def pool(self, x) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x, num_seg: int = 1,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feat = self.pool(x)
        if not self.fcn_testing:
            feat = self.dropout(feat, generator)
        return feat if self.extract_feat else self.fc(feat)


@HEADS.register_module
class I3DClsHead(_PooledFCHead):

    def __init__(self, spatial_type: str = 'avg', spatial_size: int = 7,
                 temporal_size: int = 4, consensus_cfg: Optional[Dict] = None,
                 dropout_ratio: float = 0.5, in_channels: int = 2048,
                 num_classes: int = 400, init_std: float = 0.01,
                 fcn_testing: bool = False, extract_feat: bool = False):
        super().__init__(dropout_ratio, in_channels, num_classes, init_std,
                         fcn_testing, extract_feat)
        if spatial_type not in ('avg', 'max'):
            raise ValueError(spatial_type)
        self.spatial_type = spatial_type

    def pool(self, x: torch.Tensor) -> torch.Tensor:
        if self.spatial_type == 'avg' or self.fcn_testing:
            return x.mean(dim=(2, 3, 4))
        return x.amax(dim=(2, 3, 4))


@HEADS.register_module
class I3DSlowFastClsHead(_PooledFCHead):

    def __init__(self, spatial_type: str = 'avg', spatial_size: int = 7,
                 temporal_size: int = 4, dropout_ratio: float = 0.5,
                 in_channels: int = 2048 + 256, num_classes: int = 400,
                 init_std: float = 0.01, fcn_testing: bool = False,
                 extract_feat: bool = False):
        super().__init__(dropout_ratio, in_channels, num_classes, init_std,
                         fcn_testing, extract_feat)

    def pool(self, x: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        slow, fast = x
        return torch.cat([slow.mean(dim=(2, 3, 4)),
                          fast.mean(dim=(2, 3, 4))], dim=-1)
