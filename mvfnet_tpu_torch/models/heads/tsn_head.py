"""TSN classification head (counterpart of ``mvfnet_tpu/models/heads/tsn_head.py``).

Inputs are channels-last, as in the JAX package:

- standard path: ``(M, H, W, C)`` per-frame features, M = B*num_seg
- fcn path: ``(M', T, H, W, C)`` clip volumes, averaged over (T, H, W)
  before the FC (a 1x1x1 conv is linear per position, so the mean of the
  class map equals the FC of the mean)

With ``extract_feat`` the head returns the pooled features, ``(M', C)`` or
``(M, C)``, and skips the FC. The FC is ``new_fc``, the reference's name.
Dropout acts only in train mode on the standard path, with the mask drawn
from the caller's generator (``flax.linen.Dropout`` semantics: keep with
probability 1-p, scale the kept by 1/(1-p)). The loss is cross-entropy in
at least f32. ``spatial_type`` pools the standard path's frames by 'avg'
or 'max'. The consensus is the average, or a TRN (``consensus_cfg`` type
'TRN' or 'TRNmultiscale' with its ``num_frames``): ``new_fc`` then
projects to 256 and the relation module, ``segmental_consensus``, scores
the segments' embeddings (on the fcn path the head returns the 256-wide
projection, as the JAX head does). The multiscale module takes the
deterministic pick of subsets here, as the JAX train step does.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..builder import HEADS
from .consensus import SimpleConsensus, return_trn

_TRN = ('TRN', 'TRNmultiscale')
_TRN_DIM = 256


@HEADS.register_module
class TSNClsHead(nn.Module):

    def __init__(self, spatial_type: str = 'avg', spatial_size: int = 7,
                 consensus_cfg: Optional[Dict] = None,
                 with_avg_pool: bool = False, temporal_feature_size: int = 1,
                 spatial_feature_size: int = 1, dropout_ratio: float = 0.8,
                 in_channels: int = 1024, num_classes: int = 101,
                 init_std: float = 0.001, fcn_testing: bool = False,
                 extract_feat: bool = False):
        super().__init__()
        cfg = dict(consensus_cfg or {'type': 'avg'})
        self.consensus_type = cfg['type']
        if spatial_type not in ('avg', 'max'):
            raise ValueError(spatial_type)
        self.spatial_type = spatial_type
        self.dropout_ratio = dropout_ratio
        self.init_std = init_std
        self.extract_feat = extract_feat
        self.num_classes = num_classes
        self.num_frames = cfg.get('num_frames')
        trn = self.consensus_type in _TRN
        self.new_fc = nn.Linear(in_channels, _TRN_DIM if trn else num_classes)
        if trn:
            if not self.num_frames:
                raise ValueError(
                    f'consensus {self.consensus_type} needs num_frames in '
                    'consensus_cfg: the port sizes its relation MLPs when it '
                    'builds the head (the JAX head sizes them from its first '
                    "call's segments)")
            self.segmental_consensus = return_trn(
                self.consensus_type, _TRN_DIM, self.num_frames, num_classes)
        elif self.consensus_type == 'avg':
            self.segmental_consensus = SimpleConsensus('avg', dim=1)
        else:
            raise NotImplementedError(self.consensus_type)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.new_fc.weight.copy_(torch.randn(
                self.new_fc.weight.shape, generator=generator)
                * self.init_std)
            self.new_fc.bias.zero_()
        if self.consensus_type in _TRN:
            self.segmental_consensus.reset_parameters(generator)

    def fc(self, feat: torch.Tensor) -> torch.Tensor:
        """The FC in the features' dtype (fp32 params cast)."""
        return F.linear(feat, self.new_fc.weight.to(feat.dtype),
                        self.new_fc.bias.to(feat.dtype))

    # (world, rank): this process holds rows rank*M..(rank+1)*M of a
    # world*M-row batch and keeps those rows of its mask
    # (``engine.train_step.make_train_step`` sets it)
    dropout_shard = (1, 0)

    def dropout(self, feat: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """Zero each value with probability p, scale the rest by 1/(1-p);
        the mask comes from ``generator`` (the device's default generator
        when None), drawn for the whole batch of ``dropout_shard``. The
        identity in eval or with p = 0."""
        p = self.dropout_ratio
        if not (self.training and p):
            return feat
        world, rank = self.dropout_shard
        m = feat.shape[0]
        keep = torch.rand((world * m,) + tuple(feat.shape[1:]),
                          generator=generator,
                          device=feat.device)[rank * m:(rank + 1) * m] >= p
        return torch.where(keep, feat / (1 - p), torch.zeros_like(feat))

    def forward(self, x: torch.Tensor, num_seg: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x.ndim == 5:
            feat = x.mean(dim=(1, 2, 3))
            return feat if self.extract_feat else self.fc(feat)
        pooled = (x.mean(dim=(1, 2)) if self.spatial_type == 'avg'
                  else x.amax(dim=(1, 2)))
        feat = self.dropout(pooled, generator)
        if self.extract_feat:
            return feat
        score = self.fc(feat)
        score = score.reshape((-1, num_seg) + score.shape[1:])
        return self.segmental_consensus(score)[:, 0]

    @staticmethod
    def loss(cls_score: torch.Tensor,
             labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Mean cross-entropy in ``promote_types(float32, dtype)``: bf16
        logits promote, f64 stays f64."""
        acc = torch.promote_types(torch.float32, cls_score.dtype)
        return {'loss_cls': F.cross_entropy(cls_score.to(acc), labels)}
