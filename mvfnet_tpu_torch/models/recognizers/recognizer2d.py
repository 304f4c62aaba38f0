"""Recognizer2D (counterpart of ``mvfnet_tpu/models/recognizers/recognizer2d.py``).

Train path: ``(B, S, H, W, C)`` folds to ``(B*S, ...)`` through the
backbone in train mode, the head averages the scores over
``S // temporal_pool`` segments and returns its cross-entropy loss for the
flattened labels (the dropout mask from the caller's generator).

Test path: every crop*clip*frame of a ``(B, S, H, W, C)`` channels-last
video goes through the backbone as one batch; with ``fcn_testing`` the
feature maps regroup into ``(clips*crops, T, h, w, C)`` volumes that the
head averages over (T, H, W); clip scores are then averaged per video as
``test_cfg['average_clips']`` says ('prob' = softmax then mean, 'score' =
mean, None = per-clip scores). Params are fp32; the compute dtype is
``dtype`` (the config's ``compute_dtype``), or the params' dtype when None.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
import torch.nn as nn

from ..builder import RECOGNIZERS, build_backbone, build_head
from ..common import to_nhwc


def _prepare_backbone_cfg(backbone: Dict, module_cfg: Optional[Dict],
                          modality: str,
                          nonlocal_cfg: Optional[Dict] = None) -> Dict:
    """Turn the reference's (backbone, module_cfg, modality) surgery inputs
    into one declarative backbone config."""
    backbone = dict(backbone)
    if nonlocal_cfg:
        raise NotImplementedError('non-local blocks are not ported yet')
    if module_cfg:
        module_cfg = dict(module_cfg)
        mtype = module_cfg.pop('type')
        if mtype != 'MVF':
            raise NotImplementedError(f'module type {mtype} is not ported yet')
        freq = module_cfg.pop('mvf_freq', (1, 1, 1, 1))
        for k in ('place', 'temporal_pool', 'two_path'):
            module_cfg.pop(k, None)
        backbone['temporal_cfg'] = dict(type=mtype, **module_cfg)
        backbone['temporal_freq'] = tuple(freq)
    if modality == 'Flow':
        backbone['in_channels'] = 2 * 5
    elif modality == 'RGBDiff':
        backbone['in_channels'] = 3 * 5
    return backbone


def _torch_dtype(dtype: Union[None, str, torch.dtype]) -> Optional[torch.dtype]:
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


@RECOGNIZERS.register_module
class Recognizer2D(nn.Module):

    def __init__(self, backbone: Dict, cls_head: Dict, modality: str = 'RGB',
                 fcn_testing: bool = False,
                 module_cfg: Optional[Dict] = None,
                 nonlocal_cfg: Optional[Dict] = None,
                 train_cfg: Optional[Dict] = None,
                 test_cfg: Optional[Dict] = None,
                 dtype: Union[None, str, torch.dtype] = torch.float32):
        super().__init__()
        self.fcn_testing = fcn_testing
        self.module_cfg = dict(module_cfg) if module_cfg else None
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.dtype = _torch_dtype(dtype)
        self.backbone = build_backbone(_prepare_backbone_cfg(
            backbone, module_cfg, modality, nonlocal_cfg))
        head_cfg = dict(cls_head)
        head_cfg.setdefault('fcn_testing', fcn_testing)
        self.cls_head = build_head(head_cfg)

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.dtype or self.cls_head.new_fc.weight.dtype

    def init_weights(self, generator: torch.Generator,
                     randomize_bn: bool = False) -> None:
        """Random init from ``generator`` (the JAX package's initializers).
        ``randomize_bn`` also draws BN running statistics (mean N(0, 0.05),
        var U(0.8, 1.2)) so that eval-mode BN is not the identity."""
        self.backbone.init_weights(generator)
        self.cls_head.init_weights(generator)
        if randomize_bn:
            with torch.no_grad():
                for m in self.modules():
                    if isinstance(m, nn.BatchNorm2d):
                        m.running_mean.copy_(torch.randn(
                            m.running_mean.shape, generator=generator)
                            * 0.05)
                        m.running_var.copy_(torch.rand(
                            m.running_var.shape, generator=generator)
                            * 0.4 + 0.8)

    def extract_feat(self, imgs: torch.Tensor) -> torch.Tensor:
        """(M, H, W, C) channels-last -> backbone maps, NCHW channels_last."""
        return self.backbone(imgs.to(self.compute_dtype).permute(0, 3, 1, 2))

    def forward(self, imgs: torch.Tensor, labels=None,
                return_loss: bool = True,
                generator: Optional[torch.Generator] = None):
        if return_loss:
            return self.forward_train(imgs, labels, generator)
        return self.forward_test(imgs)

    def forward_train(self, imgs: torch.Tensor, labels: torch.Tensor,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
        # imgs: (B, S, H, W, C)
        num_batch = imgs.shape[0]
        imgs = imgs.reshape((-1,) + tuple(imgs.shape[2:]))
        num_seg = imgs.shape[0] // num_batch
        x = to_nhwc(self.extract_feat(imgs))           # (B*S, h, w, C)
        temporal_pool = imgs.shape[0] // x.shape[0]
        cls_score = self.cls_head(x, num_seg // temporal_pool,
                                  generator=generator)
        return self.cls_head.loss(cls_score, labels.reshape(-1))

    def forward_test(self, imgs: torch.Tensor) -> torch.Tensor:
        # imgs: (B, crops*clips*T, H, W, C), B is typically 1
        num_batch = imgs.shape[0]
        imgs = imgs.reshape((-1,) + tuple(imgs.shape[2:]))
        num_frames = imgs.shape[0] // num_batch
        x = to_nhwc(self.extract_feat(imgs))           # (M, h, w, C)
        temporal_pool = imgs.shape[0] // x.shape[0]
        if self.module_cfg:
            n_seg = self.module_cfg['n_segment'] // temporal_pool
            if self.fcn_testing:
                x = x.reshape((-1, n_seg) + tuple(x.shape[1:]))
            cls_score = self.cls_head(x, n_seg)
        else:
            cls_score = self.cls_head(x, num_frames // temporal_pool)
        return self.average_clip(cls_score, num_batch)

    def average_clip(self, cls_score: torch.Tensor,
                     num_batch: int = 1) -> torch.Tensor:
        """Per-video clip averaging; softmax in at least f32 (promoted,
        never demoted)."""
        test_cfg = self.test_cfg or {'average_clips': None}
        if 'average_clips' not in test_cfg:
            raise KeyError('"average_clips" must be defined in test_cfg')
        mode = test_cfg['average_clips']
        if mode not in ['score', 'prob', None]:
            raise ValueError(f'{mode} is not supported')
        if mode is None:
            return cls_score
        grouped = cls_score.reshape((num_batch, -1)
                                    + tuple(cls_score.shape[1:]))
        if mode == 'prob':
            acc = torch.promote_types(grouped.dtype, torch.float32)
            return torch.softmax(grouped.to(acc), dim=-1).mean(dim=1)
        return grouped.mean(dim=1)
