"""Recognizer3D (counterpart of ``mvfnet_tpu/models/recognizers/recognizer3d.py``).

Input is ``(B, clips, T, H, W, C)``, the data pipeline's
``FormatShape('NTHWC')`` batched; the clips fold into the batch and enter
the 3-D backbone as an NCTHW view in ``torch.channels_last_3d``. The train
path returns the head's cross-entropy for the flattened labels (the
dropout mask from the caller's generator). The test path scores every clip
and averages them per video as ``test_cfg['average_clips']`` says; with
``test_cfg['view_chunk']`` the folded clips go through the backbone that
many at a time (the same scores), unless the count does not divide them,
which logs a warning and runs them at once. ``forward_extract_feat``
returns each clip's backbone features averaged over (T, H, W), a SlowFast
pathway pair concatenated. ``RecognizerC2D`` is the same recognizer with
a ``modality`` field. Params are fp32; the compute dtype is ``dtype``
(the config's ``compute_dtype``), or the params' dtype when None.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Union

import torch
import torch.nn as nn

from ..builder import RECOGNIZERS, build_backbone, build_head
from ..common import to_ncthw
from .recognizer2d import Recognizer2D, _torch_dtype

logger = logging.getLogger(__name__)


def pooled_features(x) -> torch.Tensor:
    """(N, C) means over (T, H, W) of a backbone output; a tuple of maps
    gives its means side by side."""
    if isinstance(x, tuple):
        return torch.cat([v.mean(dim=(2, 3, 4)) for v in x], dim=-1)
    return x.mean(dim=(2, 3, 4))


@RECOGNIZERS.register_module
class Recognizer3D(nn.Module):

    def __init__(self, backbone: Dict, cls_head: Dict,
                 fcn_testing: bool = False,
                 train_cfg: Optional[Dict] = None,
                 test_cfg: Optional[Dict] = None,
                 dtype: Union[None, str, torch.dtype] = torch.float32):
        super().__init__()
        self.fcn_testing = fcn_testing
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.dtype = _torch_dtype(dtype)
        self.backbone = build_backbone(dict(backbone))
        head_cfg = dict(cls_head)
        head_cfg.setdefault('fcn_testing', fcn_testing)
        self.cls_head = build_head(head_cfg)

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.dtype or self.cls_head.fc_cls.weight.dtype

    init_weights = Recognizer2D.init_weights
    average_clip = Recognizer2D.average_clip
    calibrate = Recognizer2D.calibrate

    def extract_feat(self, imgs: torch.Tensor):
        """(N, T, H, W, C) channels-last -> the backbone's NCTHW maps."""
        return self.backbone(to_ncthw(imgs.to(self.compute_dtype)))

    def forward(self, imgs: torch.Tensor, labels=None,
                return_loss: bool = True,
                generator: Optional[torch.Generator] = None):
        if return_loss:
            return self.forward_train(imgs, labels, generator)
        return self.forward_test(imgs)

    def forward_train(self, imgs: torch.Tensor, labels: torch.Tensor,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
        imgs = imgs.reshape((-1,) + tuple(imgs.shape[2:]))
        cls_score = self.cls_head(self.extract_feat(imgs),
                                  generator=generator)
        return self.cls_head.loss(cls_score, labels.reshape(-1))

    def forward_test(self, imgs: torch.Tensor) -> torch.Tensor:
        num_batch = imgs.shape[0]
        imgs = imgs.reshape((-1,) + tuple(imgs.shape[2:]))
        chunk = (self.test_cfg or {}).get('view_chunk')
        n = imgs.shape[0]
        if chunk and n > chunk and n % chunk:
            logger.warning('test_cfg.view_chunk=%d ignored: %d views not '
                           'divisible', chunk, n)
        if chunk and n > chunk and n % chunk == 0:
            cls_score = torch.cat([self.cls_head(self.extract_feat(part))
                                   for part in imgs.split(chunk)])
        else:
            cls_score = self.cls_head(self.extract_feat(imgs))
        return self.average_clip(cls_score, num_batch)

    def forward_extract_feat(self, imgs: torch.Tensor) -> torch.Tensor:
        """(B*clips, C): each clip's pooled features."""
        imgs = imgs.reshape((-1,) + tuple(imgs.shape[2:]))
        return pooled_features(self.extract_feat(imgs))


@RECOGNIZERS.register_module
class RecognizerC2D(Recognizer3D):
    """``Recognizer3D`` with a ``modality`` field, the JAX package's
    ``RecognizerC2D``: the same clip-volume forward, the field stored and
    otherwise unused, as there (the reference's tsm_c2d surgery imports a
    module it never ships)."""

    def __init__(self, backbone: Dict, cls_head: Dict, modality: str = 'RGB',
                 **kwargs):
        super().__init__(backbone, cls_head, **kwargs)
        self.modality = modality
