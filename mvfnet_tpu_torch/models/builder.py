"""Model registries and build functions (counterpart of
``mvfnet_tpu/models/builder.py``). Entries are ``torch.nn.Module`` classes;
``build_*`` returns constructed modules."""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..registry import Registry, build_from_cfg

RECOGNIZERS = Registry('recognizer')
BACKBONES = Registry('backbone')
HEADS = Registry('head')
SEGMENTAL_CONSENSUSES = Registry('segmental_consensus')


def build_backbone(cfg: Dict[str, Any]):
    return build_from_cfg(cfg, BACKBONES)


def build_head(cfg: Dict[str, Any]):
    return build_from_cfg(cfg, HEADS)


def model_name(cfg: Dict[str, Any]) -> str:
    """A model config's recognizer, backbone and head types, as the CLIs
    log them: ``'Recognizer3D(ResNet_I3D, I3DClsHead)'``."""
    parts = [str((cfg.get(k) or {}).get('type'))
             for k in ('backbone', 'cls_head')]
    return f'{cfg.get("type")}({", ".join(parts)})'


def build_recognizer(cfg: Dict[str, Any],
                     train_cfg: Optional[Dict] = None,
                     test_cfg: Optional[Dict] = None):
    return build_from_cfg(
        cfg, RECOGNIZERS,
        default_args=dict(train_cfg=train_cfg, test_cfg=test_cfg))
