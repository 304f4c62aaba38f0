from .builder import (BACKBONES, HEADS, RECOGNIZERS, SEGMENTAL_CONSENSUSES,
                      build_backbone, build_head, build_recognizer)
from .backbones import resnet  # noqa: F401 (registry population)
from .heads import tsn_head  # noqa: F401
from .recognizers import recognizer2d  # noqa: F401

__all__ = ['RECOGNIZERS', 'BACKBONES', 'HEADS', 'SEGMENTAL_CONSENSUSES',
           'build_backbone', 'build_head', 'build_recognizer']
