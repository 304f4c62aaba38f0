from .builder import (BACKBONES, HEADS, RECOGNIZERS, SEGMENTAL_CONSENSUSES,
                      build_backbone, build_head, build_recognizer)
from .backbones import resnet  # noqa: F401 (registry population)
from .backbones import resnet_i3d, resnet_i3d_slowfast  # noqa: F401
from .backbones import resnet_x3d  # noqa: F401
from .backbones import bninception, mobilenet_v2  # noqa: F401
from .backbones import inception_v1_i3d, resnet_r3d  # noqa: F401
from .heads import i3d_head, tsn_head  # noqa: F401
from .recognizers import recognizer2d, recognizer3d  # noqa: F401

__all__ = ['RECOGNIZERS', 'BACKBONES', 'HEADS', 'SEGMENTAL_CONSENSUSES',
           'build_backbone', 'build_head', 'build_recognizer']
