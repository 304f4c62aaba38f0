"""mvfnet_tpu_torch — the PyTorch/CUDA port of mvfnet_tpu.

A second package beside the JAX one: the same models and entry points on
torch tensors, with the JAX package's Pallas kernels rewritten by hand for
NVIDIA Hopper under ``csrc/``. Importing it builds no kernel and imports
neither ``triton`` nor anything of JAX.
"""

__version__ = '0.1.0'

from .config import Config, ConfigDict
from .registry import Registry, build_from_cfg

__all__ = ['Config', 'ConfigDict', 'Registry', 'build_from_cfg',
           '__version__']
