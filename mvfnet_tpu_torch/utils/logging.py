"""Root logger with INFO on rank 0 only (counterpart of
``mvfnet_tpu/utils/logging.py``).

Mirrors the reference's logger (``codes/utils/logger.py:9-19``): processes
of another rank are silenced to ERROR. The rank is that of an initialized
``torch.distributed`` process group, else 0.
"""

from __future__ import annotations

import logging
from typing import Optional

_LOGGER_NAME = 'mvfnet_tpu_torch'


def _rank() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def get_root_logger(log_level: str = 'INFO',
                    log_file: Optional[str] = None) -> logging.Logger:
    """The package's logger, set up on the first call; later calls return
    it unchanged."""
    logger = logging.getLogger(_LOGGER_NAME)
    if logger.handlers:
        return logger
    level = getattr(logging, log_level) if isinstance(log_level, str) \
        else log_level
    fmt = logging.Formatter(
        '%(asctime)s - %(name)s - %(levelname)s - %(message)s')
    handler = logging.StreamHandler()
    handler.setFormatter(fmt)
    logger.addHandler(handler)
    rank = _rank()
    if log_file is not None and rank == 0:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.setLevel(logging.ERROR if rank != 0 else level)
    logger.propagate = False
    return logger
