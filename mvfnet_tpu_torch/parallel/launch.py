"""Local ranks without an outside launcher: what the train CLI's ``--gpus N``
and the tests start (torchrun and SLURM start their own)."""

from __future__ import annotations

import os
import socket
import time
from typing import Callable, Sequence

import torch.multiprocessing as mp


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, args: Sequence, world: int,
               port: int) -> None:
    os.environ.update(MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    fn(*args)


# seconds the other ranks get to end by themselves after one fails
_GRACE = 5.0


def spawn_local(fn: Callable, nprocs: int, args: Sequence = (),
                timeout: float = 900.0) -> None:
    """Run ``fn(*args)`` in ``nprocs`` new processes (``spawn``), each with
    torchrun's variables for its rank (``MASTER_ADDR`` 127.0.0.1 and a free
    port, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), so that ``fn`` joins
    with ``init_distributed('env')``. ``fn`` must be importable by name;
    results come back through files.

    Waits at most ``timeout`` seconds. When a rank fails, the others get a
    few seconds, then SIGTERM, then SIGKILL, and only then does this
    raise with the failed rank's traceback
    (``torch.multiprocessing.ProcessRaisedException``); past the deadline
    every rank is killed and ``TimeoutError`` raised.
    """
    ctx = mp.start_processes(_rank_main,
                             args=(fn, tuple(args), nprocs, free_port()),
                             nprocs=nprocs, join=False,
                             start_method='spawn')
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=min(1.0, max(deadline - time.monotonic(),
                                                0.01)),
                           grace_period=_GRACE):
            if time.monotonic() > deadline:
                raise TimeoutError(f'{nprocs} local ranks still running '
                                   f'after {timeout} s')
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
