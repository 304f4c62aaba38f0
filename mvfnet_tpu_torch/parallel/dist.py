"""Processes, their rendezvous and their collectives (counterpart of
``mvfnet_tpu/parallel/mesh.py:32-69``).

The JAX package lays one mesh over every chip and lets XLA place the
collectives; here each process drives one device and talks to the others
through ``torch.distributed``: NCCL between CUDA devices, gloo on the CPU.
``init_distributed`` reads the launcher's environment (torchrun's variables,
or SLURM's as the reference's ``dist_utils.py:70-113`` maps them), picks the
rank's device and the backend, and joins the group; the rest are the few
collectives the engine needs.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
from datetime import timedelta
from typing import Any, Dict, Mapping, Optional, Union

import torch
import torch.distributed as dist

# MASTER_PORT under SLURM when the environment names none: torchrun's
# default
DEFAULT_MASTER_PORT = 29500
_LAUNCHERS = ('none', 'env', 'slurm')
_NO_CUDA = ("CUDA is not available; the port runs on the GPU unless the "
            "caller passes device='cpu'")


def _need(environ: Mapping[str, str], name: str, launcher: str) -> str:
    if name not in environ:
        raise KeyError(f'launcher {launcher!r}: {name} is not set')
    return environ[name]


def _first_host(nodelist: str) -> str:
    out = subprocess.run(['scontrol', 'show', 'hostnames', nodelist],
                         capture_output=True, text=True, check=True,
                         timeout=60)
    hosts = out.stdout.split()
    if not hosts:
        raise RuntimeError(f'scontrol gave no host for {nodelist!r}')
    return hosts[0]


def dist_env(launcher: Optional[str],
             environ: Mapping[str, str]) -> Optional[Dict[str, Any]]:
    """This process's rendezvous from ``environ``: ``master_addr``,
    ``master_port``, ``world_size``, ``rank`` and ``local_rank``; None when
    the process runs alone.

    ``'env'`` reads torchrun's ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``. ``'slurm'`` reads
    ``SLURM_PROCID``, ``SLURM_NTASKS`` and ``SLURM_LOCALID``, with
    ``MASTER_ADDR`` from the environment or else the first host of
    ``scontrol show hostnames $SLURM_NODELIST``, and ``MASTER_PORT`` from
    the environment or ``DEFAULT_MASTER_PORT``. ``None`` takes whichever
    of the two says more than one process, as the JAX ``init_distributed``
    does, and ``'none'`` never a group (the CLIs' default).
    """
    if launcher is not None and launcher not in _LAUNCHERS:
        raise ValueError(f'launcher {launcher!r}: expected one of '
                         f'{_LAUNCHERS} or None')
    if launcher == 'none':
        return None
    if launcher is None:
        if int(environ.get('SLURM_NTASKS', '1')) > 1 \
                and 'SLURM_PROCID' in environ:
            launcher = 'slurm'
        elif int(environ.get('WORLD_SIZE', '1')) > 1:
            launcher = 'env'
        else:
            return None
    if launcher == 'slurm':
        world = int(_need(environ, 'SLURM_NTASKS', launcher))
        rank = int(_need(environ, 'SLURM_PROCID', launcher))
        local_rank = int(_need(environ, 'SLURM_LOCALID', launcher))
        addr = environ.get('MASTER_ADDR') or _first_host(
            _need(environ, 'SLURM_NODELIST', launcher))
        port = int(environ.get('MASTER_PORT', DEFAULT_MASTER_PORT))
    else:
        addr = _need(environ, 'MASTER_ADDR', launcher)
        port = int(_need(environ, 'MASTER_PORT', launcher))
        world = int(_need(environ, 'WORLD_SIZE', launcher))
        rank = int(_need(environ, 'RANK', launcher))
        local_rank = int(_need(environ, 'LOCAL_RANK', launcher))
    if not (0 <= rank < world and 0 <= local_rank):
        raise ValueError(f'launcher {launcher!r}: rank {rank}, local rank '
                         f'{local_rank} of world {world}')
    return dict(master_addr=addr, master_port=port, world_size=world,
                rank=rank, local_rank=local_rank)


def _rank_device(device: torch.device, local_rank: int) -> torch.device:
    """``device``; a CUDA device without an index is ``cuda:local_rank``,
    which must exist. It becomes the current CUDA device."""
    if device.type != 'cuda':
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(_NO_CUDA)
    if device.index is None:
        count = torch.cuda.device_count()
        if local_rank >= count:
            raise RuntimeError(f'local rank {local_rank} needs cuda:'
                               f'{local_rank}, but {count} CUDA devices are '
                               'visible')
        device = torch.device('cuda', local_rank)
    torch.cuda.set_device(device)
    return device


def init_distributed(launcher: Optional[str] = None,
                     backend: Optional[str] = None,
                     timeout: Optional[timedelta] = None,
                     device: Union[None, str, torch.device] = None
                     ) -> torch.device:
    """Join the process group that ``launcher``'s environment describes
    (``dist_env``) and return this rank's device.

    ``device`` is CUDA unless the caller names another; a CUDA device
    without an index is ``cuda:LOCAL_RANK`` (raising when that card is not
    visible) and one with an index wins, which is how two ranks share one
    card; a process alone keeps ``device`` as given. The backend is NCCL for a CUDA device and gloo for the CPU unless
    ``backend`` names one; nothing falls back from one to the other. With
    no group to join it returns the device; with a group already joined,
    the device and nothing else. The rendezvous is written to this
    process's ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``
    and ``LOCAL_RANK``, as the reference's SLURM path does.
    """
    device = torch.device(device if device is not None else 'cuda')
    if dist.is_initialized():
        return _rank_device(device, get_dist_info()['local_rank'])
    env = dist_env(launcher, os.environ)
    if env is None:
        if device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError(_NO_CUDA)
        return device
    device = _rank_device(device, env['local_rank'])
    os.environ.update(MASTER_ADDR=env['master_addr'],
                      MASTER_PORT=str(env['master_port']),
                      WORLD_SIZE=str(env['world_size']),
                      RANK=str(env['rank']),
                      LOCAL_RANK=str(env['local_rank']))
    kwargs = {} if timeout is None else dict(timeout=timeout)
    dist.init_process_group(
        backend or ('nccl' if device.type == 'cuda' else 'gloo'),
        init_method=f"tcp://{env['master_addr']}:{env['master_port']}",
        world_size=env['world_size'], rank=env['rank'], **kwargs)
    return device


@contextlib.contextmanager
def process_group(launcher: Optional[str],
                  device: Union[None, str, torch.device] = None,
                  backend: Optional[str] = None,
                  timeout: Optional[timedelta] = None):
    """``init_distributed`` for the body of a ``with``, yielding the rank's
    device; the group it joined is destroyed at the end (one that was
    already joined is left as it was)."""
    joined = not dist.is_initialized()
    device = init_distributed(launcher, backend, timeout, device)
    try:
        yield device
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()


def world_rank():
    """``(world_size, rank)`` of the joined group, ``(1, 0)`` without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def get_dist_info() -> Dict[str, int]:
    """The JAX ``get_dist_info`` keys (``rank``, ``world_size``,
    ``local_device_count``, ``global_device_count``: one device a process)
    and ``local_rank``."""
    world, rank = world_rank()
    local_rank = int(os.environ.get('LOCAL_RANK', '0')) if world > 1 else 0
    return dict(rank=rank, world_size=world, local_rank=local_rank,
                local_device_count=1, global_device_count=world)


def is_main_process() -> bool:
    return world_rank()[1] == 0


def barrier() -> None:
    """Wait for every rank; nothing without a group of more than one."""
    if world_rank()[0] > 1:
        if dist.get_backend() == 'nccl':
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """``t`` averaged over the ranks, in place; ``t`` at world 1."""
    world = world_rank()[0]
    if world > 1:
        dist.all_reduce(t)
        t /= world
    return t


_MAX_DIMS = 8


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 in rank order, on the
    backend's device (the current CUDA device for NCCL, the CPU for gloo,
    which gathers no CUDA tensors). Raises when the ranks' shapes differ."""
    world = world_rank()[0]
    if world == 1:
        return t
    dev = (torch.device('cuda', torch.cuda.current_device())
           if dist.get_backend() == 'nccl' else torch.device('cpu'))
    x = t.detach().to(dev).contiguous()
    if x.dim() > _MAX_DIMS:
        raise ValueError(f'all_gather_rows: {x.dim()}-D tensor')
    shape = torch.tensor([x.dim()] + list(x.shape)
                         + [0] * (_MAX_DIMS - x.dim()), device=dev)
    shapes = [torch.empty_like(shape) for _ in range(world)]
    dist.all_gather(shapes, shape)
    if any(not torch.equal(s, shape) for s in shapes):
        raise ValueError('all_gather_rows: the ranks hold different shapes '
                         f'{[s.tolist() for s in shapes]}')
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x)
    return torch.cat(parts)
