"""The multi-process engine of the port (counterpart of
``mvfnet_tpu/parallel``): the launchers' rendezvous, the collectives the
train step and the evaluation need, and local spawning."""

from .dist import (all_gather_rows, all_reduce_mean, barrier, dist_env,
                   get_dist_info, init_distributed, is_main_process,
                   process_group, world_rank)
from .launch import free_port, spawn_local

__all__ = ['all_gather_rows', 'all_reduce_mean', 'barrier', 'dist_env',
           'get_dist_info', 'init_distributed', 'is_main_process',
           'process_group', 'world_rank', 'free_port', 'spawn_local']
