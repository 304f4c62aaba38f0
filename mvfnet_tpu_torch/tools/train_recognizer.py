"""Train CLI of the port (counterpart of the root ``train_recognizer.py``).

    python -m mvfnet_tpu_torch.tools.train_recognizer CONFIG \\
        [--work_dir DIR] [--resume_from CKPT] [--validate] \\
        [--seed N] [--bf16] [--autoscale-lr] [--profile N] \\
        [--launcher none|env|slurm] [--gpus N] [--device cuda|cpu] \
        [--trace spans.json]

Builds the config's recognizer in its ``compute_dtype`` (bf16 with
``--bf16``; parameters stay float32) and its train dataset, and runs
``engine.train_loop.train_network``: ``epoch_N.pth`` and ``latest.pth``
checkpoints and ``train.log`` go to the work directory (``--resume_from``
also takes the JAX package's ``.msgpack`` ones), and ``--validate``
evaluates ``data.val`` every ``eval_interval`` epochs. ``--profile N``
traces iterations 1..N with ``torch.profiler`` into ``WORK_DIR/profile``.

One process trains on one card unless ``--launcher env`` (torchrun) or
``--launcher slurm`` (srun) starts one per card, or ``--gpus N`` spawns N
local ranks on ``cuda:0..N-1``; each rank takes ``videos_per_gpu`` videos
a step and rank 0 writes the files. ``--autoscale-lr`` scales the LR by
world / 8. It runs on CUDA (NCCL between ranks) unless ``--device cpu``
is given (gloo), and raises without CUDA.

``--trace PATH`` turns the port's spans on for the run (``utils.tracing``:
each train step's upload, forward, backward, clip and optimizer, the
loader's waits, each pipeline op, the decode calls) and writes them to
PATH as Chrome trace-event JSON, which Perfetto loads; rank r > 0 writes
``<stem>.rank<r>.json``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Optional, Sequence

# how long the spawned ranks of --gpus may train, in seconds
_SPAWN_TIMEOUT = 7 * 24 * 3600.0


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description='Train an action recognizer')
    parser.add_argument('config', help='config file path')
    parser.add_argument('--work_dir', help='dir to save logs and checkpoints')
    parser.add_argument('--resume_from', help='checkpoint to resume from')
    parser.add_argument('--validate', action='store_true',
                        help='run top-k evaluation during training')
    parser.add_argument('--gpus', type=int, default=None,
                        help='local ranks to spawn, one a card (without '
                             '--launcher)')
    parser.add_argument('--seed', type=int, default=None, help='random seed')
    parser.add_argument('--launcher', default='none',
                        choices=['none', 'env', 'slurm'],
                        help='multi-process launcher: env (torchrun) or '
                             'slurm (srun)')
    parser.add_argument('--autoscale-lr', action='store_true',
                        help='scale lr by ranks / 8')
    parser.add_argument('--bf16', action='store_true', default=None,
                        help='force bfloat16 compute (default: config)')
    parser.add_argument('--profile', type=int, default=0, metavar='N',
                        help='trace iterations 1..N with torch.profiler '
                             'into WORK_DIR/profile')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default; raises without CUDA) or "
                             "'cpu'")
    parser.add_argument('--trace', default=None, metavar='PATH',
                        help="write the port's spans of the run to PATH "
                             '(Chrome trace-event JSON, for Perfetto)')
    return parser.parse_args(argv)


def _profile_hook(n: int, out_dir: str, logger):
    from ..engine.train_loop import Hook

    class ProfileHook(Hook):
        """torch.profiler over the N iterations after the first."""

        def __init__(self):
            self._prof = None

        def after_iter(self, loop, metrics):
            if loop.iter == 1 and self._prof is None:
                from torch.profiler import ProfilerActivity, profile
                activities = [ProfilerActivity.CPU]
                if loop.device.type == 'cuda':
                    activities.append(ProfilerActivity.CUDA)
                self._prof = profile(activities=activities)
                self._prof.__enter__()
            elif loop.iter == 1 + n and self._prof is not None:
                self.after_run(loop)

        def after_run(self, loop):
            if not self._prof:
                return
            self._prof.__exit__(None, None, None)
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, 'trace.json')
            self._prof.export_chrome_trace(path)
            self._prof = False          # done: no second trace
            logger.info('profiler trace written to %s', path)

    return ProfileHook()


def _spawned_rank(argv: Sequence[str]) -> None:
    main(list(argv) + ['--launcher', 'env'])


def main(argv: Optional[Sequence[str]] = None):
    """Train; returns the ``TrainLoop`` after its run (None in the process
    that spawned ``--gpus`` ranks)."""
    args = parse_args(argv)
    if args.launcher == 'none' and args.gpus is not None and args.gpus > 1:
        import torch
        from ..parallel import spawn_local
        if torch.device(args.device).type == 'cuda' \
                and torch.cuda.device_count() < args.gpus:
            raise RuntimeError(f'--gpus {args.gpus}: '
                               f'{torch.cuda.device_count()} CUDA devices '
                               'are visible')
        spawn_local(_spawned_rank, args.gpus, (list(argv or sys.argv[1:]),),
                    timeout=_SPAWN_TIMEOUT)
        return None
    from ..parallel import get_dist_info, process_group
    from ..utils import tracing
    with process_group(args.launcher, args.device) as device, \
            tracing.recording(args.trace, get_dist_info()['rank']):
        return _train(args, device)


def _train(args, device):
    from ..config import Config
    from ..data import build_dataset, dataset_decoder, decode_counts
    from ..engine.train_loop import train_network
    from ..models import build_recognizer
    from ..models.builder import model_name
    from ..parallel import get_dist_info
    from ..utils.logging import get_root_logger

    info = get_dist_info()
    cfg = Config.fromfile(args.config)
    if args.work_dir is not None:
        cfg.work_dir = args.work_dir
    if args.resume_from is not None:
        cfg.resume_from = args.resume_from
    if args.autoscale_lr:
        cfg.optimizer['lr'] = cfg.optimizer['lr'] * info['world_size'] / 8

    os.makedirs(cfg.work_dir, exist_ok=True)
    logger = get_root_logger(cfg.get('log_level', 'INFO'))
    # this run's log file, on rank 0 only, detached at the end so that runs
    # in one process each write their own
    log_file = logging.FileHandler(
        os.path.join(cfg.work_dir, 'train.log')) if info['rank'] == 0 \
        else logging.NullHandler()
    log_file.setFormatter(logging.Formatter(
        '%(asctime)s - %(name)s - %(levelname)s - %(message)s'))
    logger.addHandler(log_file)
    try:
        logger.info('distributed info: %s', info)
        logger.info('config: %s', args.config)
        logger.info('model: %s', model_name(cfg.model))
        dtype = 'bfloat16' if args.bf16 else cfg.get('compute_dtype',
                                                     'float32')
        model = build_recognizer(dict(cfg.model, dtype=dtype),
                                 train_cfg=cfg.get('train_cfg'),
                                 test_cfg=cfg.get('test_cfg'))
        dataset = build_dataset(dict(cfg.data['train']), device)
        if args.seed is not None and hasattr(dataset, 'seed'):
            dataset.seed = args.seed
        logger.info('dataset: %d videos, decoder %s, compute dtype %s, '
                    'device %s', len(dataset), dataset_decoder(dataset),
                    dtype, device)
        extra_hooks = ([_profile_hook(args.profile,
                                      os.path.join(cfg.work_dir, 'profile'),
                                      logger)]
                       if args.profile and info['rank'] == 0 else [])
        loop = train_network(model, dataset, cfg, validate=args.validate,
                             logger=logger, seed=args.seed or 0,
                             device=device, extra_hooks=extra_hooks)
        logger.info('train frames decoded: %s', decode_counts(dataset))
        return loop
    finally:
        logger.removeHandler(log_file)
        log_file.close()


if __name__ == '__main__':
    main()
