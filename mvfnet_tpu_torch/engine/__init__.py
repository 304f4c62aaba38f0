"""Training and evaluation of the port: the optimizer and LR schedule, the
train and eval steps, the train loop with its hooks, dataset evaluation and
the host-to-device prefetch."""

from .optim import build_lr_schedule, build_optimizer
from .train_step import TrainState, make_eval_step, make_train_step
from .train_loop import (CheckpointHook, EvalHook, Hook, TensorboardLoggerHook,
                         TextLoggerHook, TrainLoop, train_network)
from .eval import evaluate_dataset
from .prefetch import prefetch_to_device

__all__ = ['build_lr_schedule', 'build_optimizer', 'TrainState',
           'make_train_step', 'make_eval_step', 'TrainLoop', 'train_network',
           'Hook', 'TextLoggerHook', 'TensorboardLoggerHook', 'CheckpointHook',
           'EvalHook', 'evaluate_dataset', 'prefetch_to_device']
